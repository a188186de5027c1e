"""Every collective of the port's parallel layouts goes through this module.

The backend follows from where the tensors live (``choose_backend``): NCCL
when each rank of a host has a card of its own, gloo on the CPU, and gloo
over CUDA tensors when ranks share a card (NCCL refuses two ranks on one
device). The ranks of a host are counted at the rendezvous
(``parallel.mesh.maybe_initialize_distributed``, ``local_ranks``).
gloo reduces and broadcasts CUDA tensors itself; it has no CUDA path for
all-gather, reduce-scatter, send or recv, so for those ops on a CUDA tensor
this module copies the tensor to host memory, runs the op there and copies
the result back (``_staged``). Nothing here falls back silently: the
backend is the process group's own, and ``group_backend`` names it.

Each function is a no-op on a group of one rank, and on ``None``, which here
means no group (a mesh line of one rank; the world is ``dist.group.WORLD``,
which the send / recv pair uses). Collectives
take the tensors' own order: ``all_gather`` concatenates the ranks' pieces
along ``dim`` in group-rank order, ``reduce_scatter`` sums over the group and
keeps this rank's ``1/n`` chunk of ``dim``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

# gloo's ops with a CUDA implementation: the rest are staged through the host
_GLOO_CUDA_OPS = ("all_reduce", "broadcast")


def local_ranks(hosts: List[str], rank: int) -> Tuple[int, int]:
    """``(local rank, local world size)`` of ``rank`` among the world's
    ranks, ``hosts[r]`` the host of rank ``r``: its index among the ranks of
    its host, in rank order, and their number."""
    mine = [r for r, host in enumerate(hosts) if host == hosts[rank]]
    return mine.index(rank), len(mine)


def choose_backend(device: torch.device, local_world_size: int,
                   device_count: Optional[int] = None) -> str:
    """``nccl`` when the ranks sit on CUDA devices and each rank of this
    host has a card of its own (``local_world_size`` ranks on the host's
    ``device_count`` cards), else ``gloo``: on the CPU, or over CUDA tensors
    where ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    if device_count is None:
        device_count = torch.cuda.device_count()
    return "nccl" if device_count >= local_world_size else "gloo"


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_backend(group=None) -> str:
    return str(dist.get_backend(group))


def _staged(op: str, tensor: torch.Tensor, group) -> bool:
    """True where ``op`` on ``tensor`` must go through host memory: gloo has
    no CUDA path for it."""
    return tensor.is_cuda and op not in _GLOO_CUDA_OPS and group_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, in place; returns ``tensor``."""
    if group_size(group) > 1:
        dist.all_reduce(tensor, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, src_group_rank: int, group=None) -> torch.Tensor:
    """``tensor`` of the group's rank ``src_group_rank`` to every rank, in place."""
    if group_size(group) > 1:
        dist.broadcast(tensor, dist.get_global_rank(group, src_group_rank), group=group)
    return tensor


def all_gather(tensor: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's pieces concatenated along ``dim`` (a new tensor)."""
    n = group_size(group)
    if n == 1:
        return tensor
    src = tensor.contiguous()
    staged = _staged("all_gather", src, group)
    if staged:
        src = src.cpu()
    pieces: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(pieces, src, group=group)
    out = torch.cat(pieces, dim=dim)
    return out.to(tensor.device) if staged else out


def reduce_scatter(tensor: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Sum over the group, then this rank's chunk ``i`` of ``n`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return tensor
    if tensor.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not divide over {n} ranks")
    src = tensor
    staged = _staged("reduce_scatter", src, group)
    if staged:
        src = src.cpu()
    chunks = [c.contiguous() for c in src.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(tensor.device) if staged else out


def send(tensor: torch.Tensor, dst: int, tag: int = 0) -> None:
    """Blocking send to global rank ``dst``."""
    src = tensor.contiguous()
    if _staged("send", src, None):
        src = src.cpu()
    dist.send(src, dst, tag=tag)


def recv(like: torch.Tensor, src: int, tag: int = 0) -> torch.Tensor:
    """Blocking receive from global rank ``src`` of a tensor shaped as ``like``."""
    staged = _staged("recv", like, None)
    out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
    dist.recv(out, src, tag=tag)
    return out.to(like.device) if staged else out


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


def new_group(ranks: List[int]) -> Optional[object]:
    """A process group over ``ranks`` (global ranks) with the world's backend.
    Every rank of the world must call it, for every group, in one order."""
    return dist.new_group(ranks=list(ranks), backend=group_backend())
