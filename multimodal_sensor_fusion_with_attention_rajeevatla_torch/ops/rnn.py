"""Grouped LSTM / GRU recurrences: CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/pallas_rnn.py`` (inference: the final
hidden state of G independent recurrences run as one call) and
``ops/pallas_rnn_train.py`` (the same recurrences, differentiable). Layouts
are the reference's: raw inputs ``x [T, G, B, D]``, precomputed input
projections ``x_proj [T, G, B, gates*H]``, weights ``[G, in, gates*H]``,
biases ``[G, gates*H]``, int32 ``lengths [B]`` shared by the groups, result
``[G, B, H]``. Gate order is torch's: LSTM (i, f, g, o), GRU (r, z, n) with the
hidden bias of the candidate gate inside the reset gate,
``n = tanh(x W_in + b_in + r * (h W_hn + b_hn))``. A row's carry freezes at
its length (``keep * new + (1 - keep) * old`` with ``keep = t < length``), so
the result is the state after the row's last valid step and a row of length 0
returns exact zeros.

``lstm_step`` and ``gru_step`` are the one cell update everything here and
``models.encoders.RNNStack`` / ``models.grouped.GroupedRNNEncoder`` share;
``rnn_scan`` loops them over time, and under autograd it is the plain version
of the trainable functions too. Every kernel wrapper launches its kernel for
CUDA tensors (one launch for the whole sequence and every group) or raises,
and takes its ``*_plain`` version for CPU tensors; each counts its launches in
``.launches``:

- inference, ``csrc/rnn.cu``: ``grouped_lstm_forward``, ``grouped_lstm_fused``
  and ``grouped_gru_fused`` (forward only, the result carries no gradient).
  All three run on a thread-block cluster with W_hh held on chip and 3xTF32
  step products (``csrc/rnn_cluster_fused.cuh``; the two fused ones hold
  W_ih too and compute the input projection inside, ``grouped_lstm_forward``
  reads the precomputed one) at the sizes ``grouped_fused_route`` /
  ``grouped_lstm_forward_route`` name, on the SIMT body
  (``csrc/rnn_cell.cuh``) at the others;
- training, ``csrc/rnn_train.cu``: ``lstm_train_fwd`` / ``gru_train_fwd`` (the
  final state plus the per-step residuals: post-activation gates, ``h_{t-1}``,
  and ``c_{t-1}`` or ``hn = h_{t-1} W_hn + b_hn``; zero past each row's
  length) and ``lstm_train_bwd`` / ``gru_train_bwd`` (reverse time -> the
  ``x_proj`` cotangent, exactly zero past each length). Both pairs run on a
  thread-block cluster with 3xTF32 step products (``csrc/rnn_cluster.cuh``)
  at the hidden sizes ``rnn_train_route`` names, on the SIMT body
  (``csrc/rnn_cell.cuh``) at the others.

``grouped_lstm_trainable`` and ``grouped_gru_trainable`` are
``torch.autograd.Function``s over the training pair; their backward takes
``dW_hh`` and ``db_hh`` as one product and one sum over that cotangent, as the
reference's custom VJP does. The reference's TPU tiling (``block_t``, padding
of T and B, ``interpret``) has no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build


def lstm_step(xp, h, c, w_hh, b_hh, keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. ``xp [..., B, 4H]`` is the input projection (with its
    bias), ``h``/``c [..., B, H]``, ``w_hh [..., H, 4H]``, ``b_hh [..., 4H]``;
    ``keep`` (broadcastable to ``h``, 1 = valid) freezes finished rows."""
    z = xp + torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    if keep is not None:
        h_new = keep * h_new + (1 - keep) * h
        c_new = keep * c_new + (1 - keep) * c
    return h_new, c_new


def gru_step(xp, h, w_hh, b_hh, keep=None) -> torch.Tensor:
    """One GRU step, shapes as ``lstm_step`` with 3H gate columns. ``b_hh``
    stays on the hidden path: the reset gate multiplies ``h W_hn + b_hn``."""
    hp = torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h_new = (1 - z) * n + z * h
    if keep is not None:
        h_new = keep * h_new + (1 - keep) * h
    return h_new


def _valid_steps(steps: int, lengths: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """``[T, B, 1]`` bool, ``t < length``; None without lengths."""
    if lengths is None:
        return None
    return (torch.arange(steps, device=device)[:, None]
            < lengths[None, :].to(torch.int32))[..., None]


def rnn_scan(cell, x_proj, w_hh, b_hh, lengths=None, return_outputs: bool = False):
    """The recurrence as a loop over time: ``x_proj [T, ..., B, gates*H]`` ->
    ``(final hidden [..., B, H], per-step hidden [T, ..., B, H] or None)``.
    The leading ``...`` is the group axis or nothing; ``lengths [B]``."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"Unknown cell type: {cell}")
    steps = x_proj.shape[0]
    hidden = w_hh.shape[-2]
    h = x_proj.new_zeros((*x_proj.shape[1:-1], hidden))
    c = torch.zeros_like(h)
    valid = _valid_steps(steps, lengths, x_proj.device)
    if valid is not None:
        valid = valid.to(x_proj.dtype)
    outputs = []
    for t in range(steps):
        keep = valid[t] if valid is not None else None
        if cell == "lstm":
            h, c = lstm_step(x_proj[t], h, c, w_hh, b_hh, keep)
        else:
            h = gru_step(x_proj[t], h, w_hh, b_hh, keep)
        if return_outputs:
            outputs.append(h)
    if not return_outputs:
        return h, None
    return h, (torch.stack(outputs) if outputs else h.new_zeros((0, *h.shape)))


def grouped_lstm_forward_plain(x_proj, w_hh, b_hh, lengths=None) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_lstm_forward``."""
    return rnn_scan("lstm", x_proj, w_hh, b_hh, lengths)[0]


def grouped_lstm_fused_plain(x, w_ih, w_hh, bias, lengths=None) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_lstm_fused`` (``bias`` = b_ih + b_hh)."""
    x_proj = torch.einsum("tgbd,gdh->tgbh", x, w_ih)
    return rnn_scan("lstm", x_proj, w_hh, bias, lengths)[0]


def grouped_gru_fused_plain(x, w_ih, w_hh, b_ih, b_hh, lengths=None) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_gru_fused``."""
    x_proj = torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]
    return rnn_scan("gru", x_proj, w_hh, b_hh, lengths)[0]


def _check(tensors: dict, shapes: dict, lengths: Optional[torch.Tensor], batch: int) -> None:
    """Shapes and devices on any device; dtype and layout where the kernel runs."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, got {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, expected {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if lengths is not None:
        if tuple(lengths.shape) != (batch,):
            raise ValueError(f"lengths must have shape ({batch},), got {tuple(lengths.shape)}")
        if lengths.device != first.device:
            raise ValueError(f"lengths is on {lengths.device}, expected {first.device}")
        if lengths.dtype != torch.int32:
            raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    if first.device.type == "cuda":
        for name, t in tensors.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _kernel_fn(library: str, name: str, args: int, ints: int):
    lib = _build.library(library)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * args + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _run(wrapper, library: str, entry: str, tensors, dims) -> None:
    """Launch ``entry`` of kernel library ``library`` on the tensors' device
    and current stream; raise if it was refused."""
    device = tensors[0].device
    lib, fn = _kernel_fn(library, entry, len(tensors), len(dims))
    with torch.cuda.device(device):
        code = fn(*(t.data_ptr() for t in tensors), *dims,
                  torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1


def _all_steps(lengths: Optional[torch.Tensor], steps: int, batch: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((batch,), steps, dtype=torch.int32, device=device)
    return lengths.contiguous()


def _launch(wrapper, entry: str, tensors, lengths, out, dims) -> torch.Tensor:
    """Launch an inference kernel of ``csrc/rnn.cu``; ``out [G, B, H]``."""
    steps, batch = dims[0], dims[2]
    if batch == 0:
        return out
    _run(wrapper, "rnn", entry, [*tensors, _all_steps(lengths, steps, batch, out.device), out],
         dims)
    return out


# csrc/rnn_cluster_fused.cuh: the widest input whose W_ih slice and x ring one
# CTA of the serving body holds beside its W_hh slice (kFusedMaxD)
CLUSTER_MAX_FEAT = 64
CLUSTER_ROWS = (16, 32)  # batch rows a cluster: one or two m16 tiles a CTA


def grouped_fused_route(hidden: int, feat: int) -> str:
    """The body ``grouped_lstm_fused`` and ``grouped_gru_fused`` run on the
    card at ``hidden`` units and ``feat`` input features: ``"cluster"``
    (``csrc/rnn_cluster_fused.cuh``: W_hh and W_ih slices held in a
    thread-block cluster's shared memory for the whole sequence, the input
    projection computed inside, h exchanged through distributed shared
    memory, 3xTF32 step products) where ``hidden`` is a multiple of 64 up to
    ``CLUSTER_MAX_HIDDEN`` and ``feat`` at most ``CLUSTER_MAX_FEAT``, else
    ``"simt"`` (``csrc/rnn_cell.cuh``). Both are hand-written kernels and
    count in the same ``.launches``; a refused launch raises on either."""
    fits = rnn_train_route(hidden) == "cluster" and 0 < feat <= CLUSTER_MAX_FEAT
    return "cluster" if fits else "simt"


def grouped_lstm_forward_route(hidden: int) -> str:
    """The body ``grouped_lstm_forward`` runs on the card at ``hidden``
    units: ``"cluster"`` (the serving cluster body of ``grouped_lstm_fused``
    with the x part read from the precomputed ``x_proj``: W_hh slices held
    in a thread-block cluster's shared memory for the whole sequence, h
    exchanged through distributed shared memory, 3xTF32 step products) where
    ``hidden`` is a multiple of 64 up to ``CLUSTER_MAX_HIDDEN``, else
    ``"simt"`` (``csrc/rnn_cell.cuh``). Both are hand-written kernels and
    count in the same ``.launches``; a refused launch raises on either."""
    return rnn_train_route(hidden)


_FUSED_INFO_KEYS = ("threads", "smem_bytes", "active_clusters", "clusters_per_launch")
_FUSED_GEOMETRY = {}  # (kind, H, D, B, G, device) -> the cluster geometry
# kind -> the cluster body's C entry; the order is msfa_grouped_fused_cluster_info's kind
_CLUSTER_ENTRIES = {"lstm": "msfa_grouped_lstm_fused", "gru": "msfa_grouped_gru_fused",
                    "lstm_proj": "msfa_grouped_lstm_forward"}


def pick_cluster_rows(tilings: dict) -> int:
    """The rows a cluster that runs a launch in the fewest waves of clusters,
    16 on a tie: ``tilings`` maps rows to ``{"waves": ceil(clusters per
    launch / active clusters)}``, None where the tiling fits no CTA."""
    fitting = [rows for rows in CLUSTER_ROWS if tilings[rows]["waves"] is not None]
    if not fitting:
        raise RuntimeError(f"the cluster body fits no CTA at these sizes: {tilings}")
    return min(fitting, key=lambda rows: tilings[rows]["waves"])


def _cluster_info(kind: str, hidden: int, feat: int, batch: int, groups: int, device) -> dict:
    """``grouped_fused_cluster_info`` of the kernel ``kind`` (a key of
    ``_CLUSTER_ENTRIES``; ``"lstm_proj"``: ``grouped_lstm_forward``, feat 0)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (kind, hidden, feat, batch, groups, index)
    if key not in _FUSED_GEOMETRY:
        lib = _build.library("rnn")
        fn = lib.msfa_grouped_fused_cluster_info
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        raw = (ctypes.c_int * (1 + 4 * len(CLUSTER_ROWS)))()
        with torch.cuda.device(index):
            code = fn(list(_CLUSTER_ENTRIES).index(kind), hidden, feat, batch, groups,
                      ctypes.addressof(raw))
        _build.check(lib, code, "grouped_fused_cluster_info")
        info = {"ctas_per_cluster": raw[0]}
        for i, rows in enumerate(CLUSTER_ROWS):
            tiling = dict(zip(_FUSED_INFO_KEYS, raw[1 + 4 * i:5 + 4 * i]))
            active = tiling["active_clusters"]
            tiling["waves"] = -(-tiling["clusters_per_launch"] // active) if active else None
            info[f"rows{rows}"] = tiling
        info["rows"] = pick_cluster_rows({rows: info[f"rows{rows}"] for rows in CLUSTER_ROWS})
        _FUSED_GEOMETRY[key] = info
    return _FUSED_GEOMETRY[key]


def grouped_fused_cluster_info(cell: str, hidden: int, feat: int, batch: int, groups: int,
                               device=None) -> dict:
    """The serving cluster body's launch of ``grouped_{cell}_fused`` at these
    sizes, read on the card: CTAs per cluster, then for 16 and 32 batch rows
    a cluster (``"rows16"``, ``"rows32"``) the threads per CTA, the dynamic
    shared memory, the clusters that fit on the card at once
    (``cudaOccupancyMaxActiveClusters``), the clusters one launch runs and its
    waves; ``"rows"`` is the tiling the wrappers take (``pick_cluster_rows``)."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"Unknown cell type: {cell}")
    return _cluster_info(cell, hidden, feat, batch, groups, device)


def grouped_lstm_forward_cluster_info(hidden: int, batch: int, groups: int, device=None) -> dict:
    """``grouped_fused_cluster_info`` for ``grouped_lstm_forward``'s cluster
    body (no W_ih slice, no x ring: less shared memory a CTA)."""
    return _cluster_info("lstm_proj", hidden, 0, batch, groups, device)


def _launch_cluster(wrapper, kind: str, route: str, tensors, lengths, out, dims, feat,
                    cluster_rows) -> torch.Tensor:
    """Launch ``wrapper``'s entry (``_CLUSTER_ENTRIES[kind]``) on the body
    ``route`` names: on the cluster body at ``cluster_rows`` rows a cluster
    (None: the tiling ``_cluster_info`` picks), else its ``_simt`` entry.
    ``dims`` are the entry's (T, G, B, [D,] H)."""
    steps, groups, batch, hidden = dims[0], dims[1], dims[2], dims[-1]
    entry = _CLUSTER_ENTRIES[kind]
    if route == "simt":
        if cluster_rows is not None:
            raise ValueError(f"cluster_rows given, but H={hidden}, D={feat} run the SIMT body")
        return _launch(wrapper, entry + "_simt", tensors, lengths, out, dims)
    if batch == 0:
        return out
    if cluster_rows is None:
        cluster_rows = _cluster_info(kind, hidden, feat, batch, groups, out.device)["rows"]
    elif cluster_rows not in CLUSTER_ROWS:
        raise ValueError(f"cluster_rows must be one of {CLUSTER_ROWS}, got {cluster_rows}")
    return _launch(wrapper, entry, tensors, lengths, out, (*dims, cluster_rows))


def grouped_lstm_forward(
    x_proj: torch.Tensor,  # [T, G, B, 4H] input projections (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 4H]
    b_hh: torch.Tensor,  # [G, 4H]
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
    cluster_rows: Optional[int] = None,  # 16 or 32 on the cluster body; None = picked
) -> torch.Tensor:
    """Grouped LSTM recurrence over precomputed input projections -> final
    hidden ``[G, B, H]``, on the card on the body
    ``grouped_lstm_forward_route(H)`` names. ``grouped_lstm_forward.launches``
    counts launches."""
    if x_proj.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"expected x_proj [T, G, B, 4H] and w_hh [G, H, 4H], got "
                         f"{tuple(x_proj.shape)} and {tuple(w_hh.shape)}")
    steps, groups, batch, _ = x_proj.shape
    hidden = w_hh.shape[1]
    tensors = {"x_proj": x_proj, "w_hh": w_hh, "b_hh": b_hh}
    _check(tensors, {"x_proj": (steps, groups, batch, 4 * hidden),
                     "w_hh": (groups, hidden, 4 * hidden), "b_hh": (groups, 4 * hidden)},
           lengths, batch)
    if x_proj.device.type == "cpu":
        return grouped_lstm_forward_plain(x_proj, w_hh, b_hh, lengths)
    out = torch.empty((groups, batch, hidden), device=x_proj.device, dtype=torch.float32)
    return _launch_cluster(grouped_lstm_forward, "lstm_proj", grouped_lstm_forward_route(hidden),
                           list(tensors.values()), lengths, out, (steps, groups, batch, hidden),
                           0, cluster_rows)


grouped_lstm_forward.launches = 0


def grouped_lstm_fused(
    x: torch.Tensor,  # [T, G, B, D] raw inputs (features zero-padded to the group's D)
    w_ih: torch.Tensor,  # [G, D, 4H]
    w_hh: torch.Tensor,  # [G, H, 4H]
    bias: torch.Tensor,  # [G, 4H] b_ih + b_hh
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
    cluster_rows: Optional[int] = None,  # 16 or 32 on the cluster body; None = picked
) -> torch.Tensor:
    """Grouped LSTM with the input projection inside the kernel -> final
    hidden ``[G, B, H]``, on the card on the body ``grouped_fused_route(H, D)``
    names. ``grouped_lstm_fused.launches`` counts launches."""
    if x.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"expected x [T, G, B, D] and w_hh [G, H, 4H], got "
                         f"{tuple(x.shape)} and {tuple(w_hh.shape)}")
    steps, groups, batch, feat = x.shape
    hidden = w_hh.shape[1]
    tensors = {"x": x, "w_ih": w_ih, "w_hh": w_hh, "bias": bias}
    _check(tensors, {"x": (steps, groups, batch, feat), "w_ih": (groups, feat, 4 * hidden),
                     "w_hh": (groups, hidden, 4 * hidden), "bias": (groups, 4 * hidden)},
           lengths, batch)
    if x.device.type == "cpu":
        return grouped_lstm_fused_plain(x, w_ih, w_hh, bias, lengths)
    out = torch.empty((groups, batch, hidden), device=x.device, dtype=torch.float32)
    return _launch_cluster(grouped_lstm_fused, "lstm", grouped_fused_route(hidden, feat),
                           list(tensors.values()), lengths, out,
                           (steps, groups, batch, feat, hidden), feat, cluster_rows)


grouped_lstm_fused.launches = 0


def grouped_gru_fused(
    x: torch.Tensor,  # [T, G, B, D]
    w_ih: torch.Tensor,  # [G, D, 3H]
    w_hh: torch.Tensor,  # [G, H, 3H]
    b_ih: torch.Tensor,  # [G, 3H]
    b_hh: torch.Tensor,  # [G, 3H], kept on the hidden path
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
    cluster_rows: Optional[int] = None,  # 16 or 32 on the cluster body; None = picked
) -> torch.Tensor:
    """Grouped GRU with the input projection inside the kernel -> final
    hidden ``[G, B, H]``, on the body ``grouped_fused_route(H, D)`` names.
    ``grouped_gru_fused.launches`` counts launches."""
    if x.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"expected x [T, G, B, D] and w_hh [G, H, 3H], got "
                         f"{tuple(x.shape)} and {tuple(w_hh.shape)}")
    steps, groups, batch, feat = x.shape
    hidden = w_hh.shape[1]
    tensors = {"x": x, "w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
    _check(tensors, {"x": (steps, groups, batch, feat), "w_ih": (groups, feat, 3 * hidden),
                     "w_hh": (groups, hidden, 3 * hidden), "b_ih": (groups, 3 * hidden),
                     "b_hh": (groups, 3 * hidden)},
           lengths, batch)
    if x.device.type == "cpu":
        return grouped_gru_fused_plain(x, w_ih, w_hh, b_ih, b_hh, lengths)
    out = torch.empty((groups, batch, hidden), device=x.device, dtype=torch.float32)
    return _launch_cluster(grouped_gru_fused, "gru", grouped_fused_route(hidden, feat),
                           list(tensors.values()), lengths, out,
                           (steps, groups, batch, feat, hidden), feat, cluster_rows)


grouped_gru_fused.launches = 0


# ---- training: forward with residuals, reverse-time backward -----------------


def _stack(items, like: torch.Tensor, cols: int) -> torch.Tensor:
    """``[T, G, B, cols]`` from T per-step tensors (T may be 0)."""
    return torch.stack(items) if items else like.new_zeros((0, *like.shape[1:-1], cols))


def lstm_train_fwd_plain(x_proj, w_hh, b_hh, lengths=None):
    """Plain PyTorch version of ``lstm_train_fwd``: ``rnn_scan``'s loop
    keeping what the backward reads -> ``(h_T, gates, hprev, cprev)``."""
    steps, hidden = x_proj.shape[0], w_hh.shape[-2]
    valid = _valid_steps(steps, lengths, x_proj.device)
    h = x_proj.new_zeros((*x_proj.shape[1:-1], hidden))
    c = torch.zeros_like(h)
    gates, hprev, cprev = [], [], []
    for t in range(steps):
        z = x_proj[t] + torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
        i, f, g, o = z.chunk(4, dim=-1)
        act = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], -1)
        i, f, g, o = act.chunk(4, dim=-1)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if valid is not None:  # residuals past the length are zero, the carry frozen
            act, h_in, c_in = (torch.where(valid[t], v, 0.0) for v in (act, h, c))
            h_new, c_new = torch.where(valid[t], h_new, h), torch.where(valid[t], c_new, c)
        else:
            h_in, c_in = h, c
        gates.append(act)
        hprev.append(h_in)
        cprev.append(c_in)
        h, c = h_new, c_new
    return (h, _stack(gates, x_proj, 4 * hidden), _stack(hprev, x_proj, hidden),
            _stack(cprev, x_proj, hidden))


def lstm_train_bwd_plain(gates, hprev, cprev, w_hh, lengths, dh_out) -> torch.Tensor:
    """Plain PyTorch version of ``lstm_train_bwd`` (the reference's
    ``_bwd_kernel``): reverse time from ``dh_out [G, B, H]``, c_t recomputed
    from the residuals, each cotangent split into the updated lane and the
    frozen lane -> ``dz [T, G, B, 4H]``, zero past each length. ``hprev`` is
    not read (the kernel takes it to match the reference's signature)."""
    del hprev
    steps = gates.shape[0]
    valid = _valid_steps(steps, lengths, gates.device)
    dh, dc = dh_out, torch.zeros_like(dh_out)
    w_t = w_hh.transpose(-1, -2)
    dz = []
    for t in reversed(range(steps)):
        keep = valid[t].to(gates.dtype) if valid is not None else 1.0
        i, f, g, o = gates[t].chunk(4, dim=-1)
        c_prev = cprev[t]
        tanh_c = torch.tanh(f * c_prev + i * g)
        dh_t, dh_skip, dc_t, dc_skip = keep * dh, (1 - keep) * dh, keep * dc, (1 - keep) * dc
        do = dh_t * tanh_c
        dc_t = dc_t + dh_t * o * (1 - tanh_c * tanh_c)
        step = torch.cat([dc_t * g * i * (1 - i), dc_t * c_prev * f * (1 - f),
                          dc_t * i * (1 - g * g), do * o * (1 - o)], -1)
        dz.append(step)
        dh = torch.matmul(step, w_t) + dh_skip
        dc = dc_t * f + dc_skip
    return _stack(dz[::-1], gates, gates.shape[-1])


def gru_train_fwd_plain(x_proj, w_hh, b_hh, lengths=None):
    """Plain PyTorch version of ``gru_train_fwd`` -> ``(h_T, gates (r, z, n),
    hprev, hn)`` with ``hn = h_{t-1} W_hn + b_hn``."""
    steps, hidden = x_proj.shape[0], w_hh.shape[-2]
    valid = _valid_steps(steps, lengths, x_proj.device)
    h = x_proj.new_zeros((*x_proj.shape[1:-1], hidden))
    gates, hprev, hns = [], [], []
    for t in range(steps):
        hp = torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
        xr, xz, xn = x_proj[t].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h
        act = torch.cat([r, z, n], -1)
        if valid is not None:
            act, h_in, hn = (torch.where(valid[t], v, 0.0) for v in (act, h, hn))
            h_new = torch.where(valid[t], h_new, h)
        else:
            h_in = h
        gates.append(act)
        hprev.append(h_in)
        hns.append(hn)
        h = h_new
    return (h, _stack(gates, x_proj, 3 * hidden), _stack(hprev, x_proj, hidden),
            _stack(hns, x_proj, hidden))


def gru_train_bwd_plain(gates, hprev, hn, w_hh, lengths, dh_out) -> torch.Tensor:
    """Plain PyTorch version of ``gru_train_bwd`` (the reference's
    ``_gru_bwd_kernel``) -> the ``x_proj`` cotangent ``(dr_pre, dz_pre,
    dn_pre) [T, G, B, 3H]``; the hidden path carries ``dn_pre * r`` in the
    candidate slot."""
    steps = gates.shape[0]
    valid = _valid_steps(steps, lengths, gates.device)
    dh = dh_out
    w_t = w_hh.transpose(-1, -2)
    dx = []
    for t in reversed(range(steps)):
        keep = valid[t].to(gates.dtype) if valid is not None else 1.0
        r, z, n = gates[t].chunk(3, dim=-1)
        dh_t, dh_skip = keep * dh, (1 - keep) * dh
        dn_pre = dh_t * (1 - z) * (1 - n * n)
        dr_pre = dn_pre * hn[t] * r * (1 - r)
        dz_pre = dh_t * (hprev[t] - n) * z * (1 - z)
        dx.append(torch.cat([dr_pre, dz_pre, dn_pre], -1))
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], -1)
        dh = dh_t * z + torch.matmul(dhp, w_t) + dh_skip
    return _stack(dx[::-1], gates, gates.shape[-1])


def _train_dims(x, w_hh, gates: int, name: str):
    if x.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"expected {name} [T, G, B, {gates}H] and w_hh [G, H, {gates}H], got "
                         f"{tuple(x.shape)} and {tuple(w_hh.shape)}")
    steps, groups, batch, _ = x.shape
    return steps, groups, batch, w_hh.shape[1]


# csrc/rnn_cluster.cuh: the largest hidden size whose W_hh slice, h and
# exchange buffers one CTA of a cluster of 8 holds in shared memory
CLUSTER_MAX_HIDDEN = 256


def rnn_train_route(hidden: int) -> str:
    """The body the training kernels of either cell (``lstm_train_fwd`` /
    ``_bwd``, ``gru_train_fwd`` / ``_bwd``) run on the card at ``hidden``
    units: ``"cluster"`` (``csrc/rnn_cluster.cuh``: W_hh held in a
    thread-block cluster's shared memory for the whole sequence, h and dh
    exchanged through distributed shared memory, 3xTF32 step products) where
    ``hidden`` is a multiple of 64 up to ``CLUSTER_MAX_HIDDEN``, else
    ``"simt"`` (``csrc/rnn_cell.cuh``). Both are hand-written kernels and
    count in the same ``.launches``; a refused launch raises on either."""
    return "cluster" if hidden % 64 == 0 and 0 < hidden <= CLUSTER_MAX_HIDDEN else "simt"


_CLUSTER_INFO_KEYS = ("ctas_per_cluster", "tile_rows", "threads", "smem_fwd_bytes",
                      "smem_bwd_bytes", "active_clusters_fwd", "active_clusters_bwd",
                      "clusters_per_launch")


def rnn_train_cluster_info(cell: str, hidden: int, batch: int, groups: int) -> dict:
    """The ``cell`` training pair's cluster body at these sizes, read on the
    card: CTAs per cluster, batch rows per cluster, threads per CTA, each
    direction's dynamic shared memory, the clusters of each that fit on the
    card at once (``cudaOccupancyMaxActiveClusters``) and the clusters one
    launch runs."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"Unknown cell type: {cell}")
    lib = _build.library("rnn_train")
    fn = lib.msfa_rnn_train_cluster_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(_CLUSTER_INFO_KEYS))()
    code = fn(int(cell == "gru"), hidden, batch, groups, ctypes.addressof(info))
    _build.check(lib, code, "rnn_train_cluster_info")
    return dict(zip(_CLUSTER_INFO_KEYS, info))


def _train_fwd(wrapper, entry, gates, x_proj, w_hh, b_hh, lengths):
    steps, groups, batch, hidden = _train_dims(x_proj, w_hh, gates, "x_proj")
    _check({"x_proj": x_proj, "w_hh": w_hh, "b_hh": b_hh},
           {"x_proj": (steps, groups, batch, gates * hidden),
            "w_hh": (groups, hidden, gates * hidden), "b_hh": (groups, gates * hidden)},
           lengths, batch)
    if x_proj.device.type == "cpu":
        plain = lstm_train_fwd_plain if gates == 4 else gru_train_fwd_plain
        return plain(x_proj, w_hh, b_hh, lengths)
    if rnn_train_route(hidden) == "simt":
        entry += "_simt"
    device = x_proj.device
    out = torch.empty((groups, batch, hidden), device=device, dtype=torch.float32)
    # zero-filled: the kernel stores the residuals at valid steps only
    res = [torch.zeros((steps, groups, batch, cols), device=device, dtype=torch.float32)
           for cols in (gates * hidden, hidden, hidden)]
    if batch > 0:
        _run(wrapper, "rnn_train", entry,
             [x_proj, w_hh, b_hh, _all_steps(lengths, steps, batch, device), out, *res],
             (steps, groups, batch, hidden))
    return (out, *res)


def _train_bwd(wrapper, entry, gates, res, w_hh, lengths, dh_out):
    g_res, hprev, aux = res
    steps, groups, batch, hidden = _train_dims(g_res, w_hh, gates, "gates")
    aux_name = "cprev" if gates == 4 else "hn"
    _check({"gates": g_res, "hprev": hprev, aux_name: aux, "w_hh": w_hh, "dh_out": dh_out},
           {"gates": (steps, groups, batch, gates * hidden),
            "hprev": (steps, groups, batch, hidden), aux_name: (steps, groups, batch, hidden),
            "w_hh": (groups, hidden, gates * hidden), "dh_out": (groups, batch, hidden)},
           lengths, batch)
    if g_res.device.type == "cpu":
        plain = lstm_train_bwd_plain if gates == 4 else gru_train_bwd_plain
        return plain(g_res, hprev, aux, w_hh, lengths, dh_out)
    device = g_res.device
    if rnn_train_route(hidden) == "cluster":
        weights = w_hh  # each CTA reads its slice of W_hh as the forward does
    else:
        # [G, gates*H, H]: the SIMT reduction then reads unit-consecutive words
        weights = w_hh.transpose(1, 2).contiguous()
        entry += "_simt"
    dx = torch.zeros_like(g_res)  # the kernel writes valid steps only
    if batch > 0:
        inputs = [g_res, aux] if gates == 4 else [g_res, hprev, aux]
        _run(wrapper, "rnn_train", entry,
             [*inputs, weights, _all_steps(lengths, steps, batch, device), dh_out, dx],
             (steps, groups, batch, hidden))
    return dx


def lstm_train_fwd(
    x_proj: torch.Tensor,  # [T, G, B, 4H] input projections (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 4H]
    b_hh: torch.Tensor,  # [G, 4H]
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
):
    """Grouped LSTM forward for training -> ``(h_T [G, B, H], gates
    [T, G, B, 4H] (i, f, g, o after their activations), hprev, cprev
    [T, G, B, H])``, residuals zero past each length. On the card it runs the
    body ``rnn_train_route(H)`` names. ``lstm_train_fwd.launches`` counts
    launches."""
    return _train_fwd(lstm_train_fwd, "msfa_lstm_train_fwd", 4, x_proj, w_hh, b_hh, lengths)


lstm_train_fwd.launches = 0


def lstm_train_bwd(gates, hprev, cprev, w_hh, lengths, dh_out) -> torch.Tensor:
    """Grouped LSTM backward over ``lstm_train_fwd``'s residuals and the
    cotangent of ``h_T`` ``dh_out [G, B, H]`` -> ``dz [T, G, B, 4H]``, the
    ``x_proj`` cotangent, on the body ``rnn_train_route(H)`` names.
    ``lstm_train_bwd.launches`` counts launches."""
    return _train_bwd(lstm_train_bwd, "msfa_lstm_train_bwd", 4, (gates, hprev, cprev), w_hh,
                      lengths, dh_out)


lstm_train_bwd.launches = 0


def gru_train_fwd(
    x_proj: torch.Tensor,  # [T, G, B, 3H] input projections (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 3H]
    b_hh: torch.Tensor,  # [G, 3H], kept on the hidden path
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
):
    """Grouped GRU forward for training -> ``(h_T, gates [T, G, B, 3H]
    (r, z, n), hprev, hn [T, G, B, H])``, residuals zero past each length,
    on the body ``rnn_train_route(H)`` names. ``gru_train_fwd.launches``
    counts launches."""
    return _train_fwd(gru_train_fwd, "msfa_gru_train_fwd", 3, x_proj, w_hh, b_hh, lengths)


gru_train_fwd.launches = 0


def gru_train_bwd(gates, hprev, hn, w_hh, lengths, dh_out) -> torch.Tensor:
    """Grouped GRU backward -> the ``x_proj`` cotangent ``dx [T, G, B, 3H]``,
    on the body ``rnn_train_route(H)`` names. ``gru_train_bwd.launches``
    counts launches."""
    return _train_bwd(gru_train_bwd, "msfa_gru_train_bwd", 3, (gates, hprev, hn), w_hh,
                      lengths, dh_out)


gru_train_bwd.launches = 0


class _LSTMTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, lengths):
        h_t, gates, hprev, cprev = lstm_train_fwd(x_proj, w_hh, b_hh, lengths)
        ctx.save_for_backward(gates, hprev, cprev, w_hh, lengths)
        return h_t

    @staticmethod
    def backward(ctx, dh_out):
        gates, hprev, cprev, w_hh, lengths = ctx.saved_tensors
        dz = lstm_train_bwd(gates, hprev, cprev, w_hh, lengths, dh_out.contiguous())
        # dz is zero past each length, so every step may enter the sums
        return dz, torch.einsum("tgbh,tgbk->ghk", hprev, dz), dz.sum((0, 2)), None


class _GRUTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, lengths):
        h_t, gates, hprev, hn = gru_train_fwd(x_proj, w_hh, b_hh, lengths)
        ctx.save_for_backward(gates, hprev, hn, w_hh, lengths)
        return h_t

    @staticmethod
    def backward(ctx, dh_out):
        gates, hprev, hn, w_hh, lengths = ctx.saved_tensors
        dx = gru_train_bwd(gates, hprev, hn, w_hh, lengths, dh_out.contiguous())
        # the hidden path's cotangent: the candidate slot carries the reset gate
        hidden = hn.shape[-1]
        dhp = torch.cat([dx[..., :2 * hidden], dx[..., 2 * hidden:] * gates[..., :hidden]], -1)
        return dx, torch.einsum("tgbh,tgbk->ghk", hprev, dhp), dhp.sum((0, 2)), None


def grouped_lstm_trainable(
    x_proj: torch.Tensor,  # [T, G, B, 4H] (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 4H]
    b_hh: torch.Tensor,  # [G, 4H]
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
) -> torch.Tensor:
    """Differentiable grouped LSTM recurrence -> final hidden ``[G, B, H]``,
    with gradients for ``x_proj``, ``w_hh`` and ``b_hh`` (reference
    ``grouped_lstm_trainable``)."""
    return _LSTMTrainable.apply(x_proj, w_hh, b_hh, lengths)


def grouped_gru_trainable(
    x_proj: torch.Tensor,  # [T, G, B, 3H] (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 3H]
    b_hh: torch.Tensor,  # [G, 3H], kept on the hidden path
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
) -> torch.Tensor:
    """Differentiable grouped GRU recurrence -> final hidden ``[G, B, H]``
    (reference ``grouped_gru_trainable``)."""
    return _GRUTrainable.apply(x_proj, w_hh, b_hh, lengths)
