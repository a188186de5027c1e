"""Grouped LSTM / GRU recurrences: CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/pallas_rnn.py`` (inference: the final
hidden state of G independent recurrences run as one call). Layouts are the
reference's: raw inputs ``x [T, G, B, D]``, precomputed input projections
``x_proj [T, G, B, gates*H]``, weights ``[G, in, gates*H]``, biases
``[G, gates*H]``, int32 ``lengths [B]`` shared by the groups, result
``[G, B, H]``. Gate order is torch's: LSTM (i, f, g, o), GRU (r, z, n) with the
hidden bias of the candidate gate inside the reset gate,
``n = tanh(x W_in + b_in + r * (h W_hn + b_hn))``. A row's carry freezes at
its length (``keep * new + (1 - keep) * old`` with ``keep = t < length``), so
the result is the state after the row's last valid step and a row of length 0
returns exact zeros.

``lstm_step`` and ``gru_step`` are the one cell update everything here and
``models.encoders.RNNStack`` / ``models.grouped.GroupedRNNEncoder`` share;
``rnn_scan`` loops them over time. ``grouped_lstm_forward``,
``grouped_lstm_fused`` and ``grouped_gru_fused`` are the kernel wrappers: CUDA
tensors launch ``csrc/rnn.cu`` (one launch for the whole sequence and every
group; forward only, the result carries no gradient) or raise, CPU tensors
take the ``*_plain`` version. The reference's TPU tiling arguments
(``block_t``, ``interpret``) have no counterpart.
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
    valid = None
    if lengths is not None:
        valid = (torch.arange(steps, device=x_proj.device)[:, None]
                 < lengths[None, :].to(torch.int32)).to(x_proj.dtype)[..., None]  # [T, B, 1]
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


def _kernel_fn(name: str, pointers: int, ints: int):
    lib = _build.library("rnn")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(wrapper, entry: str, tensors, lengths, out, dims) -> torch.Tensor:
    """Launch ``entry`` on the tensors' device and stream; ``out [G, B, H]``."""
    device = out.device
    steps, batch = dims[0], dims[2]
    if batch == 0:
        return out
    if lengths is None:
        lengths = torch.full((batch,), steps, dtype=torch.int32, device=device)
    lib, fn = _kernel_fn(entry, len(tensors) + 2, len(dims))
    with torch.cuda.device(device):
        code = fn(
            *(t.data_ptr() for t in tensors), lengths.contiguous().data_ptr(), out.data_ptr(),
            *dims, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out


def grouped_lstm_forward(
    x_proj: torch.Tensor,  # [T, G, B, 4H] input projections (with b_ih)
    w_hh: torch.Tensor,  # [G, H, 4H]
    b_hh: torch.Tensor,  # [G, 4H]
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
) -> torch.Tensor:
    """Grouped LSTM recurrence over precomputed input projections -> final
    hidden ``[G, B, H]``. ``grouped_lstm_forward.launches`` counts launches."""
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
    return _launch(grouped_lstm_forward, "msfa_grouped_lstm_forward", list(tensors.values()),
                   lengths, out, (steps, groups, batch, hidden))


grouped_lstm_forward.launches = 0


def grouped_lstm_fused(
    x: torch.Tensor,  # [T, G, B, D] raw inputs (features zero-padded to the group's D)
    w_ih: torch.Tensor,  # [G, D, 4H]
    w_hh: torch.Tensor,  # [G, H, 4H]
    bias: torch.Tensor,  # [G, 4H] b_ih + b_hh
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
) -> torch.Tensor:
    """Grouped LSTM with the input projection inside the kernel -> final
    hidden ``[G, B, H]``. ``grouped_lstm_fused.launches`` counts launches."""
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
    return _launch(grouped_lstm_fused, "msfa_grouped_lstm_fused", list(tensors.values()),
                   lengths, out, (steps, groups, batch, feat, hidden))


grouped_lstm_fused.launches = 0


def grouped_gru_fused(
    x: torch.Tensor,  # [T, G, B, D]
    w_ih: torch.Tensor,  # [G, D, 3H]
    w_hh: torch.Tensor,  # [G, H, 3H]
    b_ih: torch.Tensor,  # [G, 3H]
    b_hh: torch.Tensor,  # [G, 3H], kept on the hidden path
    lengths: Optional[torch.Tensor] = None,  # [B] int32; None = T
) -> torch.Tensor:
    """Grouped GRU with the input projection inside the kernel -> final
    hidden ``[G, B, H]``. ``grouped_gru_fused.launches`` counts launches."""
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
    return _launch(grouped_gru_fused, "msfa_grouped_gru_fused", list(tensors.values()),
                   lengths, out, (steps, groups, batch, feat, hidden))


grouped_gru_fused.launches = 0
