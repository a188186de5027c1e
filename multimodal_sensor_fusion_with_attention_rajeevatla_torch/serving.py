"""Serving path: the inference function over the model's resident weights,
and the deployment bundle that carries it without the model code.

Port of the JAX package's ``serving.py``. ``make_serving_fn``: transformer
encoders run as plain matmuls around the attention kernels (packed up to 512
steps, ``flash_self_attention`` beyond, or for a grouped encoder); grouped
lstm / gru encoders run their whole recurrence as one kernel launch
(``ops/rnn.py``, with ``model.pallas_rnn`` on); the 12-pair hybrid head runs as
one fused kernel (``ops/fusion.py``); the early, late and uncertainty heads
run as the model's own ``nn.Linear`` layers, as in the reference.

``export_serving_bundle`` writes that function as a directory of three files:
``serving.pt2`` (``torch.export`` of the eval forward at fixed ``[B, T, D_m]``
shapes, a function of ``(params, features, mask, lengths)`` that holds no
weight), ``params.npz`` (the weights and buffers under the port's
``state_dict`` names) and ``bundle.json``. The kernels sit in the graph as the
``msfa::`` custom ops of ``ops/library.py``, so the bundle launches the same
kernels as ``make_serving_fn`` on the card and runs their plain twins on the
CPU; the reference's bundle holds its plain XLA graph only (a Pallas call
cannot go into its multi-platform artifact). ``load_serving_bundle`` rebuilds
the function from the directory and imports no module of ``models/``,
``train/`` or ``evaluate.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Mapping, Optional

import numpy as np
import torch

from .ops.fusion import hybrid_fused_inference, hybrid_head_params
from .utils.device import resolve_device

if TYPE_CHECKING:
    from .models.module import MultimodalFusionModel


def _uses_kernel_head(model: "MultimodalFusionModel", use_kernel_head: bool = True) -> bool:
    """The hybrid head runs as the fused head kernel when there are at least
    2 modalities (the pair structure needs 2); otherwise the model's own."""
    return use_kernel_head and model.fusion_type == "hybrid" and len(model.modalities) >= 2


def _kernel_head_forward(model, params, features: Mapping[str, torch.Tensor], mask, lengths):
    """The encoders, then the fused head on ``params`` (``HeadParams``)."""
    modalities = tuple(model.modalities)
    first = next(iter(features.values()))
    batch = first.shape[0]
    if mask is None:
        mask = torch.ones((batch, len(modalities)), dtype=torch.float32, device=first.device)
    encoded = model.encode(features, lengths)
    # a modality absent from the batch dict contributes a zero embedding
    # (the mask governs its weight), as in the reference
    for name in modalities:
        if name not in encoded:
            encoded[name] = torch.zeros(
                (batch, model.output_dim), dtype=torch.float32, device=first.device
            )
    return hybrid_fused_inference(params, encoded, mask, modalities)


def make_serving_fn(
    model: "MultimodalFusionModel",
    device=None,
    use_kernel_head: bool = True,
):
    """Build ``serve(features, mask=None, lengths=None) -> logits [B, C]``.

    Moves ``model`` to ``device`` (default ``cuda``; raises without it unless
    ``device="cpu"``) in eval mode. ``use_kernel_head`` routes the hybrid
    head through the fused head kernel when there are at least 2 modalities
    (the pair structure needs 2); otherwise the model's own head runs. The
    function runs under ``torch.inference_mode`` and never waits on the
    device: the caller synchronises when it reads the logits.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    if not _uses_kernel_head(model, use_kernel_head):

        @torch.inference_mode()
        def serve(features: Dict[str, torch.Tensor], mask=None, lengths=None):
            return model(features, mask, lengths)

        return serve

    params = hybrid_head_params(model.fusion_model)

    @torch.inference_mode()
    def serve(
        features: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return _kernel_head_forward(model, params, features, mask, lengths)

    return serve


# ---------------------------------------------------------------------------
# deployment bundles (torch.export)
# ---------------------------------------------------------------------------

_BUNDLE_GRAPH = "serving.pt2"
_BUNDLE_PARAMS = "params.npz"
_BUNDLE_META = "bundle.json"


def _flatten_params(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The weights and buffers (BatchNorm statistics included) as host
    arrays under the model's ``state_dict`` names."""
    return {name: t.detach().cpu().numpy() for name, t in model.state_dict().items()}


class _KernelHeadServe(torch.nn.Module):
    """``make_serving_fn``'s kernel-head function as a module over ``model``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, features, mask, lengths):
        return _kernel_head_forward(self.model, hybrid_head_params(self.model.fusion_model),
                                    features, mask, lengths)


class _ServingGraph(torch.nn.Module):
    """The exported function ``(params, features, mask, lengths) -> logits``.
    The served module is held outside the module tree, so the graph has no
    weight of its own: ``params`` (``state_dict`` names) are inputs, swapped
    in by ``functional_call``."""

    def __init__(self, model, kernel_head: bool):
        super().__init__()
        serve, prefix = (_KernelHeadServe(model), "model.") if kernel_head else (model, "")
        object.__setattr__(self, "_serve", serve)
        self._prefix = prefix

    def forward(self, params, features, mask, lengths):
        swapped = {self._prefix + name: t for name, t in params.items()}
        return torch.func.functional_call(self._serve, swapped, (features, mask, lengths))


def export_serving_bundle(
    model: "MultimodalFusionModel",
    out_dir: str | Path,
    batch_size: int,
    chunk_size: int,
    feature_dims: Mapping[str, int],
    device=None,
) -> Path:
    """Export a serving bundle for fixed ``[B, T, D_m]`` shapes -> the
    bundle directory.

    The graph is ``make_serving_fn``'s function on ``device`` (default
    ``cuda``; ``device="cpu"`` exports on the CPU): for a hybrid model with
    at least 2 modalities the encoders and the fused head kernel, otherwise
    the model's own head. Its inputs are the flat params, ``features {m:
    [B, T, D_m]}`` float32, ``mask [B, M]`` float32 and ``lengths [B]``
    int32; the kernels are ``msfa::`` op nodes, whose names ``bundle.json``
    lists under ``ops``.
    """
    from .ops import library

    device = resolve_device(device)
    model = model.to(device).eval()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    modalities = tuple(model.modalities)
    params = {name: t.detach() for name, t in model.state_dict().items()}
    features = {
        m: torch.zeros((batch_size, chunk_size, int(feature_dims[m])), device=device)
        for m in modalities
    }
    mask = torch.ones((batch_size, len(modalities)), device=device)
    lengths = torch.full((batch_size,), chunk_size, dtype=torch.int32, device=device)
    graph = _ServingGraph(model, _uses_kernel_head(model))
    with torch.no_grad():
        exported = torch.export.export(graph, (params, features, mask, lengths), strict=False)
    exported.example_inputs = None  # they hold the weights: keep them out of the graph file
    torch.export.save(exported, out_dir / _BUNDLE_GRAPH)
    np.savez(out_dir / _BUNDLE_PARAMS, **_flatten_params(model))
    meta = {
        "modalities": list(modalities),
        "batch_size": int(batch_size),
        "chunk_size": int(chunk_size),
        "feature_dims": {m: int(feature_dims[m]) for m in modalities},
        "num_classes": int(model.num_classes),
        "device": device.type,
        "torch_version": torch.__version__,
        "ops": library.graph_ops(exported.graph),
    }
    (out_dir / _BUNDLE_META).write_text(json.dumps(meta, indent=2))
    return out_dir


def load_serving_bundle(bundle_dir: str | Path, device=None):
    """Load a bundle -> ``(fn(features, mask=None, lengths=None), meta)``.

    ``device`` defaults to the card (``device="cpu"`` serves on the CPU,
    whichever device the bundle was exported on: the graph is moved, and its
    ``msfa::`` ops take their plain twins there). The params are read from
    ``params.npz`` onto the device once; ``fn`` runs the deserialized graph
    under ``torch.inference_mode`` with the reference's defaults, a mask of
    ones and every length ``chunk_size``. No model code runs. ``fn.exported``
    is the deserialized ``ExportedProgram``, ``fn.graph`` its module and
    ``fn.params`` the weights ``fn`` passes it.
    """
    from .ops import library  # noqa: F401  (registers the msfa:: ops the graph calls)

    device = resolve_device(device)
    bundle_dir = Path(bundle_dir)
    meta = json.loads((bundle_dir / _BUNDLE_META).read_text())
    exported = torch.export.load(bundle_dir / _BUNDLE_GRAPH)
    if meta["device"] != device.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    graph = exported.module()
    with np.load(bundle_dir / _BUNDLE_PARAMS) as npz:
        params = {key: torch.from_numpy(npz[key]).to(device) for key in npz.files}
    modalities = meta["modalities"]

    @torch.inference_mode()
    def fn(features, mask=None, lengths=None):
        batch = next(iter(features.values())).shape[0]
        if mask is None:
            mask = torch.ones((batch, len(modalities)), dtype=torch.float32, device=device)
        if lengths is None:
            lengths = torch.full((batch,), meta["chunk_size"], dtype=torch.int32, device=device)
        feats = {m: torch.as_tensor(features[m], dtype=torch.float32, device=device)
                 for m in modalities}
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        return graph(params, feats, mask, lengths)

    fn.exported = exported  # the deserialized program: its graph holds the msfa:: op nodes
    fn.graph, fn.params = graph, params  # its module and the weights fn calls it with
    return fn, meta

