"""Serving path: the inference function over the model's resident weights.

Port of the JAX package's ``serving.py::make_serving_fn``. Transformer
encoders run as plain matmuls around the attention kernels (packed up to 512
steps, ``flash_self_attention`` beyond, or for a grouped encoder); grouped
lstm / gru encoders run their whole recurrence as one kernel launch
(``ops/rnn.py``, with ``model.pallas_rnn`` on); the 12-pair hybrid head runs as
one fused kernel (``ops/fusion.py``). AOT export bundles are queued (ROADMAP
queue A item 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .models.module import MultimodalFusionModel
from .ops.fusion import hybrid_fused_inference, hybrid_head_params
from .utils.device import resolve_device


def make_serving_fn(
    model: MultimodalFusionModel,
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
    modalities = tuple(model.modalities)
    kernel_head = (
        use_kernel_head and model.fusion_type == "hybrid" and len(modalities) >= 2
    )
    if not kernel_head:

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
        batch = next(iter(features.values())).shape[0]
        if mask is None:
            mask = torch.ones((batch, len(modalities)), dtype=torch.float32, device=device)
        encoded = model.encode(features, lengths)
        # a modality absent from the batch dict contributes a zero embedding
        # (the mask governs its weight), as in the reference
        for name in modalities:
            if name not in encoded:
                encoded[name] = torch.zeros(
                    (batch, model.output_dim), dtype=torch.float32, device=device
                )
        return hybrid_fused_inference(params, encoded, mask, modalities)

    return serve
