"""PyTorch/CUDA port of the multimodal sensor fusion framework for NVIDIA Hopper.

The JAX package ``multimodal_sensor_fusion_with_attention_rajeevatla_tpu`` is
the reference; this package mirrors its layout module for module and never
imports it (nor JAX). The kernels the reference wrote in Pallas for the TPU
are hand-written CUDA C++ for ``sm_90a`` here (``ops/csrc``), each with a
plain PyTorch twin that the CPU takes.

Ported so far: the serving path of the flagship hybrid-transformer model
(``serving.make_serving_fn``). Training, the other encoders and fusion heads,
evaluation and the parallel layouts are queued in ``ROADMAP.md``.

Entry points (``models.module.MultimodalFusionModel.from_config``,
``serving.make_serving_fn``, ``data.device.DeviceSplit.from_windows``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
