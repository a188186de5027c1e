"""PyTorch/CUDA port of the multimodal sensor fusion framework for NVIDIA Hopper.

The JAX package ``multimodal_sensor_fusion_with_attention_rajeevatla_tpu`` is
the reference; this package mirrors its layout module for module and never
imports it (nor JAX). The kernels the reference wrote in Pallas for the TPU
are hand-written CUDA C++ for ``sm_90a`` here (``ops/csrc``), each with a
plain PyTorch twin that the CPU takes.

Ported so far: the flagship hybrid-transformer model from training to
evaluation: ``train.trainer.Trainer.fit`` (AdamW behind accumulation, the
augmentations, early stopping, top-k checkpoints in ``train/checkpoint.py``),
``evaluate.run_evaluation`` (metrics, calibration, latency, the
missing-modality sweep, MC dropout and temperature scaling from
``uncertainty.py``), ``serving.make_serving_fn`` and the ``train`` / ``eval``
commands of ``python -m <package>`` (``cli.py``). The other encoders and
fusion heads, the streaming loader and the parallel layouts are queued in
``ROADMAP.md``.

Entry points (``models.module.MultimodalFusionModel.from_config``,
``train.trainer.Trainer``, ``evaluate.run_evaluation``,
``serving.make_serving_fn``, ``data.device.DeviceSplit.from_windows``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
