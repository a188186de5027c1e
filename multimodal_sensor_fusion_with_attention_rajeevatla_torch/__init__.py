"""PyTorch/CUDA port of the multimodal sensor fusion framework for NVIDIA Hopper.

The JAX package ``multimodal_sensor_fusion_with_attention_rajeevatla_tpu`` is
the reference; this package mirrors its layout module for module and never
imports it (nor JAX). The kernels the reference wrote in Pallas for the TPU
are hand-written CUDA C++ for ``sm_90a`` here (``ops/csrc``), each with a
plain PyTorch twin that the CPU takes.

Ported so far: the model zoo from training to evaluation and deployment:
``train.trainer.Trainer.fit`` (AdamW behind accumulation, the augmentations,
early stopping, top-k checkpoints in ``train/checkpoint.py``, resident or
streamed batches), ``evaluate.run_evaluation`` (metrics, calibration,
latency, the missing-modality sweep, MC dropout and temperature scaling from
``uncertainty.py``), ``serving.make_serving_fn`` and its exported bundle
(``export_serving_bundle`` / ``load_serving_bundle``), ``analysis.py``, the
raw-data ETL (``data/preprocess.py``) and the ``train`` / ``eval`` /
``analysis`` / ``preprocess`` commands of ``python -m <package>``
(``cli.py``). The parallel layouts are queued in ``ROADMAP.md``.

Entry points (``models.module.MultimodalFusionModel.from_config``,
``train.trainer.Trainer``, ``evaluate.run_evaluation``,
``serving.make_serving_fn``, ``serving.load_serving_bundle``,
``data.device.DeviceSplit.from_windows``, ``data.device.StreamingDeviceLoader``)
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
