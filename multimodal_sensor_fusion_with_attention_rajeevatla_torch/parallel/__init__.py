"""Parallel layouts on ``torch.distributed``: the rank mesh and sharding
rules (``mesh``), the collectives (``comm``), the tensor-parallel
feed-forward (``tp_kernels``) and the GPipe layer pipeline (``pipeline``)."""

from .mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    shard_batch,
)
