"""Self-contained checkpoints: weights + config, top-k managed. Port of the
JAX package's ``train/checkpoint.py``.

A checkpoint is a directory:

    <dir>/epoch=<N>-val_loss=<X.XXXX>/   one of the best ``save_top_k`` by val loss
        variables.pt                     the model's ``state_dict`` (CPU tensors: the
                                         weights and any BatchNorm running statistics)
        meta.json                        epoch, val_loss and the resolved config
    <dir>/last/                          the newest epoch, whatever its score
        variables.pt, meta.json
        train_state.pt                   optimizer tensors and counters, and the
                                         trainer's generator state

``load_checkpoint`` rebuilds ``(state_dict, config, meta)`` from the directory
alone, which is enough for ``MultimodalFusionModel.from_config`` +
``load_state_dict``. ``last`` carries what a resumed run needs to repeat an
uninterrupted one. Storage is ``torch.save`` of plain tensors and numbers,
read back with ``torch.load(weights_only=True)``. In a ``torch.distributed``
world rank 0 alone changes the filesystem (``_is_primary``), between two
barriers (``_sync``), the reference's order: every rank passes the same
(gathered, whole) state and keeps the same top-k bookkeeping, so
``best_model_path`` is the same everywhere and the files are there when any
rank reads them. A checkpoint of an N-rank run loads into one process as it
is.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import comm
from ..utils.config import ConfigNode

_VARIABLES = "variables.pt"
_TRAIN_STATE = "train_state.pt"


def _is_primary() -> bool:
    """True on the process that owns filesystem changes (rank 0, or the one
    process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync(name: str) -> None:
    """A barrier over the world; no-op in one process. ``name`` says where
    (the reference's barrier names)."""
    if dist.is_initialized():
        comm.barrier(dist.group.WORLD)


def _to_cpu(tree: Any) -> Any:
    """Detached CPU copies of every tensor in a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


class CheckpointManager:
    """Top-k checkpointing keyed on a monitored metric (lower is better)."""

    def __init__(
        self,
        directory: str | Path,
        config: Optional[ConfigNode] = None,
        save_top_k: int = 3,
        save_last: bool = True,
        adopt_existing: bool = True,
    ):
        self.directory = Path(directory)
        if _is_primary():
            self.directory.mkdir(parents=True, exist_ok=True)
        _sync("checkpoint_dir")
        self.config = config
        self.save_top_k = save_top_k
        self.save_last = save_last
        self._entries: List[Tuple[float, Path]] = []  # (score, path)
        # adopt checkpoints already on disk (mid-run resume): top-k tracking
        # and best_model_path must span the whole run. A fresh run into a
        # reused directory must not adopt: a previous run's better checkpoint
        # would win best_model_path and the test metric. The Trainer passes
        # adopt_existing only under resume_from.
        if adopt_existing:
            for existing in sorted(self.directory.glob("epoch=*-val_loss=*")):
                try:
                    score = float(existing.name.rsplit("val_loss=", 1)[1])
                except ValueError:
                    continue
                self._entries.append((score, existing))

    def _best(self) -> Optional[Tuple[float, Path]]:
        return min(self._entries, key=lambda e: e[0]) if self._entries else None

    @property
    def best_model_path(self) -> Optional[str]:
        best = self._best()
        return None if best is None else str(best[1])

    @property
    def best_model_score(self) -> Optional[float]:
        best = self._best()
        return None if best is None else float(best[0])

    @property
    def best_model_epoch(self) -> Optional[int]:
        """Epoch of the best entry (parsed from ``epoch=N-val_loss=...``);
        lets a resumed run restore its early-stopping patience counter."""
        best = self._best()
        if best is None:
            return None
        try:
            return int(best[1].name.split("epoch=", 1)[1].split("-", 1)[0])
        except (IndexError, ValueError):
            return None

    def _write(self, path: Path, variables, meta: Dict[str, Any], train_state=None) -> None:
        if not _is_primary():
            return
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(variables, path / _VARIABLES)
        if train_state is not None:
            torch.save(train_state, path / _TRAIN_STATE)
        payload = dict(meta)
        if self.config is not None:
            payload["config"] = self.config.to_container(resolve=True)
        (path / "meta.json").write_text(json.dumps(payload, indent=2))

    def save(
        self,
        variables: Mapping[str, torch.Tensor],
        epoch: int,
        score: float,
        extra_meta: Optional[Dict[str, Any]] = None,
        train_state: Any = None,
    ) -> Optional[str]:
        """Save if within top-k; also refresh ``last`` (which additionally
        carries the optimizer and generator state for mid-run resume).
        Returns the saved top-k path, if any."""
        meta = {"epoch": int(epoch), "val_loss": float(score)}
        if extra_meta:
            meta.update(extra_meta)
        saved_path: Optional[str] = None
        _sync("checkpoint_save_start")
        # fetched from the device once; the top-k and "last" writes share it
        host_vars = _to_cpu(dict(variables))
        host_state = _to_cpu(train_state) if train_state is not None else None

        if self.save_top_k != 0:
            path = self.directory / f"epoch={epoch}-val_loss={score:.4f}"
            worst = max(self._entries, key=lambda e: e[0])[0] if self._entries else None
            if (
                self.save_top_k < 0
                or len(self._entries) < self.save_top_k
                or (worst is not None and score < worst)
            ):
                self._write(path, host_vars, meta)
                self._entries.append((float(score), path))
                saved_path = str(path)
                while self.save_top_k > 0 and len(self._entries) > self.save_top_k:
                    worst_entry = max(self._entries, key=lambda e: e[0])
                    self._entries.remove(worst_entry)
                    if _is_primary() and worst_entry[1].exists():
                        shutil.rmtree(worst_entry[1])

        if self.save_last:
            self._write(self.directory / "last", host_vars, meta, host_state)
        _sync("checkpoint_save_end")
        return saved_path


def load_train_state(path: str | Path) -> Dict[str, Any]:
    """The optimizer and generator state saved with a ``last`` checkpoint
    (CPU tensors; ``Trainer.load_train_state`` puts them back)."""
    state_file = Path(path) / _TRAIN_STATE
    if not state_file.exists():
        raise FileNotFoundError(f"No train_state in checkpoint: {path}")
    return torch.load(state_file, map_location="cpu", weights_only=True)


def load_checkpoint(path: str | Path):
    """Restore ``(state_dict, config, meta)`` from a checkpoint directory.

    The config is a :class:`ConfigNode` rebuilt from the bundled resolved
    JSON (``None`` when the checkpoint was written without one): enough to
    rebuild the model with ``MultimodalFusionModel.from_config`` and load the
    weights into it. Tensors come back on the CPU.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Checkpoint not found: {path}")
    variables = torch.load(path / _VARIABLES, map_location="cpu", weights_only=True)
    meta_path = path / "meta.json"
    config = None
    meta: Dict[str, Any] = {}
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if "config" in meta:
            config = ConfigNode(meta["config"])
    return variables, config, meta
