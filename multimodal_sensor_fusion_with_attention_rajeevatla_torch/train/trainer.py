"""Training runtime: port of the JAX package's ``train/trainer.py`` (schedule,
optimizer, augmentations, the per-batch step and ``fit``).

- ``lr_schedule``: per-epoch cosine (``eta_min = lr / 100``), StepLR(30, 0.1)
  or constant, read at the optimizer's inner update count.
- ``AccumulatedAdamW``: what ``optax.MultiSteps(chain(clip_by_global_norm,
  adamw), k)`` does, written out: gradients averaged over ``k`` micro-steps
  (running mean, as optax), then clip and AdamW (b1 0.9, b2 0.999, eps 1e-8,
  bias correction, decoupled decay on every parameter) on the k-th only.
- ``apply_temporal_jitter``, ``add_gaussian_noise``,
  ``dropout_modality_mask``: the on-device augmentations, each taking its
  random draws as tensors so that a test can hand the same draws to both
  frameworks.
- ``Trainer``: builds the model and the optimizer from the config and makes
  the train step: on-device gather, augmentation, forward in train mode
  (BatchNorm running statistics, where the model has them, move on every
  micro-step, as the reference's ``mutable=["batch_stats"]`` does),
  label-smoothed loss, backward, optimizer. Every random draw of a step
  comes from one ``torch.Generator`` on the device, in a fixed order.
  ``fit`` trains whole epochs over a device-resident split (a Python loop
  of micro-steps where the reference compiles a scan), early-stops on the
  label-smoothed val loss with the reference's patience semantics, keeps
  top-k and ``last`` checkpoints (``train/checkpoint.py``), scores the best
  checkpoint on test and writes ``results.json`` with the reference's keys.
  ``resume_from`` restores weights, optimizer and generator from a ``last``
  checkpoint, so a resumed run repeats an uninterrupted one.

A model with MoE layers (``model.moe_experts``) reports their load-balance
aux losses, and the loss of a micro-step adds ``training.moe_aux_weight``
times their sum, as the reference's does. ``training.remat`` runs the
micro-step's whole forward under ``torch.utils.checkpoint`` (non-reentrant),
the unit the reference wraps in ``jax.checkpoint``: the backward recomputes
it, with the trainer's generator put back to its state before the forward
(so the recompute draws the same masks and kernel seeds) and the BatchNorm
running statistics left as the first forward moved them; the aux losses are
outputs of the recomputed function. Loss and gradients are those of the run
without it, bit for bit, and every forward kernel launches twice a
micro-step.

The streaming loader path (``dataset.streaming``) and the parallel layouts
are not ported (ROADMAP queue A): ``check_layout`` keeps the reference's
``ValueError``s for an inconsistent ``parallel`` block and an unknown
``training.prng_impl``, and raises ``NotImplementedError`` for any layout
other than one card.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..data.dataset import WindowedSplit, padded_index_matrix
from ..data.device import DeviceSplit
from ..models.encoders import running_stats_frozen
from ..models.module import MultimodalFusionModel
from ..ops.metrics import cross_entropy_loss, weighted_accuracy
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager, load_checkpoint, load_train_state


def lr_schedule(
    scheduler: str, learning_rate: float, max_epochs: int, updates_per_epoch: int
) -> Callable[[int], float]:
    """Per-epoch learning rate as a function of the update count.

    cosine: ``CosineAnnealingLR(T_max=max_epochs, eta_min=lr/100)`` at the
    epoch index (clipped to ``max_epochs``); step: ``StepLR(30, 0.1)``;
    anything else: constant.
    """
    updates_per_epoch = max(1, updates_per_epoch)

    def schedule(count: int) -> float:
        epoch = float(min(count // updates_per_epoch, max_epochs))
        if scheduler == "cosine":
            eta_min = learning_rate / 100.0
            return eta_min + 0.5 * (learning_rate - eta_min) * (
                1.0 + math.cos(math.pi * epoch / max(max_epochs, 1))
            )
        if scheduler == "step":
            return learning_rate * 0.1 ** math.floor(epoch / 30.0)
        return learning_rate

    return schedule


class AccumulatedAdamW:
    """Clip + AdamW (or Adam with coupled L2) behind gradient accumulation.

    ``step(grads)`` takes one micro-step's gradients; every ``accum``-th call
    it clips the accumulated mean by its global norm, runs the Adam update
    with the schedule read at the inner count (before it is incremented),
    applies it to the parameters in place and returns True. State is plain
    tensors on the parameters' device; nothing synchronises with the host.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Callable[[int], float],
        weight_decay: float = 0.0,
        clip_norm: float = 0.0,
        accum: int = 1,
        decoupled: bool = True,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.accum = max(1, int(accum))
        self.decoupled = decoupled
        self.b1, self.b2, self.eps = b1, b2, eps
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.count = 0  # inner (applied) updates

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        n = self.mini_step
        for acc, p, g in zip(self.acc, self.params, grads):
            g = torch.zeros_like(p) if g is None else g
            acc.add_((g - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.accum:
            return False
        self.mini_step = 0
        updates = self.acc
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(u.square().sum() for u in updates))
            updates = [torch.where(norm < self.clip_norm, u, (u / norm) * self.clip_norm)
                       for u in updates]
        if not self.decoupled and self.weight_decay:
            updates = [u + self.weight_decay * p for u, p in zip(updates, self.params)]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, u, mu, nu in zip(self.params, updates, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * u)
            nu.mul_(self.b2).add_((1.0 - self.b2) * u * u)
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.decoupled and self.weight_decay:
                step = step + self.weight_decay * p
            p.add_(step * -lr)
        for acc in self.acc:
            acc.zero_()
        return True

    def state_dict(self) -> Dict[str, Any]:
        """Accumulator, moments and both counters (what a resume needs)."""
        return {"acc": list(self.acc), "mu": list(self.mu), "nu": list(self.nu),
                "mini_step": self.mini_step, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for name in ("acc", "mu", "nu"):
            own = getattr(self, name)
            if len(own) != len(state[name]):
                raise ValueError(f"optimizer state has {len(state[name])} {name} tensors, "
                                 f"the model {len(own)} parameters")
            for dst, src in zip(own, state[name]):
                dst.copy_(src)
        self.mini_step, self.count = int(state["mini_step"]), int(state["count"])


def build_optimizer(
    training_cfg, params: Iterable[torch.Tensor], steps_per_epoch: int
) -> Tuple[AccumulatedAdamW, int]:
    """Optimizer from the ``training:`` config block -> ``(optimizer, accum)``."""
    name = str(training_cfg.get("optimizer", "adamw"))
    if name not in ("adamw", "adam"):
        raise ValueError(f"Unknown optimizer: {name}")
    accum = int(training_cfg.get("gradient_accumulation", 1) or 1)
    schedule = lr_schedule(
        str(training_cfg.get("scheduler", "none")),
        float(training_cfg.get("learning_rate", 1e-3)),
        int(training_cfg.get("max_epochs", 1)),
        max(1, steps_per_epoch // max(1, accum)),
    )
    opt = AccumulatedAdamW(
        params,
        schedule,
        weight_decay=float(training_cfg.get("weight_decay", 0.0)),
        clip_norm=float(training_cfg.get("gradient_clip_norm", 0.0) or 0.0),
        accum=accum,
        decoupled=name == "adamw",
    )
    return opt, accum


def apply_temporal_jitter(
    features: Dict[str, torch.Tensor],
    lengths: Optional[torch.Tensor],
    uniform: torch.Tensor,  # [B] draws in [0, 1)
    jitter: float,
):
    """Per-sample circular shift of up to ``jitter * T`` steps, each modality
    in its own timebase, and lengths shrunk by the shift in the first
    modality's timebase (never below 1)."""
    first = next(iter(features.values()))
    batch, ref_len = first.shape[0], first.shape[1]
    if int(jitter * ref_len) <= 0:
        return features, lengths
    frac = uniform * jitter

    def roll(x):
        if x.dim() < 3:
            return x
        t = x.shape[1]
        shift = torch.floor(frac * t).to(torch.int64)
        idx = (torch.arange(t, device=x.device)[None, :] + shift[:, None]) % t
        return x.gather(1, idx.view(batch, t, *[1] * (x.dim() - 2)).expand_as(x))

    jittered = {m: roll(v) for m, v in features.items()}
    if lengths is None:
        return jittered, None
    ref_shift = torch.floor(frac * ref_len).to(lengths.dtype)
    return jittered, torch.clamp(lengths - ref_shift, min=1)


def add_gaussian_noise(
    features: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor], std: float
) -> Dict[str, torch.Tensor]:
    """``x + std * z`` per modality, ``z`` standard normal draws."""
    return {m: v + std * noise[m] for m, v in features.items()}


def dropout_modality_mask(
    uniform: torch.Tensor,  # [B, M] draws in [0, 1)
    revive: torch.Tensor,  # [B] int draws in [0, M)
    rate: float,
) -> torch.Tensor:
    """Drop each modality with probability ``rate`` but never all of them: a
    row that lost every modality gets back the one ``revive`` names."""
    if rate <= 0:
        return torch.ones_like(uniform)
    keep = (uniform > rate).to(torch.float32)
    revived = torch.nn.functional.one_hot(revive.long(), uniform.shape[1]).to(torch.float32)
    dead = keep.sum(dim=1, keepdim=True) == 0
    return torch.where(dead, revived, keep)


# the reference's training.prng_impl values (JAX train/trainer.py)
PRNG_IMPLS = ("threefry", "rbg", "unsafe_rbg")


def check_layout(config) -> None:
    """The reference trainer's checks of ``parallel.*`` with its messages,
    then ``NotImplementedError`` for what the port does not run: more than one
    device (``num_devices`` above 1; ``auto`` and null are the one card here)
    and so every mesh axis and ZeRO (ROADMAP A11). Every default of
    ``config/base.yaml`` passes.

    ``training.prng_impl`` keeps the reference's ``ValueError`` for a value
    other than ``threefry``, ``rbg`` or ``unsafe_rbg``. The three known
    values are accepted and change nothing: they pick the TPU's random-bit
    generator, and the port's dropout masks come from the Philox kernel, or
    from torch's generator at ``dropout_rng: xla``, whatever the key says
    (the same caveat as ``dropout_rng: auto``)."""
    prng_impl = str(config.training.get("prng_impl", "")).lower() or "threefry"
    if prng_impl not in PRNG_IMPLS:
        raise ValueError(
            f"Unknown training.prng_impl {prng_impl!r}; expected threefry or rbg")
    par = config.get("parallel", {}) or {}
    model_parallel = int(par.get("model_parallel", 1) or 1)
    pipeline_parallel = int(par.get("pipeline_parallel", 1) or 1)
    dcn_slices = int(par.get("dcn_slices", 1) or 1)
    zero_optimizer = bool(par.get("zero_optimizer", False))
    sequence_parallel = bool(par.get("sequence_parallel", False))
    if pipeline_parallel > 1 and model_parallel > 1:
        raise ValueError(
            "parallel.pipeline_parallel cannot be combined with parallel.model_parallel (the "
            "pipelined stack's shard_map is manual over 'pipe' only)")
    if sequence_parallel and model_parallel <= 1:
        raise ValueError(
            "parallel.sequence_parallel requires parallel.model_parallel > 1 (it shards "
            "activations across the tensor-parallel group)")
    moe_experts = int(config.model.get("moe_experts", 0) or 0)
    if moe_experts and model_parallel > 1 and moe_experts % model_parallel:
        raise ValueError(
            f"model.moe_experts ({moe_experts}) must divide evenly over parallel.model_parallel "
            f"({model_parallel}) for expert parallelism")
    requested = par.get("num_devices", 1)
    devices = 1 if requested in (None, "auto") else int(requested)
    layout = {"num_devices": devices, "model_parallel": model_parallel,
              "dcn_slices": dcn_slices, "pipeline_parallel": pipeline_parallel,
              "zero_optimizer": zero_optimizer, "sequence_parallel": sequence_parallel}
    defaults = {"num_devices": 1, "model_parallel": 1, "dcn_slices": 1, "pipeline_parallel": 1,
                "zero_optimizer": False, "sequence_parallel": False}
    if devices <= 1:
        if model_parallel > 1 or dcn_slices > 1 or pipeline_parallel > 1 or zero_optimizer:
            raise ValueError(
                "parallel.model_parallel / parallel.dcn_slices / parallel.pipeline_parallel / "
                "parallel.zero_optimizer require parallel.num_devices > 1")
    else:
        keys = ", ".join(f"parallel.{k}={v}" for k, v in layout.items() if v != defaults[k])
        raise NotImplementedError(
            f"{keys} is not ported yet (ROADMAP queue A item 11): the port trains on one card")


class Trainer:
    """Config-driven experiment runner on one device (reference ``Trainer``).

    Typical use::

        trainer = Trainer(config)                      # model on the card
        results = trainer.fit(train_windows, val_windows, test_windows)

    or, step by step::

        trainer.init_state(steps_per_epoch)
        step = trainer.make_train_step_fn()
        loss, acc = step(device_split, idx)            # one micro-step
    """

    def __init__(self, config, model: Optional[MultimodalFusionModel] = None, device=None):
        check_layout(config)
        self.config = config
        self.device = resolve_device(device)
        self.model = model or MultimodalFusionModel.from_config(config, device=self.device)
        training = config.training
        self.label_smoothing = float(training.get("label_smoothing", 0.0))
        self.remat = bool(training.get("remat", False))
        self.moe_aux_weight = float(training.get("moe_aux_weight", 0.01))
        augmentation = training.get("augmentation", {}) or {}
        self.modality_dropout = float(augmentation.get("modality_dropout", 0.0))
        self.gaussian_noise = float(augmentation.get("gaussian_noise", 0.0))
        self.temporal_jitter = float(augmentation.get("temporal_jitter", 0.0))
        self.batch_size = int(config.dataset.get("batch_size", 32))
        self.seed = int(config.get("seed", 42))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.optimizer: Optional[AccumulatedAdamW] = None
        self.accum = 1

    def init_state(self, steps_per_epoch: int) -> AccumulatedAdamW:
        """Build the optimizer over the model's parameters (the weights are
        the model's own: seeded at construction or loaded)."""
        self.optimizer, self.accum = build_optimizer(
            self.config.training, self.model.parameters(), steps_per_epoch
        )
        return self.optimizer

    def augment(self, features, lengths, num_mod: int):
        """Jitter, noise and modality dropout, drawn from the trainer's
        generator in that order -> ``(features, lengths, modality_mask)``."""
        g = self.generator
        first = next(iter(features.values()))
        batch, device = first.shape[0], first.device
        if self.temporal_jitter > 0:
            u = torch.rand((batch,), generator=g, device=device)
            features, lengths = apply_temporal_jitter(features, lengths, u, self.temporal_jitter)
        if self.gaussian_noise > 0:
            noise = {m: torch.randn(v.shape, generator=g, device=device) for m, v in features.items()}
            features = add_gaussian_noise(features, noise, self.gaussian_noise)
        if self.modality_dropout > 0:
            u = torch.rand((batch, num_mod), generator=g, device=device)
            revive = torch.randint(0, num_mod, (batch,), generator=g, device=device)
            mask = dropout_modality_mask(u, revive, self.modality_dropout)
        else:
            mask = torch.ones((batch, num_mod), device=device)
        return features, lengths, mask

    def _forward(self, names, mask, lengths, *feature_list):
        """The micro-step's training forward on the features ``names`` ->
        ``(logits, aux_losses)``: the unit ``training.remat`` recomputes."""
        aux: List[torch.Tensor] = []
        features = dict(zip(names, feature_list))
        logits = self.model(features, mask, lengths, train=True, generator=self.generator,
                            aux_losses=aux)
        return logits, aux

    def _remat_contexts(self):
        """``checkpoint``'s ``context_fn``, called as the forward starts: the
        forward runs as it is; the recompute runs from the generator's state
        at that moment (which it restores to its own afterwards) and leaves
        the BatchNorm running statistics as they are."""
        start = self.generator.get_state()

        @contextlib.contextmanager
        def recompute():
            now = self.generator.get_state()
            self.generator.set_state(start)
            try:
                with running_stats_frozen():
                    yield
            finally:
                self.generator.set_state(now)

        return contextlib.nullcontext(), recompute()

    def loss_and_grads(self, features, labels, mask, lengths, weight):
        """Forward in train mode, loss, backward -> ``(loss, acc, grads)``
        with one gradient per ``model.parameters()`` entry. The loss adds
        ``moe_aux_weight`` times the model's aux losses where it reports any."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        args = (tuple(features), mask, lengths, *features.values())
        if self.remat:
            logits, aux = torch.utils.checkpoint.checkpoint(
                self._forward, *args, use_reentrant=False, context_fn=self._remat_contexts)
        else:
            logits, aux = self._forward(*args)
        loss = cross_entropy_loss(logits, labels, self.label_smoothing, sample_weight=weight)
        if aux and self.moe_aux_weight:
            loss = loss + self.moe_aux_weight * sum(aux)  # in the order the layers ran
        loss.backward()
        acc = weighted_accuracy(logits.detach(), labels, weight)
        return loss.detach(), acc, [p.grad for p in params]

    def make_train_step_fn(self):
        """``step(data, idx, weight=None) -> (loss, acc)``: one micro-step on
        the batch ``idx`` of a device-resident split; the optimizer applies
        an update every ``accum`` calls. Returns device tensors and never
        waits on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) before making the step")

        def step(data: DeviceSplit, idx: torch.Tensor, weight: Optional[torch.Tensor] = None):
            features, labels, lengths = data.gather(idx)
            if weight is None:
                weight = torch.ones(labels.shape, device=labels.device)
            features, lengths, mask = self.augment(features, lengths, len(data.modalities))
            loss, acc, grads = self.loss_and_grads(features, labels, mask, lengths, weight)
            self.optimizer.step(grads)
            return loss, acc

        return step

    # -- state for a resume ------------------------------------------------
    def train_state(self) -> Dict[str, Any]:
        """Optimizer tensors and counters plus the generator state: with the
        weights, everything the next epoch depends on."""
        return {"optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_train_state(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())

    # -- evaluation --------------------------------------------------------
    @torch.inference_mode()
    def evaluate_logits(
        self,
        data: DeviceSplit,
        batch_size: Optional[int] = None,
        model: Optional[MultimodalFusionModel] = None,
    ) -> np.ndarray:
        """Full-split forward pass in eval mode -> ``[N, C]`` logits (host
        numpy), with ``model`` or the trainer's own. The last batch is padded
        by wrap-around and cut to ``N``."""
        model = model or self.model
        n = data.num_windows
        idx_mat, _ = padded_index_matrix(n, int(batch_size or self.batch_size))
        idx_dev = torch.from_numpy(idx_mat).long().to(self.device)
        out = []
        for idx in idx_dev:
            features, _labels, lengths = data.gather(idx)
            mask = torch.ones((idx.shape[0], len(data.modalities)), device=self.device)
            out.append(model(features, mask, lengths, train=False))
        if not out:
            return np.zeros((0, model.num_classes), np.float32)
        return torch.cat(out).cpu().numpy()[:n]

    # -- host-side epoch orchestration ---------------------------------------
    def fit(
        self,
        train_windows: WindowedSplit,
        val_windows: WindowedSplit,
        test_windows: Optional[WindowedSplit] = None,
        save_dir: Optional[str | Path] = None,
        log_fn: Optional[Callable[[str], None]] = print,
        resume_from: Optional[str | Path] = None,
    ) -> Dict[str, Any]:
        """Train up to ``training.max_epochs`` epochs; returns (and writes to
        ``<save_dir>/results.json``) ``best_model_path``, ``best_val_loss``,
        ``config``, ``test_acc`` (with a test split), ``history`` and
        ``train_wall_seconds``."""
        if log_fn is print:  # flush through pipes
            log_fn = lambda msg: print(msg, flush=True)  # noqa: E731
        cfg = self.config
        if bool(cfg.dataset.get("streaming", False)):
            raise NotImplementedError("dataset.streaming is not ported yet (see ROADMAP.md)")
        max_epochs = int(cfg.training.get("max_epochs", 1))
        patience = int(cfg.training.get("early_stopping_patience", 10))
        exp_cfg = cfg.get("experiment", {}) or {}
        save_dir = Path(
            save_dir or Path(exp_cfg.get("save_dir", "runs")) / exp_cfg.get("name", "exp")
        )
        save_dir.mkdir(parents=True, exist_ok=True)

        batch = self.batch_size
        train_data = DeviceSplit.from_windows(train_windows, device=self.device)
        val_data = DeviceSplit.from_windows(val_windows, device=self.device)
        n_train = train_windows.num_windows
        steps_per_epoch = (n_train + batch - 1) // batch
        self.init_state(steps_per_epoch)
        step = self.make_train_step_fn()
        start_epoch = 0
        if resume_from is not None:
            weights, _cfg, meta = load_checkpoint(resume_from)
            self.model.load_state_dict(weights)
            self.load_train_state(load_train_state(resume_from))
            start_epoch = int(meta.get("epoch", -1)) + 1
            if log_fn:
                log_fn(f"resumed from {resume_from} at epoch {start_epoch}")

        ckpt = CheckpointManager(
            save_dir / "checkpoints",
            config=cfg,
            save_top_k=int(exp_cfg.get("save_top_k", 3)),
            save_last=True,
            # only a resumed run may adopt checkpoints already in save_dir
            adopt_existing=resume_from is not None,
        )
        writer = None
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(str(save_dir / "logs"))
        except ImportError:
            pass

        best_val = float("inf")
        bad_epochs = 0
        if resume_from is not None and ckpt.best_model_score is not None:
            # restore early-stopping state so interrupted and uninterrupted
            # runs of the same config stop at the same epoch
            best_val = float(ckpt.best_model_score)
            if ckpt.best_model_epoch is not None:
                bad_epochs = max(0, start_epoch - 1 - ckpt.best_model_epoch)
        val_labels = np.asarray(val_windows.labels)
        history = []
        t_start = time.perf_counter()
        for epoch in range(start_epoch, max_epochs):
            idx_mat, weight_mat = padded_index_matrix(n_train, batch, True, self.seed + epoch)
            idx_dev = torch.from_numpy(idx_mat).long().to(self.device)
            weight_dev = torch.from_numpy(weight_mat).to(self.device)
            stats = [step(train_data, idx, weight) for idx, weight in zip(idx_dev, weight_dev)]
            if stats:
                # epoch means stay on the device; one fetch per epoch
                train_loss, train_acc = torch.stack(
                    [torch.stack(pair) for pair in stats]).mean(dim=0).tolist()
            else:  # empty split
                train_loss = train_acc = float("nan")

            val_logits = self.evaluate_logits(val_data)
            # same criterion as training (incl. label smoothing): early
            # stopping and checkpoint ranking rank by the trained objective
            val_loss = float(cross_entropy_loss(
                torch.from_numpy(val_logits), torch.from_numpy(val_labels),
                label_smoothing=self.label_smoothing))
            val_acc = float((val_logits.argmax(-1) == val_labels).mean())
            history.append({"epoch": epoch, "train/loss": train_loss, "train/acc": train_acc,
                            "val/loss": val_loss, "val/acc": val_acc})
            if writer is not None:
                for key in ("train/loss", "train/acc", "val/loss", "val/acc"):
                    writer.add_scalar(key, history[-1][key], epoch)
            if log_fn:
                log_fn(
                    f"epoch {epoch}: train/loss={train_loss:.4f} train/acc={train_acc:.4f} "
                    f"val/loss={val_loss:.4f} val/acc={val_acc:.4f}"
                )

            ckpt.save(self.model.state_dict(), epoch, val_loss, train_state=self.train_state())
            if val_loss < best_val:
                best_val = val_loss
                bad_epochs = 0
            else:
                # stop once the counter REACHES patience, not one later
                bad_epochs += 1
                if bad_epochs >= patience:
                    if log_fn:
                        log_fn(f"early stopping at epoch {epoch} (patience {patience})")
                    break

        wall = time.perf_counter() - t_start
        results: Dict[str, Any] = {
            "best_model_path": ckpt.best_model_path or "",
            "best_val_loss": float(
                ckpt.best_model_score if ckpt.best_model_score is not None else best_val
            ),
            "config": cfg.to_container(resolve=True),
        }
        if test_windows is not None:
            best_model = self.model
            if ckpt.best_model_path:
                # rebuilt from the checkpoint directory alone
                weights, best_cfg, _meta = load_checkpoint(ckpt.best_model_path)
                best_model = MultimodalFusionModel.from_config(best_cfg or cfg, device=self.device)
                best_model.load_state_dict(weights)
            test_data = DeviceSplit.from_windows(test_windows, device=self.device)
            test_logits = self.evaluate_logits(test_data, model=best_model)
            test_labels = np.asarray(test_windows.labels)
            results["test_acc"] = float((test_logits.argmax(-1) == test_labels).mean())
            if log_fn:
                log_fn(f"test/acc={results['test_acc']:.4f}")

        results["history"] = history
        results["train_wall_seconds"] = wall
        (save_dir / "results.json").write_text(json.dumps(results, indent=2))
        if writer is not None:
            writer.close()
        return results
