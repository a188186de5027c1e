"""PyTorch port, trainer: the schedule, the optimizer (clip + AdamW behind
gradient accumulation) against optax, the augmentations against the JAX
``Trainer``'s on the same random draws, the dropout masks' keep rate, the
errors for what is not ported, a few CPU micro-steps end to end, and
``training.remat`` against the same steps without it, bit for bit."""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.train import trainer as jtrainer
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import WindowedSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as te
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
SMALL = ["model.hidden_dim=32", "model.output_dim=16"]
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)


@pytest.mark.parametrize("scheduler", ["cosine", "step", "none"])
def test_lr_schedule_matches_jax(scheduler):
    want = jtrainer.lr_schedule(scheduler, 1e-3, 100, 3)
    got = tt.lr_schedule(scheduler, 1e-3, 100, 3)
    # the JAX schedule runs in f32: agreement to f32 rounding of the learning
    # rate (the cosine near cos(pi) = -1 cancels, so absolute, not relative)
    for count in (0, 1, 2, 3, 4, 89, 90, 150, 299, 300, 301, 350):  # past max_epochs: clipped
        assert got(count) == pytest.approx(float(want(jnp.asarray(count))), rel=1e-6, abs=1e-9)


def _training_cfg(optimizer="adamw"):
    return {"optimizer": optimizer, "learning_rate": 1e-3, "weight_decay": 1e-4,
            "gradient_clip_norm": 1.0, "gradient_accumulation": 4, "max_epochs": 3,
            "scheduler": "cosine"}


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_matches_optax_over_eight_micro_steps(optimizer):
    """8 micro-steps = 2 updates at accumulation 4; the gradients of the
    first update are large enough to be clipped, those of the second not.
    With 4 steps per epoch there is one update per epoch, so the cosine
    schedule moves between the two updates."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,), "scale": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (3.0 if i < 4 else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for i in range(8)]

    tx, accum = jtrainer.build_optimizer(_training_cfg(optimizer), steps_per_epoch=4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    names = sorted(shapes)
    tparams = [torch.from_numpy(params[k].copy()) for k in names]
    opt, t_accum = tt.build_optimizer(_training_cfg(optimizer), tparams, steps_per_epoch=4)
    assert (accum, t_accum) == (4, 4)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([torch.from_numpy(g[k]) for k in names])
        assert applied == (i % 4 == 3)
        for k, p in zip(names, tparams):
            # f32 both sides; Adam's first steps divide by sqrt(nu) ~ |g|
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after micro-step {i}")
    assert opt.count == 2
    assert not np.allclose(tparams[0].numpy(), params[names[0]])


def test_build_optimizer_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="Unknown optimizer: sgd"):
        tt.build_optimizer({"optimizer": "sgd"}, [torch.zeros(2)], 10)


def _features(rng, batch=4):
    return {
        "imu_hand": rng.standard_normal((batch, 40, 17)).astype(np.float32),  # row gather path
        "heart_rate": rng.standard_normal((batch, 40, 1)).astype(np.float32),  # narrow path
        "audio": rng.standard_normal((batch, 20, 9)).astype(np.float32),  # another rate
    }


@pytest.mark.parametrize("jitter", [0.1, 0.6, 0.01])
def test_temporal_jitter_matches_jax(jitter):
    rng = np.random.default_rng(1)
    feats = _features(rng)
    lengths = np.array([40, 3, 17, 1], np.int32)
    key = jax.random.PRNGKey(5)
    want_f, want_l = jtrainer.Trainer._apply_temporal_jitter(
        SimpleNamespace(temporal_jitter=jitter), key,
        {m: jnp.asarray(v) for m, v in feats.items()}, jnp.asarray(lengths))
    uniform = np.array(jax.random.uniform(key, (4,)))  # the JAX function's own draw
    got_f, got_l = tt.apply_temporal_jitter(
        {m: torch.from_numpy(v) for m, v in feats.items()}, torch.from_numpy(lengths),
        torch.from_numpy(uniform), jitter)
    for m in feats:
        np.testing.assert_array_equal(got_f[m].numpy(), np.asarray(want_f[m]))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if jitter == 0.01:  # int(0.01 * 40) == 0: nothing moves
        np.testing.assert_array_equal(got_f["imu_hand"].numpy(), feats["imu_hand"])
        np.testing.assert_array_equal(got_l.numpy(), lengths)


def test_gaussian_noise_matches_jax_formula():
    rng = np.random.default_rng(2)
    feats = _features(rng)
    key = jax.random.PRNGKey(6)
    noise = {m: np.array(jax.random.normal(jax.random.fold_in(key, i), v.shape, jnp.float32))
             for i, (m, v) in enumerate(feats.items())}
    want = {m: np.asarray(jnp.asarray(v) + 0.1 * noise[m]) for m, v in feats.items()}
    got = tt.add_gaussian_noise({m: torch.from_numpy(v) for m, v in feats.items()},
                                {m: torch.from_numpy(z) for m, z in noise.items()}, 0.1)
    for m in feats:
        np.testing.assert_array_equal(got[m].numpy(), want[m])


@pytest.mark.parametrize("rate", [0.6, 0.2, 0.0])
def test_modality_dropout_matches_jax(rate):
    key = jax.random.PRNGKey(7)
    batch, num_mod = 64, 4
    want = np.asarray(jtrainer.Trainer._dropout_modality_mask(
        SimpleNamespace(modality_dropout=rate), key, batch, num_mod))
    keep_key, revive_key = jax.random.split(key)  # the JAX function's own draws
    uniform = np.array(jax.random.uniform(keep_key, (batch, num_mod)))
    revive = np.array(jax.random.randint(revive_key, (batch,), 0, num_mod))
    got = tt.dropout_modality_mask(torch.from_numpy(uniform), torch.from_numpy(revive), rate)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy().sum(1) >= 1)  # never all dropped
    if rate == 0.6:
        assert np.any((uniform > rate).sum(1) == 0)  # the revive branch ran


def test_dropout_masks_keep_rate_within_three_sigma():
    g = torch.Generator().manual_seed(3)
    keep = 0.8
    mask = te.keep_mask((64, 512, 32), keep, g, "cpu")
    n = mask.numel()
    assert abs(mask.float().mean().item() - keep) < 3 * (keep * (1 - keep) / n) ** 0.5
    x = torch.ones(1000, 100)
    out = te.dropout(x, 0.2, True, torch.Generator().manual_seed(4))
    assert set(out.unique().tolist()) <= {0.0, 1.25}
    assert te.dropout(x, 0.2, False, None) is x
    assert torch.all(te.dropout(x, 1.0, True, None) == 0)


def test_unported_training_routes_raise():
    """The two training routes that used to raise are ported: ``dropout_rng``
    resolves as in the reference (the generator kernel only on the card with a
    kernel flag on, plain draws elsewhere), and ``fused_mlp`` without
    ``fused_mlp_ln`` trains through ``transformer_ffw``. What still raises is
    an unknown value. An lstm model trains at ``model.pallas_rnn`` on (the
    training kernels' route) and off (the plain loop) to the same output."""
    assert te.resolve_dropout_rng("xla", "cuda") == "xla"
    for value in ("auto", "kernel", "AUTO", None):
        assert te.resolve_dropout_rng(value, "cpu") == "xla"  # off the card: plain draws
        assert te.resolve_dropout_rng(value, "cuda") == "kernel"
        assert te.resolve_dropout_rng(value, "cuda", kernels_on=False) == "xla"
    with pytest.raises(ValueError, match="Unknown training.dropout_rng"):
        te.resolve_dropout_rng("philox", "cuda")
    rng = np.random.default_rng(4)
    feats = {n: torch.from_numpy(rng.standard_normal((2, 8, d)).astype(np.float32))
             for n, d in zip(NAMES, DIMS)}
    outs = {}
    for value in ("kernel", "xla"):  # on the CPU both mean the generator's plain draws
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + [f"training.dropout_rng={value}"])
        model = MultimodalFusionModel.from_config(cfg, device="cpu")
        model(feats)  # eval draws no mask
        outs[value] = model(feats, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(outs["kernel"], outs["xla"])
    for ln in ("false", "true"):
        cfg = load_config(REPO / "config" / "base.yaml",
                          SMALL + ["model.fused_mlp=true", f"model.fused_mlp_ln={ln}"])
        model = MultimodalFusionModel.from_config(cfg, device="cpu")
        model(feats)  # eval takes the plain FFW, as in the reference
        outs[ln] = model(feats, train=True, generator=torch.Generator().manual_seed(1))
    # same weights, same draws: the split and the combined route agree (f32 rounding)
    torch.testing.assert_close(outs["false"], outs["true"], rtol=1e-5, atol=1e-5)
    lstm = [f"model.encoders.{n}.{k}" for n in NAMES for k in ("encoder_type=lstm", "num_layers=1")]
    trained = {}
    for flag in ("true", "false"):
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + lstm + [f"model.pallas_rnn={flag}"])
        model = MultimodalFusionModel.from_config(cfg, device="cpu")
        assert model(feats).shape == (2, 25)  # eval runs either way
        trained[flag] = model(feats, train=True, generator=torch.Generator().manual_seed(1))
        assert trained[flag].requires_grad  # and so does training: kernels' twins or the loop
    torch.testing.assert_close(trained["true"], trained["false"], rtol=1e-5, atol=1e-6)


def _split(seed=5, n=16, t=24):
    rng = np.random.default_rng(seed)
    feats = {m: rng.standard_normal((n, t, d)).astype(np.float32) for m, d in zip(NAMES, DIMS)}
    windows = WindowedSplit(
        features=feats, labels=rng.integers(0, 25, n).astype(np.int32),
        lengths=rng.integers(1, t + 1, n).astype(np.int32), modalities=list(NAMES))
    return DeviceSplit.from_windows(windows, device="cpu")


def test_trainer_micro_steps_on_cpu_kernel_and_plain_paths_agree():
    split = _split()
    runs = {}
    for path, flag in (("kernels", "true"), ("plain", "false")):
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + [
            f"model.flash_attention={flag}", f"model.fused_mlp={flag}",
            f"model.fused_mlp_ln={flag}", "training.dropout_rng=xla"])
        trainer = tt.Trainer(cfg, device="cpu")
        trainer.init_state(steps_per_epoch=2)
        step = trainer.make_train_step_fn()
        before = [p.detach().clone() for p in trainer.model.parameters()]
        losses = []
        for i in range(8):
            loss, acc = step(split, torch.arange(8) + 8 * (i % 2))
            losses.append(loss.item())
            assert 0.0 <= acc.item() <= 1.0
            moved = any(not torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
            assert moved == (i >= 3)  # the first update lands on the 4th micro-step
        assert trainer.optimizer.count == 2 and np.all(np.isfinite(losses))
        runs[path] = losses
    # same seed, same draws (augmentations and dropout masks): same losses
    np.testing.assert_allclose(runs["kernels"], runs["plain"], rtol=1e-5)


def test_make_train_step_fn_needs_init_state():
    cfg = load_config(REPO / "config" / "base.yaml", SMALL)
    with pytest.raises(RuntimeError, match="init_state"):
        tt.Trainer(cfg, device="cpu").make_train_step_fn()


REMAT_ROUTES = {
    "plain": ["model.flash_attention=false", "model.fused_mlp=false", "model.fused_mlp_ln=false"],
    "kernels": ["model.flash_attention=true", "model.fused_mlp=true", "model.fused_mlp_ln=true"],
    "cnn": ["model.encoders.imu_chest.encoder_type=cnn", "model.encoders.imu_ankle.encoder_type=cnn"],
    "moe": ["model.moe_experts=4"],
}


@pytest.mark.parametrize("route", sorted(REMAT_ROUTES))
def test_remat_repeats_the_micro_steps_bit_for_bit(route):
    """Two micro-steps at dropout 0.2 (every augmentation on) with and
    without ``training.remat``: the losses, every gradient, the BatchNorm
    running statistics and the generator's state after them bit for bit. The
    recompute draws the forward's masks again from the generator's state
    before the forward (plain draws, and the MoE experts' own), custom
    autograd Functions (the kernels' twins) recompute their saved tensors,
    the BatchNorm statistics move once a micro-step, and the MoE aux loss is
    an output of the recomputed function."""
    split = _split()
    runs = {}
    for remat in ("false", "true"):
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + REMAT_ROUTES[route] + [
            "model.dropout=0.2", f"training.remat={remat}"])
        trainer = tt.Trainer(cfg, device="cpu")
        assert trainer.remat is (remat == "true")
        init = {k: v.clone() for k, v in trainer.model.named_buffers()}
        steps = []
        for i in range(2):
            features, labels, lengths = split.gather(torch.arange(8) + 8 * i)
            features, lengths, mask = trainer.augment(features, lengths, len(NAMES))
            loss, _acc, grads = trainer.loss_and_grads(features, labels, mask, lengths,
                                                       torch.ones(labels.shape))
            steps.append((loss, [g.clone() for g in grads]))
        buffers = dict(trainer.model.named_buffers())
        if route == "cnn":
            assert buffers and all(not torch.equal(buffers[k], init[k]) for k in init)
        runs[remat] = steps, buffers, trainer.generator.get_state()
    (a_steps, a_buf, a_gen), (b_steps, b_buf, b_gen) = runs["false"], runs["true"]
    for (loss_a, grads_a), (loss_b, grads_b) in zip(a_steps, b_steps):
        assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
        assert all(torch.equal(x, y) for x, y in zip(grads_a, grads_b))
    assert a_buf.keys() == b_buf.keys() and all(torch.equal(a_buf[k], b_buf[k]) for k in a_buf)
    assert torch.equal(a_gen, b_gen)
