"""PyTorch port, the parallel layouts in a real ``torch.distributed`` world on
the CPU: one module-scoped gloo world of 4 ranks (a ``FileStore`` under
``tmp_path``; each rank one process on one torch thread, this file run as a
script) runs every case once and saves what it computed; the tests hold it to
the JAX package on the conftest's host devices and to the one-process port:

- ``tp_fused_mlp`` (data 2 x model 2) against the reference's
  ``tp_fused_mlp`` in interpret mode, forward and gradients, with and
  without a global keep mask;
- the MoE feed-forward under expert parallelism (data 2 x model 2, a
  capacity that drops tokens) against the reference's MoE under
  ``activation_mesh``: outputs, aux loss and gradients;
- ``PipelinedTransformerLayers`` at 2 stages (data 2 x pipe 2) on converted
  ``pipe_layers`` against the reference's, and off the mesh;
- the four layouts of the card's ``[parallel]`` phase at a tiny width, and
  plain data parallelism over 4 ranks with two CNN encoders (BatchNorm over
  the global batch),
  8 micro-steps at dropout 0, against the one-process port from the same
  weights at the start of each accumulation window: losses and the gradient
  the optimizer sees at each of the 2 updates; leg (b) twice at the config's
  dropout, bit for bit;
- a 2-process ``Trainer.fit`` through ``parallel.coordinator_address`` (a
  free ``tcp://`` port): one ``results.json``, and a checkpoint that a
  one-process port reloads.

A world that does not finish within ``JOIN_TIMEOUT`` seconds is killed and
the tests fail."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

JOIN_TIMEOUT = 180
WORLD = 4
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
# a tiny flagship: hidden 16, FFW 2048 (the encoder layer's own), T 24, no
# randomness in the parity runs (dropout and the augmentations off)
TINY = ["model.hidden_dim=16", "model.output_dim=8", "dataset.batch_size=8",
        "training.gradient_accumulation=4", "training.dropout_rng=xla"]
QUIET = ["model.dropout=0.0", "training.augmentation.temporal_jitter=0.0",
         "training.augmentation.gaussian_noise=0.0", "training.augmentation.modality_dropout=0.0"]
LEGS = {
    "a": ["parallel.dcn_slices=2", "parallel.zero_optimizer=true"],
    "b": ["parallel.model_parallel=2", "parallel.sequence_parallel=true",
          "parallel.zero_optimizer=true"],
    "c": ["parallel.model_parallel=2", "parallel.sequence_parallel=true",
          "parallel.zero_optimizer=true", "model.moe_experts=4", "model.moe_top_k=2"],
    "d": ["parallel.pipeline_parallel=2", "parallel.microbatches=2"]
    + [f"model.encoders.{m}.num_layers=2" for m in NAMES],
}
# (e) plain data parallelism over 4 ranks with two CNN encoders: BatchNorm's
# statistics are the global batch's (a synchronised BatchNorm)
CNN = ["model.encoders.imu_hand.encoder_type=cnn", "model.encoders.imu_chest.encoder_type=cnn"]
LEGS["e"] = CNN
MODEL_KEYS = {"a": [], "b": [], "c": ["model.moe_experts=4", "model.moe_top_k=2"],
              "d": LEGS["d"], "e": CNN}
STEPS = 8


# ---- inputs, made alike in the world and here ---------------------------------------


def _windows(seed=5, n=16, t=12):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        WindowedSplit,
    )

    rng = np.random.default_rng(seed)
    feats = {m: rng.standard_normal((n, t, d)).astype(np.float32) for m, d in zip(NAMES, DIMS)}
    return WindowedSplit(features=feats, labels=rng.integers(0, 25, n).astype(np.int32),
                         lengths=rng.integers(1, t + 1, n).astype(np.int32),
                         modalities=list(NAMES))


def _batches():
    return [torch.arange(8) + 8 * (i % 2) for i in range(STEPS)]


def _cfg(overrides):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import (
        load_config,
    )

    return load_config(REPO / "config" / "base.yaml", overrides)


def _record_updates(trainer, grads, weights):
    """Wrap the optimizer's update so that it first keeps the gradient it
    is about to apply, whole (the pieces gathered on a mesh), and then the
    whole weights it gave."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.mesh import (
        gather_full,
    )

    opt = trainer.optimizer
    names = [k for k, _ in trainer.model.named_parameters()]
    apply = opt.apply

    def recording():
        grads.append({k: (a if trainer.mesh is None else
                          gather_full(a, trainer.specs[k][1], trainer.mesh)).clone()
                      for k, a in zip(names, opt.acc)})
        apply()
        weights.append({k: v.clone() for k, v in trainer.state_dict().items()})

    opt.apply = recording


def run_leg(overrides, model=None, steps=STEPS, windows=None):
    """``steps`` micro-steps on the global batches -> (losses, the gradient
    at each update, the weights each accumulation window started from, the
    trainer).
    ``windows``: the weights to start each window from (another run's), so
    that the gradients compare at the same weights: a gradient that is zero
    up to rounding (the key-projection biases') moves Adam's update by up to
    the learning rate either way, and the second window would start apart."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt

    trainer = tt.Trainer(_cfg(overrides), model=model, device="cpu")
    trainer.init_state(steps_per_epoch=2)
    grads, weights = [], [{k: v.clone() for k, v in trainer.state_dict().items()}]
    _record_updates(trainer, grads, weights)
    step = trainer.make_train_step_fn()
    split = DeviceSplit.from_windows(_windows(), device="cpu")
    losses = []
    for i, idx in enumerate(_batches()[:steps]):
        if windows is not None and i % trainer.accum == 0:
            trainer.load_state_dict(windows[i // trainer.accum])
        losses.append(step(split, idx)[0].item())
    return losses, grads, weights[:-1], trainer


def _tp_inputs(masked):
    rng = np.random.default_rng(11)
    n, d, f = 8, 16, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / 4).astype(np.float32)
    b1 = (rng.standard_normal(f) / 4).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / 8).astype(np.float32)
    b2 = (rng.standard_normal(d) / 4).astype(np.float32)
    g = rng.standard_normal((n, d)).astype(np.float32)
    mask = (rng.random((n, f)) < 0.8).astype(np.uint8) if masked else None
    return x, w1, b1, w2, b2, g, mask


def _moe_inputs():
    rng = np.random.default_rng(12)
    b, t, h, f, e = 4, 6, 16, 32, 4
    params = {
        "router": rng.uniform(-h**-0.5, h**-0.5, (h, e)).astype(np.float32),
        "moe_w1": rng.uniform(-h**-0.5, h**-0.5, (e, h, f)).astype(np.float32),
        "moe_b1": rng.uniform(-h**-0.5, h**-0.5, (e, f)).astype(np.float32),
        "moe_w2": rng.uniform(-f**-0.5, f**-0.5, (e, f, h)).astype(np.float32),
        "moe_b2": rng.uniform(-f**-0.5, f**-0.5, (e, h)).astype(np.float32),
    }
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    valid = np.ones((b, t), np.float32)
    valid[1, 4:] = 0
    valid[3, 2:] = 0
    g = rng.standard_normal((b, t, h)).astype(np.float32)
    return params, x, valid, g


def _pipe_inputs():
    rng = np.random.default_rng(13)
    L, h, f, b, t = 2, 16, 32, 8, 6

    def dense(i, o):
        return {"kernel": (rng.standard_normal((L, i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (rng.standard_normal((L, o)) / 8).astype(np.float32)}

    tree = {"q_proj": dense(h, h), "k_proj": dense(h, h), "v_proj": dense(h, h),
            "out_proj": dense(h, h), "linear1": dense(h, f), "linear2": dense(f, h),
            "norm1": {"scale": (1 + rng.standard_normal((L, h)) / 8).astype(np.float32),
                      "bias": (rng.standard_normal((L, h)) / 8).astype(np.float32)},
            "norm2": {"scale": (1 + rng.standard_normal((L, h)) / 8).astype(np.float32),
                      "bias": (rng.standard_normal((L, h)) / 8).astype(np.float32)}}
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    lengths = np.array([6, 3, 6, 1, 5, 6, 2, 6])
    valid = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    g = rng.standard_normal((b, t, h)).astype(np.float32)
    return tree, x, valid, g


def _pipe_module(tree):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.pipeline import (
        PipelinedTransformerLayers,
    )

    module = PipelinedTransformerLayers(16, 4, 2, dim_feedforward=32, dropout=0.0,
                                        pipeline_parallel=2, microbatches=2)
    with torch.no_grad():
        for name, leaves in tree.items():
            for leaf, value in leaves.items():
                module.pipe_layers[name][leaf].copy_(torch.from_numpy(value))
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread here too (the ranks run on one each),
    the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the world ----------------------------------------------------------------------------


def _worker(rank: int, store: str, out: Path) -> None:
    import torch.distributed as dist

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.moe import (
        MoEFeedForward,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import comm
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.mesh import (
        activation_mesh,
        local_slice,
        make_mesh,
        shard_batch,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.tp_kernels import (
        tp_fused_mlp,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    results = {}

    # tp_fused_mlp, data 2 x model 2
    mesh = make_mesh(WORLD, model_parallel=2).init_groups()
    for masked in (False, True):
        x, w1, b1, w2, b2, g, mask = (None if a is None else torch.from_numpy(a)
                                      for a in _tp_inputs(masked))
        x, g = shard_batch((x, g), mesh)
        mask = None if mask is None else shard_batch(mask, mesh)
        x.requires_grad_(True)
        shards = [local_slice(w1, (None, "model"), mesh), local_slice(b1, ("model",), mesh),
                  local_slice(w2, ("model", None), mesh), b2]
        shards = [s.clone().requires_grad_(True) for s in shards]
        with activation_mesh(mesh):
            ff = tp_fused_mlp(mesh, x, *shards, keep_mask=mask, keep_prob=0.8)
        (ff * g).sum().backward()
        grads = [comm.all_reduce(s.grad.clone(), mesh.group("data")) for s in shards]
        results[f"tp_{masked}"] = {"out": ff.detach(), "dx": x.grad, "grads": grads,
                                   "coords": mesh.coords()}

    # MoE under expert parallelism, data 2 x model 2
    params, x, valid, g = _moe_inputs()
    moe = MoEFeedForward(16, 32, 4, 2, capacity_factor=0.5, dropout=0.0)
    with torch.no_grad():
        for k, v in params.items():
            full = torch.from_numpy(v)
            getattr(moe, k).data = (local_slice(full, ("model",), mesh).clone()
                                    if k != "router" else full.clone())
    x, valid, g = shard_batch(tuple(torch.from_numpy(a) for a in (x, valid, g)), mesh)
    with activation_mesh(mesh):
        y, aux = moe(x, valid_mask=valid)
    ((y * g).sum() + aux).backward()
    results["moe"] = {
        "y": y.detach(), "aux": aux.detach(), "coords": mesh.coords(),
        "grads": {k: comm.all_reduce(getattr(moe, k).grad.clone(), mesh.group("data"))
                  for k in params}}

    # the pipeline, data 2 x pipe 2
    pmesh = make_mesh(WORLD, pipeline_parallel=2).init_groups()
    tree, x, valid, g = _pipe_inputs()
    module = _pipe_module(tree)
    with torch.no_grad():
        for p in module.parameters():
            p.data = local_slice(p.data, ("pipe",), pmesh).clone()
    x, valid, g = shard_batch(tuple(torch.from_numpy(a) for a in (x, valid, g)), pmesh)
    x.requires_grad_(True)
    with activation_mesh(pmesh):
        y = module(x, key_padding_mask=valid, train=True)
    (y * g).sum().backward()
    results["pipe"] = {
        "y": y.detach(), "dx": x.grad, "coords": pmesh.coords(),
        "grads": {f"{n}.{leaf}": comm.all_reduce(module.pipe_layers[n][leaf].grad.clone(),
                                                 pmesh.group("data"))
                  for n in module.pipe_layers for leaf in module.pipe_layers[n]}}

    # the four layouts, 8 micro-steps at dropout 0
    for leg, extra in LEGS.items():
        losses, grads, weights, _ = run_leg(TINY + QUIET + ["parallel.num_devices=4"] + extra)
        results[f"leg_{leg}"] = {"losses": losses, "grads": grads, "weights": weights}
    # a resume's state on leg (b)'s layout: gathered whole, put back in pieces
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt

    first = run_leg(TINY + QUIET + ["parallel.num_devices=4"] + LEGS["b"], steps=6)[3]
    state = first.train_state()
    again = tt.Trainer(_cfg(TINY + QUIET + ["parallel.num_devices=4"] + LEGS["b"]), device="cpu")
    again.init_state(steps_per_epoch=2)
    again.load_state_dict(first.state_dict())
    again.load_train_state(state)
    results["resume"] = {
        "state": state,
        "same": all(torch.equal(a, b) for name in ("acc", "mu", "nu")
                    for a, b in zip(getattr(first.optimizer, name),
                                    getattr(again.optimizer, name))),
        "generator": torch.equal(first.generator.get_state(), again.generator.get_state()),
        "mini_step": again.optimizer.mini_step}
    # leg (b) at the config's dropout and augmentations, twice
    results["repeat_b"] = [
        run_leg(TINY + ["parallel.num_devices=4"] + LEGS["b"], steps=4)[0] for _ in range(2)]
    torch.save(results, out / f"rank{rank}.pt")
    dist.destroy_process_group()


def _fit_worker(rank: int, port: int, save_dir: Path) -> None:
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt

    torch.set_num_threads(1)
    cfg = _cfg(TINY + ["training.max_epochs=1", f"experiment.save_dir={save_dir}",
                       "experiment.name=fit", "parallel.num_devices=2",
                       "parallel.zero_optimizer=true",
                       f"parallel.coordinator_address=localhost:{port}",
                       "parallel.num_processes=2", f"parallel.process_id={rank}"])
    trainer = tt.Trainer(cfg, device="cpu")
    results = trainer.fit(_windows(5), _windows(6, n=8), _windows(7, n=8),
                          save_dir=save_dir / "fit")
    (save_dir / f"rank{rank}.json").write_text(json.dumps(
        {"best_val_loss": results["best_val_loss"], "test_acc": results["test_acc"]}))


def _spawn(args_per_rank, tmp: Path):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, *map(str, args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO))
             for args in args_per_rank]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT)
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the world did not finish within {JOIN_TIMEOUT} s")
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            pytest.fail(f"a rank failed (rc {p.returncode}):\n{log[-4000:]}")
    return logs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    _spawn([("world", r, tmp / "store", tmp) for r in range(WORLD)], tmp)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---- parity helpers -------------------------------------------------------------------------


def _rows(results, key, field, axis="data", parts=2):
    """A per-data-rank field stitched back along the batch, one rank per data index."""
    by_index = {}
    for r in results:
        by_index.setdefault(r[key]["coords"][axis], r[key][field])
    return torch.cat([by_index[i] for i in range(parts)]).numpy()


def assert_grads_close(got, want, what):
    """Norm-wise <= 1e-5 over all leaves, and each leaf's max-abs error, over
    its largest entry floored at 1e-3 of the largest entry of any leaf, <= 1e-4."""
    keys = sorted(want)
    assert sorted(got) == keys, what
    top = max(float(np.abs(want[k]).max()) for k in keys)
    diff = np.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys))
    norm = np.sqrt(sum(float((want[k] ** 2).sum()) for k in keys))
    assert diff <= 1e-5 * norm, f"{what}: gradient norm-wise error {diff / norm:.3e}"
    for k in keys:
        scale = max(float(np.abs(want[k]).max()), 1e-3 * top)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= 1e-4, f"{what}: {k} error {err:.3e} of its scale"


# ---- tests -----------------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "global_mask"])
def test_tp_fused_mlp_matches_the_reference(world, masked):
    import jax
    import jax.numpy as jnp

    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel.tp_kernels import (
        tp_fused_mlp as jtp,
    )

    x, w1, b1, w2, b2, g, mask = _tp_inputs(masked)
    jmesh = jmake_mesh(4, model_parallel=2)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(x, w1, b1, w2, b2):
        out = jtp(jmesh, x, w1, b1, w2, b2, jmask, 0.8, interpret=True)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))
    key = f"tp_{masked}"
    np.testing.assert_allclose(_rows(world, key, "out"), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_rows(world, key, "dx"), np.asarray(grads[0]), rtol=1e-5,
                               atol=1e-5)
    shards = {}
    for r in world:
        shards.setdefault(r[key]["coords"]["model"], r[key]["grads"])
    got = {"w1": np.concatenate([shards[i][0].numpy() for i in range(2)], axis=1),
           "b1": np.concatenate([shards[i][1].numpy() for i in range(2)]),
           "w2": np.concatenate([shards[i][2].numpy() for i in range(2)]),
           "b2": shards[0][3].numpy()}
    want = dict(zip(("w1", "b1", "w2", "b2"), (np.asarray(a) for a in grads[1:])))
    # the weight gradients came back sharded like the weights
    assert shards[0][0].shape == (16, 32) and shards[0][2].shape == (32, 16)
    assert_grads_close(got, want, "tp_fused_mlp")


def test_moe_under_expert_parallelism_matches_the_reference(world):
    import jax
    import jax.numpy as jnp

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.moe import (
        MoEFeedForward,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.moe import (
        MoEFeedForward as JMoE,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel.mesh import (
        activation_mesh as jactivation_mesh,
        make_mesh as jmake_mesh,
    )

    params, x, valid, g = _moe_inputs()
    jmoe = JMoE(hidden_dim=16, dim_feedforward=32, num_experts=4, top_k=2,
                capacity_factor=0.5, dropout=0.0)
    jmesh = jmake_mesh(4, model_parallel=2)

    def loss(p):
        y, state = jmoe.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid),
                              mutable=["losses"])
        aux = state["losses"]["moe_aux"]
        return jnp.sum(y * g) + aux, (y, aux)

    with jactivation_mesh(jmesh):
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()})
    # the capacity drops (token, slot)s of rank 1's rows: where they land
    # depends on rank 0's counts
    one = MoEFeedForward(16, 32, 4, 2, capacity_factor=0.5, dropout=0.0)
    with torch.no_grad():
        one.router.copy_(torch.from_numpy(params["router"]))
    keep = one.route(torch.from_numpy(x).reshape(-1, 16),
                     torch.from_numpy(valid).reshape(-1) > 0)[4]
    live = torch.from_numpy(valid).reshape(-1, 1) > 0
    assert bool((~keep & live)[12:].any()), "no drop on the second data rank's rows"
    np.testing.assert_allclose(_rows(world, "moe", "y"), np.asarray(y), rtol=1e-5, atol=1e-6)
    for r in world:
        assert abs(r["moe"]["aux"].item() - float(aux)) <= 1e-6 * abs(float(aux))
    experts = {}
    for r in world:
        experts.setdefault(r["moe"]["coords"]["model"], r["moe"]["grads"])
    got = {k: (experts[0][k].numpy() if k == "router" else
               np.concatenate([experts[i][k].numpy() for i in range(2)]))
           for k in params}
    assert_grads_close(got, {k: np.asarray(v) for k, v in grads.items()}, "MoE under EP")


def _jax_pipeline(on_mesh):
    import jax
    import jax.numpy as jnp

    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel.mesh import (
        activation_mesh as jactivation_mesh,
        make_mesh as jmake_mesh,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel.pipeline import (
        PipelinedTransformerLayers as JPipe,
    )

    tree, x, valid, g = _pipe_inputs()
    jpipe = JPipe(hidden_dim=16, num_heads=4, num_layers=2, dim_feedforward=32, dropout=0.0,
                  pipeline_parallel=2, microbatches=2)

    def loss(p, x):
        y = jpipe.apply({"params": {"pipe_layers": p}}, x, jnp.asarray(valid), train=True)
        return jnp.sum(y * g), y

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    args = (jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    if on_mesh:
        with jactivation_mesh(jmake_mesh(4, pipeline_parallel=2)):
            (_, y), (gp, gx) = jax.jit(fn)(*args)
    else:
        (_, y), (gp, gx) = jax.jit(fn)(*args)
    flat = {f"{n}.{leaf}": np.asarray(v) for n, leaves in gp.items() for leaf, v in leaves.items()}
    return np.asarray(y), np.asarray(gx), flat


def test_pipeline_at_two_stages_matches_the_reference(world):
    y, gx, want = _jax_pipeline(on_mesh=True)
    np.testing.assert_allclose(_rows(world, "pipe", "y"), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_rows(world, "pipe", "dx"), gx, rtol=1e-5, atol=1e-5)
    stages = {}
    for r in world:
        stages.setdefault(r["pipe"]["coords"]["pipe"], r["pipe"]["grads"])
    got = {k: np.concatenate([stages[i][k].numpy() for i in range(2)]) for k in want}
    # each stage held, and got the gradient of, its own layer
    assert stages[0]["linear1.kernel"].shape == (1, 16, 32)
    assert_grads_close(got, want, "pipeline on 2 stages")
    # every pipe rank of a data rank holds the same output and input gradient
    for a in world:
        for b in world:
            if a["pipe"]["coords"]["data"] == b["pipe"]["coords"]["data"]:
                assert torch.equal(a["pipe"]["y"], b["pipe"]["y"])
                assert torch.equal(a["pipe"]["dx"], b["pipe"]["dx"])


def test_pipeline_off_the_mesh_matches_the_reference():
    y, gx, want = _jax_pipeline(on_mesh=False)
    tree, x, valid, g = _pipe_inputs()
    module = _pipe_module(tree)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt, key_padding_mask=torch.from_numpy(valid), train=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-5, atol=1e-5)
    got = {f"{n}.{leaf}": module.pipe_layers[n][leaf].grad.numpy()
           for n in module.pipe_layers for leaf in module.pipe_layers[n]}
    assert_grads_close(got, want, "pipeline off the mesh")


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_layout_matches_one_process(world, leg):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )

    got = world[0][f"leg_{leg}"]
    model = MultimodalFusionModel.from_config(_cfg(TINY + QUIET + MODEL_KEYS[leg]), device="cpu")
    # the same seed builds the same weights
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["weights"][0][k]), k
    losses, grads, weights, _ = run_leg(TINY + QUIET + [k for k in MODEL_KEYS[leg]
                                                     if not k.startswith("parallel.")],
                                        model=model, windows=got["weights"])
    assert len(got["grads"]) == len(grads) == 2
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        assert_grads_close({k: v.numpy() for k, v in g.items()},
                           {k: v.numpy() for k, v in w.items()}, f"leg ({leg}) update {i}")
    # every rank reports the global loss
    for r in world[1:]:
        np.testing.assert_allclose(r[f"leg_{leg}"]["losses"], got["losses"], rtol=1e-6)
    if leg == "e":  # the running statistics moved alike on every rank and in one process
        for k, v in got["weights"][1].items():
            if k.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(v, weights[1][k], rtol=1e-5, atol=1e-6)


def test_a_resume_state_is_whole_and_goes_back_into_pieces(world):
    """``train_state`` on leg (b)'s layout (ZeRO pieces over data, the FFW
    shards over model) gathers the one-process format; a Trainer of the same
    layout puts it back, piece for piece; a one-process Trainer takes it."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt

    for r in world:
        assert r["resume"]["same"] and r["resume"]["generator"]
        assert r["resume"]["mini_step"] == 2  # 6 micro-steps: one update, 2 of the next window
    state = world[0]["resume"]["state"]
    assert len(state["generators"]) == WORLD
    assert all(torch.equal(state["generators"][i], world[i]["resume"]["state"]["generators"][i])
               for i in range(WORLD))
    model = MultimodalFusionModel.from_config(_cfg(TINY + QUIET), device="cpu")
    one = tt.Trainer(_cfg(TINY + QUIET), model=model, device="cpu")
    one.init_state(steps_per_epoch=2)
    for name in ("acc", "mu", "nu"):  # whole: the one-process shapes
        assert [t.shape for t in state["optimizer"][name]] == [p.shape for p in model.parameters()]
    one.load_train_state(state)
    assert one.optimizer.count == 1 and one.optimizer.mini_step == 2
    assert torch.count_nonzero(one.optimizer.mu[0]) > 0


def test_layout_with_dropout_repeats_bit_for_bit(world):
    first, second = world[0]["repeat_b"]
    assert first == second and np.all(np.isfinite(first))
    # dropout and the augmentations are on: the losses are not the parity run's
    assert first != world[0]["leg_b"]["losses"][:4]


def test_two_process_fit_writes_one_result_and_a_loadable_checkpoint(tmp_path):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
        cross_entropy_loss,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )

    port = _free_port()
    _spawn([("fit", r, port, tmp_path) for r in range(2)], tmp_path)
    run = tmp_path / "fit"
    results = json.loads((run / "results.json").read_text())
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == ranks[1]  # both ranks computed the same results
    assert sorted(p.name for p in (run / "checkpoints").iterdir())[-1] == "last"
    assert not list(run.glob("rank*"))  # nothing per rank in the run directory
    weights, cfg, meta = load_checkpoint(results["best_model_path"])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    model.load_state_dict(weights)  # the whole tree: a one-process model takes it as it is
    val = DeviceSplit.from_windows(_windows(6, n=8), device="cpu")
    trainer = tt.Trainer(_cfg(TINY), model=model, device="cpu")
    logits = torch.from_numpy(trainer.evaluate_logits(val))
    val_loss = float(cross_entropy_loss(logits, val.labels.long(), 0.05))
    assert val_loss == pytest.approx(results["best_val_loss"], rel=1e-5)
    assert meta["epoch"] == 0


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "world":
        _worker(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
    else:
        _fit_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
