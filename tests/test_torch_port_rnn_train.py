"""PyTorch port, the recurrences' training route: ``grouped_lstm_trainable``
and ``grouped_gru_trainable`` of ``ops/rnn.py`` against the JAX package's
functions of the same names (their Pallas forward and backward kernels in
interpret mode) and against autograd of ``rnn_scan``; the four plain kernel
twins against the reference's residuals and ``x_proj`` cotangent; the
MC-dropout entry point with the kernels on; and the configuration keys the
port refuses (``build_encoder``'s per-encoder keys, the trainer's
``parallel.*`` and ``training.remat``). Inputs come from seeded numpy; the
port runs on the CPU, where each kernel wrapper takes its plain version."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_rnn_train as jrt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import WindowedSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as te
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as trnn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.uncertainty import (
    mc_dropout_over_split,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
T, G, B, H = 22, 3, 5, 8  # B not a multiple of 8, T not one of the reference's block_t
LENGTHS = {"full": np.full((B,), T, np.int32), "ragged": np.array([0, 1, 13, 22, 7], np.int32),
           "none": None}
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)  # f32 both sides, 22 dependent steps
GRAD_TOL = 1e-4  # of each gradient's largest magnitude
CELLS = {"lstm": (4, jrt.grouped_lstm_trainable, trnn.grouped_lstm_trainable),
         "gru": (3, jrt.grouped_gru_trainable, trnn.grouped_gru_trainable)}


def _inputs(cell, seed):
    rng = np.random.default_rng(seed)
    gates = CELLS[cell][0]
    scale = H**-0.5
    x_proj = rng.standard_normal((T, G, B, gates * H)).astype(np.float32)
    w_hh = rng.uniform(-scale, scale, (G, H, gates * H)).astype(np.float32)
    b_hh = rng.uniform(-scale, scale, (G, gates * H)).astype(np.float32)
    dh = rng.standard_normal((G, B, H)).astype(np.float32)
    return x_proj, w_hh, b_hh, dh


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_trainable_recurrence_matches_jax_and_autograd(cell, kind):
    """Value and the gradients w.r.t. ``x_proj``, ``w_hh`` and ``b_hh`` under
    a random cotangent on ``h_T``."""
    _gates, jax_fn, torch_fn = CELLS[cell]
    x_proj, w_hh, b_hh, dh = _inputs(cell, seed=len(kind) + len(cell))
    lengths = LENGTHS[kind]
    jl = None if lengths is None else jnp.asarray(lengths)
    want, vjp = jax.vjp(lambda x, w, b: jax_fn(x, w, b, jl), *map(jnp.asarray, (x_proj, w_hh, b_hh)))
    want_grads = vjp(jnp.asarray(dh))

    tensors = [torch.from_numpy(a).requires_grad_() for a in (x_proj, w_hh, b_hh)]
    tl = None if lengths is None else torch.from_numpy(lengths)
    before = (trnn.lstm_train_fwd.launches, trnn.lstm_train_bwd.launches,
              trnn.gru_train_fwd.launches, trnn.gru_train_bwd.launches)
    got = torch_fn(*tensors, tl)
    grads = torch.autograd.grad(got, tensors, torch.from_numpy(dh))
    assert before == (trnn.lstm_train_fwd.launches, trnn.lstm_train_bwd.launches,
                      trnn.gru_train_fwd.launches, trnn.gru_train_bwd.launches)  # CPU: twins
    assert got.shape == (G, B, H)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VALUE_TOL)
    for name, g, w in zip(("x_proj", "w_hh", "b_hh"), grads, want_grads):
        assert _rel(g, w) < GRAD_TOL, f"{name}: {_rel(g, w):.3e}"

    # the plain version of the whole function: rnn_scan under autograd
    scan = trnn.rnn_scan(cell, *tensors, tl)[0]
    scan_grads = torch.autograd.grad(scan, tensors, torch.from_numpy(dh))
    torch.testing.assert_close(got, scan, rtol=1e-6, atol=1e-6)
    for g, w in zip(grads, scan_grads):
        assert _rel(g, w.numpy()) < GRAD_TOL
    if kind == "ragged":  # length 0: the zero state and no gradient, exactly
        assert torch.all(got[:, 0] == 0) and torch.all(grads[0][:, :, 0] == 0)
        assert torch.all(grads[0][13:, :, 2] == 0)  # nothing past a row's length


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_twins_match_the_reference_residuals(cell):
    """Each plain twin alone against the reference's kernels: gates after
    their activations, ``hprev`` the incoming carry, ``cprev`` / ``hn`` as the
    reference stores them, at every valid step (the port's residuals are zero
    past each length; the reference's carry frozen values there), and the
    ``x_proj`` cotangent, zero past each length, everywhere."""
    gates = CELLS[cell][0]
    x_proj, w_hh, b_hh, dh = _inputs(cell, seed=9)
    lengths = LENGTHS["ragged"]
    core_fwd, core_bwd = (jrt._core_fwd, jrt._core_bwd) if cell == "lstm" else \
        (jrt._gru_core_fwd, jrt._gru_core_bwd)
    want_h, res = core_fwd(*map(jnp.asarray, (x_proj, w_hh, b_hh)),
                           jnp.asarray(lengths, jnp.float32))
    want_dx = np.asarray(core_bwd(res, jnp.asarray(dh))[0])
    want_res = [np.asarray(r)[:T, :, :B] for r in res[:3]]  # the reference pads T and B

    fwd, bwd = (trnn.lstm_train_fwd_plain, trnn.lstm_train_bwd_plain) if cell == "lstm" else \
        (trnn.gru_train_fwd_plain, trnn.gru_train_bwd_plain)
    tl = torch.from_numpy(lengths)
    h_t, *got_res = fwd(*map(torch.from_numpy, (x_proj, w_hh, b_hh)), tl)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), **VALUE_TOL)
    valid = np.arange(T)[:, None] < lengths[None, :]  # [T, B]
    for got, want, cols in zip(got_res, want_res, (gates * H, H, H)):
        assert got.shape == (T, G, B, cols)
        got = got.numpy().transpose(0, 2, 1, 3)  # [T, B, G, cols]
        want = want.transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got[valid], want[valid], **VALUE_TOL)
        assert np.all(got[~valid] == 0)
    dx = bwd(*got_res[:2], got_res[2], torch.from_numpy(w_hh), tl, torch.from_numpy(dh))
    assert dx.shape == (T, G, B, gates * H)
    assert _rel(dx.numpy(), want_dx) < GRAD_TOL
    assert np.all(dx.numpy().transpose(0, 2, 1, 3)[~valid] == 0)


def test_trainable_wrappers_reject_what_they_do_not_take_and_run_without_a_graph():
    x_proj, w_hh, b_hh, dh = (torch.from_numpy(a) for a in _inputs("lstm", seed=3))
    with pytest.raises(TypeError, match="float32"):
        trnn.lstm_train_fwd(x_proj.double(), w_hh, b_hh)
    with pytest.raises(TypeError, match="int32"):
        trnn.grouped_lstm_trainable(x_proj, w_hh, b_hh, torch.zeros(B, dtype=torch.int64))
    with pytest.raises(ValueError, match="lengths must have shape"):
        trnn.gru_train_fwd(x_proj[..., :3 * H], w_hh[..., :3 * H], b_hh[:, :3 * H],
                           torch.zeros(B + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="w_hh must have shape"):  # 4H columns for a GRU
        trnn.grouped_gru_trainable(x_proj[..., :3 * H], w_hh, b_hh[:, :3 * H])
    with pytest.raises(ValueError, match=r"expected x_proj \[T, G, B, 4H\]"):
        trnn.lstm_train_fwd(x_proj[0], w_hh, b_hh)
    _h, gates, hprev, cprev = trnn.lstm_train_fwd(x_proj, w_hh, b_hh)
    with pytest.raises(ValueError, match="dh_out must have shape"):
        trnn.lstm_train_bwd(gates, hprev, cprev, w_hh, None, dh[:, :2])
    with pytest.raises(ValueError, match="cprev must have shape"):
        trnn.lstm_train_bwd(gates, hprev, cprev[:, :, :2], w_hh, None, dh)
    # training-mode forwards under inference_mode (MC dropout): no graph
    want = trnn.grouped_lstm_trainable(x_proj, w_hh, b_hh)
    with torch.inference_mode():
        got = trnn.grouped_lstm_trainable(x_proj, w_hh.requires_grad_(), b_hh)
    assert not got.requires_grad and torch.equal(got, want)
    empty = trnn.grouped_gru_trainable(x_proj[:0, ..., :3 * H], w_hh[..., :3 * H].detach(),
                                       b_hh[:, :3 * H])
    assert torch.all(empty == 0) and empty.shape == (G, B, H)


def test_lstm_training_route_takes_the_cluster_body_where_it_fits():
    # the cluster body holds a CTA's W_hh slice in shared memory up to H 256
    # and takes 32-deep chunks of its 4H / 8 gate slots (the GRU's fourth a
    # zero column); the rest, H of the tests above included, runs the SIMT
    # body. One route names the body of both cells' training pairs.
    assert [trnn.rnn_train_route(h) for h in (64, 128, 192, 256)] == ["cluster"] * 4
    assert [trnn.rnn_train_route(h) for h in (H, 16, 32, 96, 300, 320, 384, 512)] == ["simt"] * 8
    assert trnn.CLUSTER_MAX_HIDDEN == 256
    with pytest.raises(ValueError, match="Unknown cell type"):
        trnn.rnn_train_cluster_info("rnn", 256, 32, 4)


NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)


def _rnn_overrides(cell, pallas):
    out = ["model.hidden_dim=16", "model.output_dim=8", f"model.pallas_rnn={pallas}"]
    for name in NAMES:
        out += [f"model.encoders.{name}.encoder_type={cell}", f"model.encoders.{name}.num_layers=1"]
    return out


def test_mc_dropout_runs_through_the_training_kernels_route():
    """``mc_dropout_over_split`` (training-mode forwards under
    ``inference_mode``) with ``model.pallas_rnn`` on: the same function as at
    ``pallas_rnn=false`` on the same weights and seeds."""
    rng = np.random.default_rng(2)
    n, steps = 6, 12
    windows = WindowedSplit(
        features={m: rng.standard_normal((n, steps, d)).astype(np.float32)
                  for m, d in zip(NAMES, DIMS)},
        labels=rng.integers(0, 25, n).astype(np.int32),
        lengths=np.array([12, 3, 1, 12, 7, 9], np.int32), modalities=list(NAMES))
    data = DeviceSplit.from_windows(windows, device="cpu")
    out = {}
    for pallas in ("true", "false"):
        model = MultimodalFusionModel.from_config(
            load_config(REPO / "config" / "base.yaml", _rnn_overrides("lstm", pallas)),
            device="cpu")
        assert model.grouped_rnn_encoder.use_pallas is (pallas == "true")
        out[pallas] = mc_dropout_over_split(model, data, num_samples=3, batch_size=4)
    for got, want in zip(out["true"], out["false"]):
        assert got.shape == want.shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(out["true"][1] > 0)  # dropout is on: the samples differ


# ---- keys the port refuses ---------------------------------------------------


@pytest.mark.parametrize("key,value,error,match", [
    # ported since (the MoE feed-forward): the case keeps its name and now
    # checks that the key builds, and that a moe_top_k past the experts
    # raises the reference's ValueError
    pytest.param("moe_experts", 4, None, None,
                 id="moe_experts-4-NotImplementedError-model.encoders.imu_hand.moe_experts.*item 8"),
    # ported since (the parallel layouts): the cases keep their names and now
    # check that the keys build (the pipeline's layer count must divide over
    # its stages, the reference's ValueError)
    pytest.param("pipeline_parallel", 2, None, None,
                 id="pipeline_parallel-2-NotImplementedError-"
                    "model.encoders.imu_hand.pipeline_parallel.*item 11"),
    pytest.param("sequence_parallel", True, None, None,
                 id="sequence_parallel-True-NotImplementedError-"
                    "model.encoders.imu_hand.sequence_parallel.*item 11"),
    # a per-encoder dtype is ported (float32 or bfloat16); any other type fails
    ("dtype", "float16", ValueError, "Unknown compute dtype 'float16'"),
])
def test_build_encoder_refuses_unported_per_encoder_keys(key, value, error, match):
    base = {"type": "sequence", "encoder_type": "transformer", "hidden_dim": 16, "num_layers": 1}
    if error is None and key == "moe_experts":
        enc = te.build_encoder("imu_hand", 17, 8, {**base, key: value, "moe_top_k": 2})
        layer = enc.layers[0]
        assert layer.moe.num_experts == value and not hasattr(layer, "linear1")
        with pytest.raises(ValueError, match=r"moe_top_k \(5\) must be in \[1, moe_experts=4\]"):
            te.build_encoder("imu_hand", 17, 8, {**base, key: value, "moe_top_k": 5})
    elif key == "pipeline_parallel":
        with pytest.raises(ValueError, match=r"num_layers \(1\) must divide evenly over "
                                             r"pipeline_parallel \(2\)"):
            te.build_encoder("imu_hand", 17, 8, {**base, key: value})
        enc = te.build_encoder("imu_hand", 17, 8, {**base, key: value, "num_layers": 2,
                                                   "pipeline_microbatches": 4})
        assert enc.pipeline.pipeline_parallel == 2 and enc.pipeline.microbatches == 4
        assert enc.pipeline.pipe_layers["linear1"]["kernel"].shape == (2, 16, 2048)
        assert not hasattr(enc, "layers")
    elif key == "sequence_parallel":
        enc = te.build_encoder("imu_hand", 17, 8, {**base, key: value})
        assert enc.sequence_parallel and enc.layers[0].seq_parallel
        # its chunk-of-T parameters are marked for the sum over 'model'
        assert enc.layers[0].norm2.weight.sequence_parallel
        assert not hasattr(enc.layers[0].q_proj.weight, "sequence_parallel")
    else:
        with pytest.raises(error, match=match):
            te.build_encoder("imu_hand", 17, 8, {**base, key: value})
    # the defaults, and the keys that matter only beside the refused ones, build
    quiet = {"moe_experts": 0, "moe_top_k": 2, "moe_capacity_factor": 1.25,
             "pipeline_parallel": 1, "pipeline_microbatches": 4, "sequence_parallel": False,
             "dtype": None}
    assert isinstance(te.build_encoder("imu_hand", 17, 8, {**base, **quiet}), te.SequenceEncoder)
    assert isinstance(te.build_encoder("imu_hand", 17, 8, {**base, "dtype": "float32"}),
                      te.SequenceEncoder)
    # an unknown per-encoder dropout_rng fails at construction, as the reference's _check
    with pytest.raises(ValueError, match="Unknown dropout_rng 'philox'"):
        te.build_encoder("imu_hand", 17, 8, {**base, "encoder_type": "lstm",
                                             "dropout_rng": "philox"})


@pytest.mark.parametrize("overrides,error,match", [
    # ported since (the parallel layouts): the cases keep their names; the
    # Trainer builds, and its mesh needs a world of that many processes (the
    # reference's ValueError for too few devices; tests/test_torch_port_dist.py
    # runs the layouts in one)
    pytest.param(["parallel.num_devices=4"], ValueError, "Requested 4 devices but only 1",
                 id="overrides0-NotImplementedError-parallel.num_devices=4 .*item 11"),
    pytest.param(["parallel.num_devices=4", "parallel.model_parallel=2"], ValueError,
                 "Requested 4 devices but only 1",
                 id="overrides1-NotImplementedError-parallel.model_parallel=2 .*item 11"),
    pytest.param(["parallel.num_devices=4", "parallel.dcn_slices=2"], ValueError,
                 "Requested 4 devices but only 1",
                 id="overrides2-NotImplementedError-parallel.dcn_slices=2 .*item 11"),
    pytest.param(["parallel.num_devices=4", "parallel.pipeline_parallel=2",
                  "model.encoders.imu_hand.num_layers=2", "model.encoders.imu_chest.num_layers=2",
                  "model.encoders.imu_ankle.num_layers=2", "model.encoders.heart_rate.num_layers=2"],
                 ValueError, "Requested 4 devices but only 1",
                 id="overrides3-NotImplementedError-parallel.pipeline_parallel=2 .*item 11"),
    pytest.param(["parallel.num_devices=2", "parallel.zero_optimizer=true"], ValueError,
                 "Requested 2 devices but only 1",
                 id="overrides4-NotImplementedError-parallel.zero_optimizer=True .*item 11"),
    pytest.param(["parallel.num_devices=4", "parallel.model_parallel=2",
                  "parallel.sequence_parallel=true"], ValueError, "Requested 4 devices but only 1",
                 id="overrides5-NotImplementedError-parallel.sequence_parallel=True .*item 11"),
    # ported since: the case keeps its name and now checks that remat builds
    pytest.param(["training.remat=true"], None, None,
                 id="overrides6-NotImplementedError-training.remat .*item 9"),
    (["parallel.sequence_parallel=true"], ValueError,
     "parallel.sequence_parallel requires parallel.model_parallel > 1"),
    (["parallel.num_devices=4", "parallel.model_parallel=2", "parallel.pipeline_parallel=2"],
     ValueError, "cannot be combined with parallel.model_parallel"),
    (["parallel.model_parallel=2"], ValueError, "require parallel.num_devices > 1"),
    (["parallel.zero_optimizer=true"], ValueError, "require parallel.num_devices > 1"),
    (["parallel.num_devices=4", "parallel.model_parallel=3", "model.moe_experts=4"], ValueError,
     r"model.moe_experts \(4\) must divide evenly"),
    (["training.prng_impl=threefy"], ValueError,
     "Unknown training.prng_impl 'threefy'; expected threefry or rbg"),
])
def test_trainer_refuses_unported_layouts(overrides, error, match):
    small = ["model.hidden_dim=16", "model.output_dim=8"]
    if error is None:
        trainer = tt.Trainer(load_config(REPO / "config" / "base.yaml", small + overrides),
                             device="cpu")
        assert trainer.remat
    elif str(match).startswith("Requested"):
        trainer = tt.Trainer(load_config(REPO / "config" / "base.yaml", small + overrides),
                             device="cpu")
        with pytest.raises(error, match=match):
            trainer.init_state(steps_per_epoch=1)
    else:
        with pytest.raises(error, match=match):
            tt.Trainer(load_config(REPO / "config" / "base.yaml", small + overrides), device="cpu")
    # one card, by default and by name, trains as before
    for ok in ([], ["parallel.num_devices=auto"], ["parallel.num_devices=null"],
               ["parallel.num_devices=1", "training.remat=false"]):
        tt.check_layout(load_config(REPO / "config" / "base.yaml", small + ok))


@pytest.mark.parametrize("impl", ["threefry", "rbg", "unsafe_rbg"])
def test_trainer_takes_the_reference_prng_impls(impl):
    # the reference's three generators build a Trainer; in the port the key
    # picks nothing (check_layout's docstring)
    small = ["model.hidden_dim=16", "model.output_dim=8", f"training.prng_impl={impl}"]
    trainer = tt.Trainer(load_config(REPO / "config" / "base.yaml", small), device="cpu")
    assert trainer.config.training.prng_impl == impl
