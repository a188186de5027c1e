"""PyTorch port's Mixture-of-Experts feed-forward (``models/moe.py``, the
transformer layer's MoE branch, the trainer's aux loss) held against the JAX
package on the CPU: hidden 32, d_ff 64-128, 2-4 experts, seeded numpy
inputs, the same weights (converted both ways).

The routing (each (token, slot)'s expert, buffer address and whether it is
kept) is read out of the JAX module's own computation: its jaxpr is
evaluated equation by equation and the outputs of its ``top_k`` and the
indices of its dispatch scatters are kept, so the port is held to what the
reference computes, not to a copy of it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import moe as jmoe
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.metrics import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.serving import (
    make_serving_fn as jax_serving_fn,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
    to_flax_variables,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import WindowedSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import moe as tmoe
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.trainer import Trainer
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.uncertainty import (
    mc_dropout_over_split,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
MOE = ["model.hidden_dim=32", "model.output_dim=16", "model.moe_experts=4", "model.moe_top_k=2",
       "model.moe_capacity_factor=1.25", "model.flash_attention=true", "model.fused_mlp=true",
       "model.fused_mlp_ln=true"]
SMOOTHING = 0.05
AUX_WEIGHT = 0.01  # base.yaml's training.moe_aux_weight
# f32 on both sides, the same routing: the sums of the products, the softmax
# and the gates' weighted sum in another order
LOGIT_ABS, LOGIT_REL = 2e-5, 1e-4
LOSS_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_routing(fn, *args):
    """Evaluate ``fn``'s jaxpr one equation at a time -> (its output, {primitive
    name: [(inputs, outputs), ...]}) for every equation at its top level."""
    closed = jax.make_jaxpr(fn)(*args)
    env = {}

    def read(v):
        return v.val if type(v).__name__ == "Literal" else env[v]

    env.update(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, jax.tree_util.tree_leaves(args)))
    seen = {}
    for eqn in closed.jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        ins = [read(v) for v in eqn.invars]
        outs = eqn.primitive.bind(*subfuns, *ins, **params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        seen.setdefault(eqn.primitive.name, []).append((ins, outs))
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in closed.jaxpr.outvars], seen


def _case(seed, batch=3, seq=16, hidden=32, lengths=(16, 5, 0)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, hidden)).astype(np.float32)
    valid = (np.arange(seq)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    dout = rng.standard_normal((batch, seq, hidden)).astype(np.float32)
    return x, valid, dout


def _pair(experts, top_k, factor, d_ff=64, hidden=32, seed=0, dtype=None):
    """The JAX module with weights from its own init, the port's module with
    the same weights."""
    jm = jmoe.MoEFeedForward(hidden_dim=hidden, dim_feedforward=d_ff, num_experts=experts,
                             top_k=top_k, capacity_factor=factor, dropout=0.0,
                             dtype=jnp.bfloat16 if dtype else None)
    x, valid, _ = _case(seed, hidden=hidden)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(valid)))["params"]
    port = tmoe.MoEFeedForward(hidden, d_ff, experts, top_k, factor, dropout=0.0, dtype=dtype)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return jm, params, port


@pytest.mark.parametrize("tokens,experts,top_k,factor", [
    (48, 4, 2, 1.25), (48, 4, 2, 0.25), (16384, 4, 2, 1.25), (32768, 4, 2, 1.25),
    (7, 3, 1, 1.0), (100, 2, 2, 4.0), (5, 4, 4, 0.1)])
def test_moe_capacity_is_the_references(tokens, experts, top_k, factor):
    assert tmoe.moe_capacity(tokens, experts, top_k, factor) == jmoe.moe_capacity(
        tokens, experts, top_k, factor)
    # the flagship's training micro-step: 32 windows of 512 steps
    assert tmoe.moe_capacity(16384, 4, 2, 1.25) == 10240


@pytest.mark.parametrize("experts,top_k,factor", [(4, 2, 1.25), (4, 2, 0.25), (2, 1, 1.25),
                                                  (3, 3, 1.0)])
def test_moe_feed_forward_matches_jax(experts, top_k, factor):
    """Output, aux loss, routing and every gradient of one MoEFeedForward
    against the reference's on the same weights and tokens (one window
    ragged, one all padding); at capacity factor 0.25 the experts overflow
    and the same (token, slot)s are dropped."""
    jm, params, port = _pair(experts, top_k, factor, seed=experts + top_k)
    x, valid, dout = _case(11)

    def fn(p, xx, m):
        out, state = jm.apply({"params": p}, xx, m, mutable=["losses"])
        return out, jax.tree_util.tree_leaves(state["losses"])[0]

    (j_out, j_aux), seen = _jax_routing(fn, params, jnp.asarray(x), jnp.asarray(valid))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = port(tx, torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=LOGIT_REL,
                               atol=LOGIT_ABS)
    assert abs(aux.item() - float(j_aux)) <= AUX_TOL
    # the routing, (token, slot) by (token, slot)
    n = x.shape[0] * x.shape[1]
    probs, _gates, expert, addr, keep, cap = port.route(
        torch.from_numpy(x).reshape(n, -1), torch.from_numpy(valid).reshape(n) > 0)
    (_, (_j_gates, j_expert)), = seen["top_k"]
    j_addr = np.concatenate([np.asarray(ins[1]).reshape(n, 1) for ins, _ in seen["scatter"]], 1)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(j_expert))
    np.testing.assert_array_equal(addr.numpy(), j_addr)
    np.testing.assert_array_equal(keep.numpy(), j_addr < experts * cap)
    top = torch.sort(probs, -1, descending=True).values
    margin = (top[:, top_k - 1] - top[:, top_k]).min().item() if top_k < experts else float("nan")
    live = torch.from_numpy(valid).reshape(n) > 0
    print(f"E={experts} k={top_k} factor={factor}: capacity {cap}, kept {int(keep.sum())} of "
          f"{int(live.sum()) * top_k} valid (token, slot)s, smallest top-k margin {margin:.3e}")
    if factor < 1:
        assert int(keep.sum()) < int(live.sum()) * top_k  # the experts overflow
    # gradients of sum(out * dout) + aux with respect to x and every parameter
    def loss_fn(p, xx):
        o, a = fn(p, xx, jnp.asarray(valid))
        return jnp.sum(o * jnp.asarray(dout)) + a

    j_gp, j_gx = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(params, jnp.asarray(x))
    (out * torch.from_numpy(dout)).sum().add(aux).backward()
    for name, want in [("x", j_gx)] + sorted(j_gp.items()):
        got = tx.grad if name == "x" else getattr(port, name).grad
        assert _rel(got.numpy(), want) <= GRAD_TOL, name


def test_moe_padded_steps_give_zero_and_take_no_capacity():
    """A padded step's output is exactly zero and its gates, addresses and
    aux share are nothing: per expert, the valid (token, slot)s fill the
    positions 0, 1, ... with no gap."""
    _jm, _params, port = _pair(4, 2, 1.25, seed=3)
    x, valid, _ = _case(12, lengths=(9, 0, 16))
    with torch.no_grad():
        out, _aux = port(torch.from_numpy(x), torch.from_numpy(valid))
    pad = torch.from_numpy(valid) == 0
    assert torch.all(out[pad] == 0)
    n = x.shape[0] * x.shape[1]
    live = torch.from_numpy(valid).reshape(n) > 0
    _p, gates, expert, addr, keep, cap = port.route(torch.from_numpy(x).reshape(n, -1), live)
    assert torch.all(gates[~live] == 0) and not keep[~live].any()
    assert torch.all(addr[~live] == 4 * cap)
    for e in range(4):
        used = addr[keep & (expert == e)] - e * cap
        assert sorted(used.tolist()) == list(range(len(used)))


def test_moe_ties_break_to_the_lower_expert():
    """A router of zeros makes every expert's probability equal: the k
    chosen are the k lowest indices, as ``lax.top_k`` picks them."""
    jm, params, port = _pair(4, 2, 1.25, seed=5)
    params = {**params, "router": np.zeros_like(params["router"])}
    with torch.no_grad():
        port.router.zero_()
    x, valid, _ = _case(13)
    (j_out,), seen = _jax_routing(lambda p, xx, m: jm.apply({"params": p}, xx, m), params,
                                  jnp.asarray(x), jnp.asarray(valid))
    n = x.shape[0] * x.shape[1]
    _p, _g, expert, _a, _k, _c = port.route(torch.from_numpy(x).reshape(n, -1),
                                            torch.from_numpy(valid).reshape(n) > 0)
    assert torch.all(expert == torch.tensor([0, 1]))
    (_, (_jg, j_expert)), = seen["top_k"]
    np.testing.assert_array_equal(expert.numpy(), np.asarray(j_expert))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=LOGIT_REL, atol=LOGIT_ABS)


def test_moe_feed_forward_in_bf16_matches_jax():
    """``dtype`` bfloat16: the buffer, products and biases in bf16 (each
    product rounded, then the bias added in bf16), routing and combine in
    f32, the output in x's type; the reference's eager result on bf16
    tokens."""
    jm, params, port = _pair(4, 2, 1.25, seed=7, dtype=BF)
    x, valid, _ = _case(14)
    xb = torch.from_numpy(x).to(BF)
    with jax.disable_jit():
        j_out = jm.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(valid))
    with torch.no_grad():
        out, _aux = port(xb, torch.from_numpy(valid))
    assert out.dtype == BF and j_out.dtype == jnp.bfloat16
    got, want = out.float().numpy(), np.asarray(j_out.astype(jnp.float32))
    # one bf16 step where the f32 gate sum straddles a rounding boundary
    assert _rel(got, want) < 1e-2 and np.mean(got != want) < 1e-2


def _batch(seed=20, batch=4, seq=24):
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((batch, seq, d)).astype(np.float32)
             for n, d in zip(NAMES, DIMS)}
    mask = np.ones((batch, 4), np.float32)
    mask[2, :] = [0, 1, 1, 1]
    lengths = np.array([seq, 7, 0, 13], np.int32)
    labels = rng.integers(0, 25, batch).astype(np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)
    return feats, mask, lengths, labels, weight


@pytest.fixture(scope="module")
def moe_model():
    """(port model, flax variables, JAX model) at model.moe_experts=4 and
    dropout 0, the kernels on (their twins on the CPU, interpret mode in the
    JAX package)."""
    overrides = MOE + ["model.dropout=0"]
    port = MultimodalFusionModel.from_config(load_config(REPO / "config" / "base.yaml", overrides),
                                             device="cpu",
                                             generator=torch.Generator().manual_seed(3))
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", overrides))
    return port, to_flax_variables(port), jmodel


def test_moe_model_serves_like_jax(moe_model):
    port, variables, jmodel = moe_model
    assert {k.split("/")[-1] for k, _ in _flat(variables["params"]) if "/moe/" in k} == {
        "router", "moe_w1", "moe_b1", "moe_w2", "moe_b2"}
    assert not any("linear1" in k for k, _ in _flat(variables["params"]))
    # the converter maps the moe subtree both ways
    state = port.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in from_flax_variables(variables).items())
    feats, mask, lengths, _labels, _weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    want = np.asarray(jax_serving_fn(jmodel, variables, interpret=True)(
        jf, jnp.asarray(mask), jnp.asarray(lengths)))
    got = make_serving_fn(port, device="cpu")(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_REL, atol=LOGIT_ABS)


def test_moe_model_train_step_matches_jax(moe_model):
    """One micro-step at dropout 0 (``Trainer.loss_and_grads``: the loss plus
    moe_aux_weight times the layers' aux losses) against the reference's
    objective and its gradient."""
    port, variables, jmodel = moe_model
    feats, mask, lengths, labels, weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}

    def loss_fn(params):
        logits, state = jmodel.apply(
            {"params": params}, jf, jnp.asarray(mask), jnp.asarray(lengths), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["losses"])
        aux = sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(state["losses"]))
        ce = jax_cross_entropy_loss(logits, jnp.asarray(labels), SMOOTHING,
                                    sample_weight=jnp.asarray(weight))
        return ce + AUX_WEIGHT * aux, aux

    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    cfg = load_config(REPO / "config" / "base.yaml", MOE + ["model.dropout=0"])
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(port.state_dict())
    assert trainer.moe_aux_weight == AUX_WEIGHT
    aux = []
    with torch.no_grad():
        trainer.model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                      torch.from_numpy(lengths), train=True, aux_losses=aux)
    assert len(aux) == len(NAMES)
    assert abs(float(sum(aux)) - float(j_aux)) <= AUX_TOL
    loss, _acc, grads = trainer.loss_and_grads(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(labels).long(),
        torch.from_numpy(mask), torch.from_numpy(lengths), torch.from_numpy(weight))
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    got = dict(_flat(to_flax_tree(dict(zip(
        [n for n, _ in trainer.model.named_parameters()], grads)))))
    want = dict(_flat(j_grads))
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    errs = {n: np.abs(got[n] - w).max() / max(np.abs(w).max(), floor) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    print(f"MoE step: loss {loss.item():.7f} vs {float(j_loss):.7f}, aux {float(j_aux):.7f}; "
          f"worst gradient {worst} {errs[worst]:.3e}")
    assert errs[worst] <= GRAD_TOL, worst
    assert np.abs(want["encoders_imu_hand/layer0/moe/router"]).max() > 0  # the aux reaches it


def test_moe_model_trains_with_dropout_and_runs_mc_dropout():
    """At dropout 0.2 the layer's masks (attention- and FFW-side residual)
    and the experts' own draw from the trainer's generator: the same seed
    twice gives the same loss bit for bit; MC dropout over a split runs on
    this model."""
    cfg = load_config(REPO / "config" / "base.yaml", MOE + ["model.dropout=0.2"])
    feats, mask, lengths, labels, weight = _batch()
    args = ({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(labels).long(),
            torch.from_numpy(mask), torch.from_numpy(lengths), torch.from_numpy(weight))
    losses = [Trainer(cfg, device="cpu").loss_and_grads(*args)[0] for _ in range(2)]
    assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])
    rng = np.random.default_rng(2)
    windows = WindowedSplit(
        features={m: rng.standard_normal((6, 12, d)).astype(np.float32)
                  for m, d in zip(NAMES, DIMS)},
        labels=rng.integers(0, 25, 6).astype(np.int32),
        lengths=np.array([12, 3, 1, 12, 7, 9], np.int32), modalities=list(NAMES))
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    mean, variance = mc_dropout_over_split(model, DeviceSplit.from_windows(windows, device="cpu"),
                                           num_samples=3, batch_size=4)
    assert mean.shape == (6, 25) and np.all(np.isfinite(mean)) and np.all(variance > 0)
