"""PyTorch port, recurrent ops and encoders: the three grouped recurrence
functions of ``ops/rnn.py`` against the JAX package's Pallas kernels (run in
interpret mode), ``RNNStack`` / ``SequenceEncoder`` (lstm, gru) against the JAX
modules and against ``torch.nn.LSTM`` / ``nn.GRU``, and ``GroupedRNNEncoder``
against the JAX module and against the port's own ungrouped encoders on the
same weights unstacked. Inputs and weights come from seeded numpy; the port
runs on the CPU, where each kernel wrapper takes its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import encoders as jenc
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import grouped as jg
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_rnn as jrnn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
    ungroup_state_dict,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as te
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import grouped as tg
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as trnn

H, OUT = 16, 8
# f32 on both sides; 22-24 dependent steps whose products sum in another order
TOL = dict(rtol=2e-5, atol=2e-5)
LENGTHS = {  # by batch size: full, ragged (with 0 and 1), and none
    5: {"full": "T", "ragged": [0, 1, 13, 22, 7], "none": None},
    8: {"full": "T", "ragged": [24, 13, 1, 0, 7, 24, 23, 18], "none": None},
}
SHAPES = [(22, 2, 5, 3), (24, 3, 8, 8)]  # T, G, B, D


def _lengths(batch, steps, kind):
    spec = LENGTHS[batch][kind]
    if spec is None:
        return None
    return np.full((batch,), steps, np.int32) if spec == "T" else np.asarray(spec, np.int32)


def _weights(rng, groups, feat, gates):
    scale = H**-0.5
    u = lambda *shape: rng.uniform(-scale, scale, shape).astype(np.float32)  # noqa: E731
    return u(groups, feat, gates * H), u(groups, H, gates * H), u(groups, gates * H), \
        u(groups, gates * H)


def _t(array):
    return None if array is None else torch.from_numpy(array)


def _j(array):
    return None if array is None else jnp.asarray(array)


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize("steps,groups,batch,feat", SHAPES)
@pytest.mark.parametrize("fn", ["lstm_forward", "lstm_fused", "gru_fused"])
def test_grouped_recurrence_matches_jax_kernel(fn, steps, groups, batch, feat, kind):
    rng = np.random.default_rng(steps + batch)
    gates = 3 if fn == "gru_fused" else 4
    w_ih, w_hh, b_ih, b_hh = _weights(rng, groups, feat, gates)
    lengths = _lengths(batch, steps, kind)
    if fn == "lstm_forward":
        x_proj = rng.standard_normal((steps, groups, batch, 4 * H)).astype(np.float32)
        want = jrnn.grouped_lstm_forward(_j(x_proj), _j(w_hh), _j(b_hh), _j(lengths),
                                         interpret=True)
        got = trnn.grouped_lstm_forward(_t(x_proj), _t(w_hh), _t(b_hh), _t(lengths))
    else:
        x = rng.standard_normal((steps, groups, batch, feat)).astype(np.float32)
        if fn == "lstm_fused":
            want = jrnn.grouped_lstm_fused(_j(x), _j(w_ih), _j(w_hh), _j(b_ih + b_hh),
                                           _j(lengths), interpret=True)
            got = trnn.grouped_lstm_fused(_t(x), _t(w_ih), _t(w_hh), _t(b_ih + b_hh), _t(lengths))
        else:
            want = jrnn.grouped_gru_fused(_j(x), _j(w_ih), _j(w_hh), _j(b_ih), _j(b_hh),
                                          _j(lengths), interpret=True)
            got = trnn.grouped_gru_fused(_t(x), _t(w_ih), _t(w_hh), _t(b_ih), _t(b_hh),
                                         _t(lengths))
    assert got.shape == (groups, batch, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kind == "ragged":  # a row of length 0 never leaves the zero state
        zero_row = int(np.argmin(lengths))
        assert torch.all(got[:, zero_row] == 0)


def test_fused_and_precomputed_projection_are_one_function():
    rng = np.random.default_rng(3)
    steps, groups, batch, feat = 22, 2, 5, 3
    w_ih, w_hh, b_ih, b_hh = (_t(a) for a in _weights(rng, groups, feat, 4))
    x = _t(rng.standard_normal((steps, groups, batch, feat)).astype(np.float32))
    lengths = _t(_lengths(batch, steps, "ragged"))
    x_proj = torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]
    torch.testing.assert_close(
        trnn.grouped_lstm_forward(x_proj, w_hh, b_hh, lengths),
        trnn.grouped_lstm_fused(x, w_ih, w_hh, b_ih + b_hh, lengths), rtol=1e-5, atol=1e-6)
    final, outputs = trnn.rnn_scan("lstm", x_proj, w_hh, b_hh, lengths, return_outputs=True)
    assert outputs.shape == (steps, groups, batch, H) and torch.equal(outputs[-1], final)
    # a frozen row repeats its last valid state
    assert torch.equal(outputs[12, :, 2], outputs[-1, :, 2])


def test_recurrence_wrappers_reject_what_they_do_not_take():
    x = torch.zeros(4, 2, 3, 5)
    w_ih, w_hh, bias = torch.zeros(2, 5, 4 * H), torch.zeros(2, H, 4 * H), torch.zeros(2, 4 * H)
    with pytest.raises(TypeError, match="float32"):
        trnn.grouped_lstm_fused(x.double(), w_ih, w_hh, bias)
    with pytest.raises(TypeError, match="int32"):
        trnn.grouped_lstm_fused(x, w_ih, w_hh, bias, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="lengths must have shape"):
        trnn.grouped_lstm_fused(x, w_ih, w_hh, bias, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="w_ih must have shape"):
        trnn.grouped_lstm_fused(x, w_ih[:, :4], w_hh, bias)
    with pytest.raises(ValueError, match="b_hh must have shape"):
        trnn.grouped_lstm_forward(torch.zeros(4, 2, 3, 4 * H), w_hh, bias[:, :-1])
    with pytest.raises(ValueError, match="w_hh must have shape"):  # 4H columns for a GRU
        trnn.grouped_gru_fused(x, w_ih[..., :3 * H], w_hh, bias[:, :3 * H], bias[:, :3 * H])
    with pytest.raises(ValueError, match=r"expected x \[T, G, B, D\]"):
        trnn.grouped_gru_fused(x[0], w_ih, w_hh, bias, bias)
    with pytest.raises(ValueError, match="Unknown cell type"):
        trnn.rnn_scan("rnn", x, w_hh, bias)


def test_fused_recurrences_route_by_hidden_and_input_width():
    # the serving cluster body holds a CTA's W_hh and W_ih slices in shared
    # memory: H a multiple of 64 up to 256 and D up to 64; the rest, H of the
    # tests above included, runs the SIMT body
    assert [trnn.grouped_fused_route(h, 17) for h in (64, 128, 192, 256)] == ["cluster"] * 4
    assert [trnn.grouped_fused_route(256, d) for d in (1, 17, 64)] == ["cluster"] * 3
    assert [trnn.grouped_fused_route(h, 17) for h in (H, 16, 32, 96, 300, 320, 384, 512)] == \
        ["simt"] * 8
    assert [trnn.grouped_fused_route(256, d) for d in (0, 65, 128)] == ["simt"] * 3
    assert (trnn.CLUSTER_MAX_HIDDEN, trnn.CLUSTER_MAX_FEAT) == (256, 64)


@pytest.mark.parametrize("hidden,route", [(32, "simt"), (64, "cluster"), (192, "cluster"),
                                          (256, "cluster"), (320, "simt")])
def test_precomputed_projection_recurrence_routes_by_hidden(hidden, route):
    # grouped_lstm_forward's cluster body holds a CTA's W_hh slice and h (no
    # W_ih slice, no x ring): H a multiple of 64 up to 256, any D upstream
    assert trnn.grouped_lstm_forward_route(hidden) == route
    assert trnn.grouped_lstm_forward_route(hidden) == trnn.rnn_train_route(hidden)


def test_cluster_rows_run_a_launch_in_the_fewest_waves():
    def tilings(waves16, waves32):
        return {16: {"waves": waves16}, 32: {"waves": waves32}}

    # B 64, G 4 with 15 clusters on the card at once: 16 clusters of 16 rows
    # are two waves, 8 of 32 one
    assert trnn.pick_cluster_rows(tilings(2, 1)) == 32
    assert trnn.pick_cluster_rows(tilings(1, 1)) == 16  # B 32: one wave either way
    assert trnn.pick_cluster_rows(tilings(2, None)) == 16  # 32 rows fit no CTA
    assert trnn.pick_cluster_rows(tilings(None, 3)) == 32
    with pytest.raises(RuntimeError, match="fits no CTA"):
        trnn.pick_cluster_rows(tilings(None, None))


def _seq(batch, steps, feat, seed):
    return np.random.default_rng(seed).standard_normal((batch, steps, feat)).astype(np.float32)


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_sequence_encoder_rnn_matches_jax(cell, layers, with_lengths):
    x = _seq(5, 22, 6, seed=layers)
    lengths = np.array([22, 0, 1, 9, 16], np.int32) if with_lengths else None
    enc = jenc.SequenceEncoder(hidden_dim=H, output_dim=OUT, num_layers=layers,
                               encoder_type=cell, dropout=0.0)
    variables = enc.init(jax.random.PRNGKey(layers), jnp.asarray(x), _j(lengths))
    want = enc.apply(variables, jnp.asarray(x), _j(lengths))
    port = te.SequenceEncoder(6, hidden_dim=H, output_dim=OUT, num_layers=layers,
                              encoder_type=cell, dropout=0.0)
    state = from_flax_variables({"params": {"encoders_m": jax.tree_util.tree_map(
        np.asarray, variables["params"])}})
    port.load_state_dict({k.split("encoders.m.", 1)[1]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), _t(lengths))
        stack = port.rnn(torch.from_numpy(x), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_stack = jenc._RNNStack(hidden_dim=H, num_layers=layers, cell_type=cell).apply(
        {"params": variables["params"]["rnn"]}, jnp.asarray(x), _j(lengths))
    np.testing.assert_allclose(stack.numpy(), np.asarray(want_stack), **TOL)
    # the converter's way back gives the flax tree leaf for leaf
    back = to_flax_tree({f"encoders.m.{k}": v for k, v in port.state_dict().items()})
    flat_back = jax.tree_util.tree_leaves_with_path(back["encoders_m"])
    flat_want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, dict(variables["params"])))
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_stack_matches_torch_nn(cell, layers):
    """Full lengths: the same function as ``torch.nn.LSTM`` / ``nn.GRU``
    carrying the same weights (theirs are ``[gates*H, in]``)."""
    stack = te.RNNStack(6, H, layers, cell)
    stack.init_parameters(torch.Generator().manual_seed(layers))
    ref = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(6, H, layers, batch_first=True)
    with torch.no_grad():
        for layer in range(layers):
            for name in ("weight_ih", "weight_hh"):
                getattr(ref, f"{name}_l{layer}").copy_(getattr(stack, f"{name}_l{layer}").t())
            for name in ("bias_ih", "bias_hh"):
                getattr(ref, f"{name}_l{layer}").copy_(getattr(stack, f"{name}_l{layer}"))
        x = torch.from_numpy(_seq(5, 22, 6, seed=9))
        hidden = ref(x)[1]
        want = (hidden[0] if cell == "lstm" else hidden)[-1]
        torch.testing.assert_close(stack(x), want, rtol=2e-5, atol=2e-5)
    scale = H**-0.5
    assert all(p.abs().max() <= scale and p.abs().max() > 0.5 * scale for p in stack.parameters())


def test_rnn_stack_dropout_sits_between_layers_only():
    x = torch.from_numpy(_seq(4, 10, 6, seed=2))
    one = te.RNNStack(6, H, 1, "lstm", dropout=0.5)
    two = te.RNNStack(6, H, 2, "lstm", dropout=0.5)
    for stack in (one, two):
        stack.init_parameters(torch.Generator().manual_seed(0))
    g = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    with torch.no_grad():
        assert torch.equal(one(x, train=True, generator=g(1)), one(x))  # one layer: no mask
        assert not torch.equal(two(x, train=True, generator=g(1)), two(x))
        assert torch.equal(two(x, train=True, generator=g(1)), two(x, train=True, generator=g(1)))
        assert not torch.equal(two(x, train=True, generator=g(1)),
                               two(x, train=True, generator=g(2)))
    with pytest.raises(ValueError, match="Unknown cell type"):
        te.RNNStack(6, H, 1, "rnn")


# ---- GroupedRNNEncoder -------------------------------------------------------

G, B, T = 3, 5, 22
MEMBER_DIMS = (6, 6, 1)  # padded to the group's 6


def _group_inputs(seed=0):
    rng = np.random.default_rng(seed)
    members = {f"m{i}": rng.standard_normal((B, T, d)).astype(np.float32)
               for i, d in enumerate(MEMBER_DIMS)}
    return members, np.array([T, 0, 1, 9, 17], np.int32)


def _grouped_pair(cell, layers, use_pallas):
    jenc_g = jg.GroupedRNNEncoder(num_groups=G, hidden_dim=H, output_dim=OUT, num_layers=layers,
                                  cell_type=cell, dropout=0.0, use_pallas=use_pallas)
    members, lengths = _group_inputs()
    stacked = jg.stack_group_features({n: jnp.asarray(v) for n, v in members.items()},
                                      list(members))
    variables = jenc_g.init(jax.random.PRNGKey(7), stacked, jnp.asarray(lengths))
    port = tg.GroupedRNNEncoder(G, max(MEMBER_DIMS), hidden_dim=H, output_dim=OUT,
                                num_layers=layers, cell_type=cell, dropout=0.0,
                                use_pallas=use_pallas)
    state = from_flax_variables({"params": {"grouped_rnn": jax.tree_util.tree_map(
        np.asarray, variables["params"])}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    return jenc_g, variables, port.eval(), stacked


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("cell,layers", [("lstm", 1), ("gru", 1), ("lstm", 2)])
def test_grouped_rnn_encoder_matches_jax(cell, layers, use_pallas, with_lengths):
    jenc_g, variables, port, stacked = _grouped_pair(cell, layers, use_pallas)
    _, lengths = _group_inputs()
    want = jenc_g.apply(variables, stacked, jnp.asarray(lengths) if with_lengths else None)
    counters = (trnn.grouped_lstm_fused, trnn.grouped_gru_fused, trnn.grouped_lstm_forward)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(stacked)), _t(lengths) if with_lengths else None)
    assert [fn.launches for fn in counters] == before  # CPU tensors: no kernel launched
    assert got.shape == (G, B, OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("cell,layers", [("lstm", 1), ("gru", 1), ("gru", 2)])
def test_grouped_rnn_equals_ungrouped_encoders_on_unstacked_weights(cell, layers, use_pallas):
    _jenc, _variables, port, stacked = _grouped_pair(cell, layers, use_pallas)
    members, lengths = _group_inputs()
    names = list(members)
    state = ungroup_state_dict(
        {f"grouped_rnn_encoder.{k}": v for k, v in port.state_dict().items()}, (),
        dict(zip(names, MEMBER_DIMS)), rnn_names=names)
    with torch.no_grad():
        grouped = port(torch.from_numpy(np.array(stacked)), torch.from_numpy(lengths))
        for g, (name, dim) in enumerate(zip(names, MEMBER_DIMS)):
            enc = te.SequenceEncoder(dim, hidden_dim=H, output_dim=OUT, num_layers=layers,
                                     encoder_type=cell, dropout=0.0)
            prefix = f"encoders.{name}."
            enc.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                                 if k.startswith(prefix)}, strict=True)
            alone = enc.eval()(torch.from_numpy(members[name]), torch.from_numpy(lengths))
            # the same products in the same order but for the padded zero columns
            torch.testing.assert_close(grouped[g], alone, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grouped_rnn_training_route(cell):
    """``use_pallas`` with one layer trains through ``grouped_*_trainable``
    (on the CPU their plain twins): the same output, dropout mask and
    gradients as the scan route from one seed. The scan route trains, with a
    mask on the final state."""
    members, lengths = _group_inputs()
    stacked = tg.stack_group_features({n: torch.from_numpy(v) for n, v in members.items()},
                                      list(members))
    routes = {}
    for use_pallas in (True, False):
        enc = tg.GroupedRNNEncoder(G, 6, hidden_dim=H, output_dim=OUT, cell_type=cell,
                                   dropout=0.3, use_pallas=use_pallas)
        enc.init_parameters(torch.Generator().manual_seed(0))
        out = enc(stacked, torch.from_numpy(lengths), train=True,
                  generator=torch.Generator().manual_seed(1))
        out.square().sum().backward()
        routes[use_pallas] = (out, {n: p.grad for n, p in enc.named_parameters()})
    (got, got_grads), (want, want_grads) = routes[True], routes[False]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        assert torch.isfinite(got_grads[name]).all()
        assert (got_grads[name] - w).abs().max() <= 1e-4 * w.abs().max(), name
    two = tg.GroupedRNNEncoder(G, 6, hidden_dim=H, output_dim=OUT, num_layers=2, use_pallas=True)
    two.init_parameters(torch.Generator().manual_seed(0))
    out = two(stacked, torch.from_numpy(lengths), train=True,
              generator=torch.Generator().manual_seed(1))  # two layers: the scan route
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in two.parameters())
    scan = tg.GroupedRNNEncoder(G, 6, hidden_dim=H, output_dim=OUT, dropout=0.5)
    scan.init_parameters(torch.Generator().manual_seed(0))
    a = scan(stacked, train=True, generator=torch.Generator().manual_seed(1))
    b = scan(stacked, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, scan(stacked))
    scale = H**-0.5
    assert scan.weight_hh_l0.abs().max() <= scale and torch.all(scan.proj_bias == 0)
    assert abs(scan.proj_kernel.std().item() - scale) < 0.25 * scale  # lecun-normal, fan_in H
    with pytest.raises(ValueError, match=r"Expected \[G=3, B, T, D\] input"):
        scan(stacked[:2])


def test_groupable_modalities_matches_jax():
    base = {"type": "sequence", "encoder_type": "lstm", "hidden_dim": 32, "num_layers": 1}
    names = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
    cases = [
        {n: dict(base) for n in names},
        {**{n: dict(base) for n in names[:3]}, "heart_rate": dict(base, encoder_type="gru")},
        {**{n: dict(base) for n in names[:3]}, "heart_rate": dict(base, num_layers=2)},
        {**{n: dict(base) for n in names[:2]},
         "imu_ankle": dict(base, encoder_type="transformer"),
         "heart_rate": dict(base, encoder_type="cnn")},
        {n: {"encoder_type": "gru", "hidden_dim": 16} for n in names},  # by name: no `type`
        {"imu_hand": dict(base)},
        {},
    ]
    for configs in cases:
        assert tg.groupable_modalities(names, configs) == jg.groupable_modalities(names, configs)
    assert tg.groupable_modalities(names, cases[0])[0] == list(names)
    assert tg.groupable_modalities(names, cases[4])[0] == list(names[:3])  # heart_rate: no rule
