"""PyTorch port, the parallel layouts' rules against the JAX package's, in one
process: ``make_mesh`` (axis orders, shapes, rank grids and error texts) on
the conftest's 8 host devices, ``tp_param_spec`` on the port's parameter
names against the reference's on the same leaves of its tree, ZeRO's
``zero_extend_spec``, ``state_shardings``, the batch shard each rank takes,
``resolve_num_devices``, ``maybe_initialize_distributed`` and the trainer's
``check_layout`` errors. The collectives themselves run in a real world in
``tests/test_torch_port_dist.py``."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.parallel import mesh as jmesh
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.train import trainer as jtrainer
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jload_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import convert
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import mesh as tmesh
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
SMALL = ["model.hidden_dim=16", "model.output_dim=8"]
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")


def _spec(p) -> tuple:
    """A PartitionSpec or a port spec as a tuple without trailing Nones."""
    out = list(p)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,model,dcn,pipe", [
    (8, 1, 1, 1), (4, 1, 1, 1), (8, 2, 1, 1), (8, 4, 1, 1), (8, 1, 2, 1), (8, 2, 2, 1),
    (8, 1, 1, 2), (8, 1, 2, 2), (4, 2, 1, 1), (4, 1, 1, 2), (2, 1, 2, 1), (1, 1, 1, 1),
])
def test_make_mesh_matches_the_reference(n, model, dcn, pipe):
    want = jmesh.make_mesh(n, model_parallel=model, dcn_slices=dcn, pipeline_parallel=pipe)
    got = tmesh.make_mesh(n, devices=range(8), model_parallel=model, dcn_slices=dcn,
                          pipeline_parallel=pipe)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape) and list(got.shape) == list(want.shape)
    np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize("n,model,dcn,pipe,match", [
    (8, 2, 1, 2, "pipeline_parallel and model_parallel cannot be combined"),
    (8, 3, 1, 1, r"model_parallel=3 x dcn_slices=1 x pipeline_parallel=1 must divide the "
                 r"device count \(8\)"),
    (6, 2, 2, 1, r"must divide the device count \(6\)"),
    (8, 1, 3, 1, r"dcn_slices=3 .* must divide the device count \(8\)"),
    (16, 1, 1, 1, "Requested 16 devices but only 8 available"),
])
def test_make_mesh_errors_match_the_reference(n, model, dcn, pipe, match):
    for make, devices in ((jmesh.make_mesh, None), (tmesh.make_mesh, range(8))):
        with pytest.raises(ValueError, match=match):
            make(n, devices=devices, model_parallel=model, dcn_slices=dcn,
                 pipeline_parallel=pipe)


def test_lines_and_indices_follow_the_grid():
    mesh = tmesh.make_mesh(8, devices=range(8), dcn_slices=2, model_parallel=2)
    assert mesh.axis_names == ("dcn", "data", "model")
    assert mesh.lines(["model"]) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.lines(["dcn", "data"]) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [mesh.index(["dcn", "data"], r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert mesh.coords(5) == {"dcn": 1, "data": 0, "model": 1}
    assert tmesh.replicas(("model", "data"), mesh) == 2 and tmesh.replicas((), mesh) == 8


@pytest.mark.parametrize("overrides", [
    [], ["model.moe_experts=4"],
    ["parallel.pipeline_parallel=2", *[f"model.encoders.{m}.num_layers=2" for m in NAMES]],
], ids=["dense", "moe", "pipeline"])
def test_tp_param_spec_on_port_names_matches_the_reference_paths(overrides):
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL + overrides), device="cpu")
    sharded = 0
    for name, param in model.named_parameters():
        *module, leaf = convert._flax_path(name)
        if tmesh.is_pipe_leaf(name):
            # kept in the reference's layout (state_shardings gives them
            # ('pipe',) before this rule is read, in both packages)
            jleaf, transpose = leaf, False
        elif leaf == "weight" and param.dim() == 2 and "moe" not in module:
            jleaf, transpose = "kernel", True
        elif leaf == "weight":
            jleaf, transpose = ("scale" if "moe" not in module else leaf), False
        else:
            jleaf, transpose = leaf, False
        want = list(jmesh.tp_param_spec([*module, jleaf]))
        want += [None] * (param.dim() - len(want))
        if transpose:
            want = want[::-1]
        got = tmesh.tp_param_spec(name.split("."))
        assert _spec(got) == _spec(want), name
        sharded += any(a is not None for a in got)
    # the FFW pair's three leaves or the four expert leaves in each of 4 encoders
    assert sharded == {"dense": 12, "moe": 16, "pipeline": 12}[
        "moe" if overrides[:1] == ["model.moe_experts=4"] else "pipeline" if overrides else "dense"]


@pytest.mark.parametrize("spec,shape,n", [
    ((), (16, 8), 2), ((), (3, 8), 2), ((), (3, 5), 2), (("model",), (16, 8), 4),
    ((None, "model"), (8, 16), 2), (("model", None), (1024, 256), 2), ((), (1,), 2),
    ((), (2, 2), 4), (("pipe",), (2, 16, 32), 2), ((), (4, 4, 8), 4),
])
def test_zero_extend_spec_matches_the_reference(spec, shape, n):
    want = jmesh.zero_extend_spec(P(*spec), shape, n)
    assert _spec(tmesh.zero_extend_spec(spec, shape, n)) == _spec(want)


@pytest.mark.parametrize("model,pipe,zero", [(2, 1, True), (2, 1, False), (1, 2, True),
                                             (1, 1, True)])
def test_state_shardings_match_the_reference(model, pipe, zero):
    """The reference's state_shardings on a train-state tree (params and an
    opt_state mirror) against the port's on the same leaves in its layout."""
    jm = jmesh.make_mesh(8, model_parallel=model, pipeline_parallel=pipe)
    tm = tmesh.make_mesh(8, devices=range(8), model_parallel=model, pipeline_parallel=pipe)
    # (port name, port shape, reference path, reference shape)
    leaves = [
        ("e.layers.0.linear1.weight", (64, 16), ("e", "layer0", "linear1", "kernel"), (16, 64)),
        ("e.layers.0.linear1.bias", (64,), ("e", "layer0", "linear1", "bias"), (64,)),
        ("e.layers.0.linear2.weight", (16, 64), ("e", "layer0", "linear2", "kernel"), (64, 16)),
        ("e.layers.0.linear2.bias", (16,), ("e", "layer0", "linear2", "bias"), (16,)),
        ("e.layers.0.norm1.weight", (16,), ("e", "layer0", "norm1", "scale"), (16,)),
        ("e.layers.0.moe.moe_w1", (4, 16, 64), ("e", "layer0", "moe", "moe_w1"), (4, 16, 64)),
        ("e.layers.0.moe.moe_b2", (4, 16), ("e", "layer0", "moe", "moe_b2"), (4, 16)),
        ("e.pipeline.pipe_layers.linear1.kernel", (2, 16, 64),
         ("e", "pipeline", "pipe_layers", "linear1", "kernel"), (2, 16, 64)),
        ("e.pipeline.pipe_layers.norm1.scale", (2, 16),
         ("e", "pipeline", "pipe_layers", "norm1", "scale"), (2, 16)),
        ("gate.bias", (1,), ("gate", "bias"), (1,)),
    ]
    tree = {}
    for _n, _s, path, shape in leaves:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(shape, np.float32)
    want = jmesh.state_shardings(jm, {"params": tree, "opt_state": tree},
                                 zero_optimizer=zero)
    got = tmesh.state_shardings(tm, {n: s for n, s, _p, _sh in leaves}, zero_optimizer=zero)
    for name, shape, path, _shape in leaves:
        for part, i in (("params", 0), ("opt_state", 1)):
            node = want[part]
            for key in path:
                node = node[key]
            spec = list(node.spec) + [None] * (len(shape) - len(node.spec))
            if path[-1] == "kernel" and "pipe_layers" not in path:
                spec = spec[::-1]
            assert _spec(got[name][i]) == _spec(spec), (name, part)


@pytest.mark.parametrize("dcn", [1, 2])
def test_each_rank_takes_the_reference_batch_shard(dcn):
    jm = jmesh.make_mesh(8, dcn_slices=dcn, model_parallel=2)
    tm = tmesh.make_mesh(8, devices=range(8), dcn_slices=dcn, model_parallel=2)
    rows = np.arange(8 * 3).reshape(8, 3)
    index = jmesh.batch_sharding(jm).devices_indices_map(rows.shape)
    for device, slices in index.items():
        got = tmesh.shard_batch({"x": torch.from_numpy(rows)}, tm, rank=device.id)["x"]
        np.testing.assert_array_equal(got.numpy(), rows[slices])


@pytest.mark.parametrize("requested", [None, "null", "", 1, 2, "4", 8])
def test_resolve_num_devices_matches_the_reference(requested):
    assert tmesh.resolve_num_devices(requested) == jmesh.resolve_num_devices(requested)


def test_resolve_num_devices_auto_is_the_world():
    # the reference's auto is every device of the process (8 host devices
    # here); a port rank is one device, so auto is the world's size
    assert jmesh.resolve_num_devices("auto") == len(jax.devices())
    assert tmesh.resolve_num_devices("auto") == 1  # no world started here


def test_maybe_initialize_distributed_is_a_no_op_without_an_address(monkeypatch):
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda *a, **k: calls.append(a))
    assert tmesh.maybe_initialize_distributed({}) is False
    assert tmesh.maybe_initialize_distributed({"coordinator_address": None}) is False
    with pytest.raises(ValueError, match="needs parallel.num_processes"):
        tmesh.maybe_initialize_distributed({"coordinator_address": "localhost:1"})
    assert not calls


def test_maybe_initialize_distributed_passes_the_reference_keys(monkeypatch):
    calls, meets = [], []
    monkeypatch.setattr(tmesh, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(tmesh.dist, "PrefixStore", lambda prefix, store: (prefix, store))
    monkeypatch.setattr(tmesh, "_rendezvous",
                        lambda *a: meets.append(a) or ("store", ["h"] * 4))
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **k: calls.append((backend, k)))
    cfg = {"coordinator_address": "host:1234", "num_processes": 4, "process_id": 3}
    assert tmesh.maybe_initialize_distributed(cfg, device="cpu") is True
    assert meets == [("host:1234", 4, 3)]
    assert calls == [("gloo", {"store": ("world", "store"), "world_size": 4, "rank": 3})]
    assert tmesh.maybe_initialize_distributed(cfg, device="cpu") is True  # idempotent
    assert len(calls) == 1


def test_rendezvous_shares_every_rank_host_through_the_store():
    import socket

    with socket.socket() as sock:  # a free localhost port
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    store, hosts = tmesh._rendezvous(f"tcp://localhost:{port}", 1, 0)
    assert hosts == [socket.gethostname()]
    with pytest.raises(ValueError, match="takes host:port"):
        tmesh._rendezvous("file:///tmp/x", 1, 0)


# (hosts of the world's ranks, cards a host, device): each rank's local rank,
# the backend and the card it takes (None on the CPU)
BACKEND_CASES = {
    "2 hosts x 4 cards, 8 ranks": (["a"] * 4 + ["b"] * 4, 4, "cuda",
                                   [(r % 4, "nccl", r % 4) for r in range(8)]),
    "1 host, 4 ranks on 1 card": (["a"] * 4, 1, "cuda", [(r, "gloo", 0) for r in range(4)]),
    "1 host, 1 rank on 1 card": (["a"], 1, "cuda", [(0, "nccl", 0)]),
    "2 hosts x 1 card, 4 ranks": (["a", "b", "a", "b"], 1, "cuda",
                                  [(0, "gloo", 0), (0, "gloo", 0), (1, "gloo", 0),
                                   (1, "gloo", 0)]),
    "2 hosts, 8 ranks on the CPU": (["a"] * 4 + ["b"] * 4, 0, "cpu",
                                    [(r % 4, "gloo", None) for r in range(8)]),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_each_rank_takes_its_backend_and_card_from_its_host(case, monkeypatch):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import comm

    hosts, cards, device, want = BACKEND_CASES[case]
    for rank, (local, backend, card) in enumerate(want):
        assert comm.local_ranks(hosts, rank) == (local, hosts.count(hosts[rank]))
        assert comm.choose_backend(torch.device(device), hosts.count(hosts[rank]),
                                   cards) == backend
        calls, taken = [], []
        monkeypatch.setattr(tmesh, "_DISTRIBUTED_INITIALIZED", False)
        monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
        monkeypatch.setattr(tmesh.dist, "PrefixStore", lambda prefix, store: store)
        monkeypatch.setattr(tmesh, "_rendezvous", lambda *a: (None, hosts))
        monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(tmesh.torch.cuda, "set_device", taken.append)
        monkeypatch.setattr(tmesh.dist, "init_process_group",
                            lambda b, **k: calls.append(b))
        cfg = {"coordinator_address": "h:1", "num_processes": len(hosts), "process_id": rank}
        assert tmesh.maybe_initialize_distributed(cfg, device=device) is True
        assert calls == [backend]
        assert taken == ([] if card is None else [card])


@pytest.mark.parametrize("overrides", [
    ["parallel.num_devices=4", "parallel.model_parallel=2", "parallel.pipeline_parallel=2"],
    ["parallel.sequence_parallel=true"],
    ["parallel.num_devices=4", "parallel.model_parallel=3", "model.moe_experts=4"],
    ["parallel.model_parallel=2"],
    ["parallel.dcn_slices=2"],
    ["parallel.pipeline_parallel=2"],
    ["parallel.zero_optimizer=true"],
    ["training.prng_impl=philox"],
])
def test_check_layout_raises_the_reference_errors(overrides):
    jcfg = jload_config(REPO / "config" / "base.yaml", SMALL + overrides)
    with pytest.raises(ValueError) as want:
        jtrainer.Trainer(jcfg)._ensure_mesh()
    with pytest.raises(ValueError) as got:
        tt.check_layout(load_config(REPO / "config" / "base.yaml", SMALL + overrides))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [
    [], ["parallel.num_devices=auto"], ["parallel.num_devices=8", "parallel.model_parallel=2"],
    ["parallel.num_devices=8", "parallel.dcn_slices=2", "parallel.zero_optimizer=true"],
    ["parallel.num_devices=8", "parallel.pipeline_parallel=2", "parallel.microbatches=4"],
    ["parallel.num_devices=8", "parallel.model_parallel=2", "parallel.sequence_parallel=true",
     "model.moe_experts=4"],
])
def test_check_layout_accepts_what_the_reference_accepts(overrides):
    jcfg = jload_config(REPO / "config" / "base.yaml", SMALL + overrides)
    jtrainer.Trainer(jcfg)  # the reference builds it
    tt.check_layout(load_config(REPO / "config" / "base.yaml", SMALL + overrides))


@pytest.mark.parametrize("overrides,axis", [
    (["model.moe_experts=4"], "model"), ([], "model"),
    (["parallel.pipeline_parallel=2", *[f"model.encoders.{m}.num_layers=2" for m in NAMES]],
     "pipe"),
], ids=["experts", "ffw_pair", "pipe_layers"])
def test_scatter_state_dict_cuts_the_whole_tree_into_rank_pieces(overrides, axis):
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL + overrides), device="cpu")
    whole = model.state_dict()
    mesh = tmesh.make_mesh(4, devices=range(4), **({"model_parallel": 2} if axis == "model"
                                                     else {"pipeline_parallel": 2}))
    pieces = [convert.scatter_state_dict(whole, mesh, rank=r) for r in range(4)]
    specs = tmesh.state_shardings(mesh, {k: tuple(v.shape) for k, v in whole.items()})
    cut = 0
    for name, tensor in whole.items():
        spec = specs[name][0] if name in specs else ()
        if axis not in spec:
            assert all(torch.equal(p[name], tensor) for p in pieces), name
            continue
        cut += 1
        dim = spec.index(axis)
        # ranks 0 and 1 differ on the axis (the mesh's last), ranks 0 and 2 on data
        torch.testing.assert_close(torch.cat([pieces[0][name], pieces[1][name]], dim), tensor)
        assert torch.equal(pieces[0][name], pieces[2][name])
    assert cut == {"experts": 16, "ffw_pair": 12, "pipe_layers": 64}[
        "experts" if overrides[:1] == ["model.moe_experts=4"] else
        "pipe_layers" if overrides else "ffw_pair"]
