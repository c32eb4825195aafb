"""The port's collectives, rank grid, environment and sharding rules
(``paddle_tpu_torch.distributed.{collective,topology,env,mesh}``)
against the JAX package's.

One world of 4 CPU ranks (gloo, one torch thread each) runs every case
(``torch_world.World``); a case over 2 ranks runs on ranks 0-1.  Each
collective's per-rank results are held to the JAX collective run inside
``shard_map`` over as many virtual CPU devices, on the same numpy
inputs; exact for data movement, 1e-6 for the sums (the two packages
add in different orders)."""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.distributed.model_adapter import BertAdapter as JaxBert
from paddle_tpu.distributed.topology import \
    CommunicateTopology as JaxTopology
from paddle_tpu.models.bert import BERT_CONFIGS as JAX_BERT
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init

from paddle_tpu_torch.distributed import EngineConfig, HybridEngine, mesh
from paddle_tpu_torch.distributed.model_adapter import BertAdapter
from paddle_tpu_torch.distributed.topology import (CommunicateTopology,
                                                   axis_groups)
from paddle_tpu_torch.models import BERT_CONFIGS, GPT_CONFIGS
from torch_world import World

SUM_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _jax_per_rank(fn, inputs):
    """``fn(x, group)`` in ``shard_map`` over len(inputs) devices, rank i
    fed ``inputs[i]``; returns the per-rank results stacked."""
    n = len(inputs)
    m = Mesh(np.array(jax.devices()[:n]), ("x",))
    g = jcoll.Group(axis_name="x")
    f = jax.shard_map(lambda x: fn(x[0], g)[None], mesh=m,
                      in_specs=JP("x"), out_specs=JP("x"), check_vma=False)
    return np.asarray(jax.jit(f)(np.stack(inputs)))


def _inputs(n, shape, seed=0, same=False):
    rng = np.random.RandomState(seed)
    if same:
        a = rng.randn(*shape).astype(np.float32)
        return [a] * n
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _perms(n):
    return {"shift": [(i, (i + 1) % n) for i in range(n)],
            "partial": [(0, n - 1)]}


CASES = [
    # (id, port op, kw, input shape, same inputs, the JAX call)
    ("all_reduce_sum", "all_reduce_sum", {}, (3, 5), False,
     lambda x, g: jcoll.all_reduce(x, op="sum", group=g)),
    ("all_reduce_max", "all_reduce_max", {}, (3, 5), False,
     lambda x, g: jcoll.all_reduce(x, op="max", group=g)),
    ("all_reduce_min", "all_reduce_min", {}, (3, 5), False,
     lambda x, g: jcoll.all_reduce(x, op="min", group=g)),
    ("all_reduce_prod", "all_reduce_prod", {}, (3, 5), False,
     lambda x, g: jcoll.all_reduce(x, op="prod", group=g)),
    ("all_reduce_avg", "all_reduce_avg", {}, (3, 5), False,
     lambda x, g: jcoll.all_reduce(x, op="avg", group=g)),
    ("reduce", "reduce", {}, (4,), False,
     lambda x, g: jcoll.reduce(x, dst=1, group=g)),
    ("all_gather_axis0", "all_gather", {"axis": 0}, (2, 3), False,
     lambda x, g: jcoll.all_gather(x, group=g, axis=0)),
    ("all_gather_axis1", "all_gather", {"axis": 1}, (2, 3), False,
     lambda x, g: jcoll.all_gather(x, group=g, axis=1)),
    ("broadcast", "broadcast", {"src": 1}, (6,), False,
     lambda x, g: jcoll.broadcast(x, src=1, group=g)),
    ("reduce_scatter", "reduce_scatter", {}, (8, 3), False,
     lambda x, g: jcoll.reduce_scatter(x, group=g)),
    ("all_to_all_0_0", "all_to_all", {"split_axis": 0, "concat_axis": 0},
     (8, 3), False, lambda x, g: jcoll.all_to_all(
         x, group=g, split_axis=0, concat_axis=0)),
    ("all_to_all_1_2", "all_to_all", {"split_axis": 1, "concat_axis": 2},
     (2, 4, 3), False, lambda x, g: jcoll.all_to_all(
         x, group=g, split_axis=1, concat_axis=2)),
    ("all_to_all_2_1", "all_to_all", {"split_axis": 2, "concat_axis": 1},
     (2, 3, 8), False, lambda x, g: jcoll.all_to_all(
         x, group=g, split_axis=2, concat_axis=1)),
    # the JAX split's section count is the group size: built per n below
    ("split_axis1", "split", {"axis": 1}, (3, 8), False, None),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_collective_matches_jax_shard_map(world, case, n):
    cid, op, kw, shape, same, jfn = case
    inputs = _inputs(n, shape, seed=len(cid), same=same)
    if jfn is None:
        jfn = lambda x, g: jcoll.split(x, n, axis=1, group=g)  # noqa: E731
    want = _jax_per_rank(jfn, inputs)
    got = world.run("torch_dist_cases", "collective_case", op, n, inputs,
                    kw)
    assert all(r is None for r in got[n:])
    tol = SUM_TOL if op.startswith(("all_reduce", "reduce")) else \
        dict(atol=0, rtol=0)
    for i in range(n):
        np.testing.assert_allclose(got[i], want[i], err_msg=f"rank {i}",
                                   **tol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["shift", "partial"])
def test_ppermute_matches_jax(world, n, kind):
    perm = _perms(n)[kind]
    inputs = _inputs(n, (2, 3), seed=7)
    want = _jax_per_rank(lambda x, g: jcoll.ppermute(x, perm, group=g),
                         inputs)
    got = world.run("torch_dist_cases", "collective_case", "ppermute", n,
                    inputs, {"perm": perm})
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("n", [2, 4])
def test_list_forms_and_scatter_match_jax(world, n):
    """The list forms of all_gather and all_to_all, and scatter of a
    list (every rank holding the same list, as under SPMD)."""
    inputs = _inputs(n, (n, 3), seed=3)
    want = _jax_per_rank(lambda x, g: jax.numpy.stack(
        jcoll.all_to_all(list(x), group=g)), inputs)
    got = world.run("torch_dist_cases", "collective_case",
                    "all_to_all_list", n, inputs, {})
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])
    inputs = _inputs(n, (3,), seed=4)
    want = _jax_per_rank(lambda x, g: jax.numpy.stack(
        jcoll.all_gather([], x, group=g)), inputs)
    got = world.run("torch_dist_cases", "collective_case",
                    "all_gather_list", n, inputs, {})
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])
    inputs = _inputs(n, (n, 3), seed=5, same=True)
    want = _jax_per_rank(lambda x, g: jcoll.scatter(
        x[0], tensor_list=list(x), group=g), inputs)
    got = world.run("torch_dist_cases", "collective_case", "scatter", n,
                    inputs, {})
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("n", [2, 4])
def test_send_recv_and_barrier(world, n):
    """Point-to-point messages (the JAX package raises on send/recv:
    SPMD has no one-sided send): each rank gets the previous rank's."""
    got = world.run("torch_dist_cases", "send_recv_barrier", n)
    for i in range(n):
        np.testing.assert_array_equal(got[i], np.full(3, (i - 1) % n,
                                                      np.float32))


@pytest.mark.parametrize("degrees", [
    dict(dp_degree=4), dict(dp_degree=2, mp_degree=2),
    dict(sharding_degree=2, sep_degree=2), dict(sep_degree=2, ep_degree=2),
    dict(dp_degree=2, mp_degree=2, pp_degree=1)])
def test_env_contract_and_topology_groups_match_jax(world, degrees):
    """``init_parallel_env`` from the launcher's contract, and each rank's
    group along every axis equal to the JAX topology's comm list that
    holds it."""
    res = world.run("torch_dist_cases", "env_and_groups", degrees)
    names = ("data", "pipe", "sharding", "sep", "expert", "model")
    keys = ("dp", "pp", "sharding", "sep", "ep", "mp")
    dims = [degrees.get(f"{k}_degree", 1) for k in keys]
    jt = JaxTopology(names, dims)
    pt = CommunicateTopology(names, dims)
    for name, key in zip(names, keys):
        assert pt.get_comm_list(name) == jt.get_comm_list(name)
        for r in range(4):
            row = next(row for row in jt.get_comm_list(name) if r in row)
            assert res[r]["groups"][key] == row, (key, r)
    for r in range(4):
        assert res[r]["rank"] == r and res[r]["world_size"] == 4
        assert res[r]["local_rank"] == r and res[r]["nranks"] == 4
        assert res[r]["device"] == "cpu"
        assert jt.get_coord(r) == tuple(res[r]["coords"][k] for k in keys)
        check = axis_groups(dims, [1, 2, 5])
        assert res[r]["check"] == next(c for c in check if r in c)


@pytest.mark.parametrize("axes", [dict(dp=2, mp=4), dict(dp=4, mp=2),
                                  dict(dp=2, mp=2, pp=2, sharding=2)])
def test_replica_peers_match_jax(axes):
    n = int(np.prod(list(axes.values())))
    for rank in range(n):
        for axis in ("dp", "mp", "pp", "sharding"):
            assert mesh.replica_peers(rank, axes, axis) == \
                jmesh.replica_peers(rank, axes, axis)
    with pytest.raises(ValueError):
        mesh.replica_peers(n, axes)
    with pytest.raises(ValueError):
        mesh.replica_peers(0, axes, "nope")


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _jax_tree(cfg):
    return jax.tree_util.tree_map(np.asarray, jax_gpt_init(
        cfg, jax.random.key(0)))


@pytest.mark.parametrize("moe", [0, 4])
def test_rule_table_and_zero_specs_match_jax(moe):
    """``param_specs`` (the GSPMD rule table, pruned against the mesh)
    and ``zero_opt_specs`` of the GPT and MoE trees equal JAX's."""
    import dataclasses

    cfg = dataclasses.replace(JAX_CONFIGS["tiny"], moe_experts=moe)
    tree = _jax_tree(cfg)
    for dp, mp, sharding in ((2, 2, 2), (1, 4, 2), (2, 1, 4)):
        jm = jmesh.build_mesh(dp=dp, mp=mp, sharding=sharding)
        sizes = {"dp": dp, "mp": mp, "pp": 1, "sharding": sharding}
        js = jmesh.param_specs(tree, jm)
        ps = mesh.param_specs(tree, sizes)
        assert _spec_tuples(ps) == _spec_tuples(js)
        slots = {k: {"m": v, "v": v} for k, v in tree.items()
                 if not isinstance(v, dict)}
        aux_js = {k: js[k] for k in slots}
        aux_ps = {k: ps[k] for k in slots}
        assert _spec_tuples(mesh.zero_opt_specs(aux_ps, slots, sizes)) == \
            _spec_tuples(jmesh.zero_opt_specs(aux_js, slots, jm))


@pytest.mark.parametrize("moe", [0, 4])
def test_engine_param_specs_match_jax(moe):
    """The engine's layout (the model adapter's ``param_specs``) for the
    GPT, MoE GPT and BERT trees equals the JAX engine's at ZeRO-2."""
    import dataclasses

    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], moe_experts=moe)
    pcfg = dataclasses.replace(GPT_CONFIGS["tiny"], moe_experts=moe)
    je = JaxEngine(jcfg, devices=jax.devices()[:1])
    pe = HybridEngine(pcfg, device="cpu", engine_cfg=EngineConfig())
    assert _spec_tuples(pe.param_specs()) == _spec_tuples(je.param_specs())
    if not moe:
        jb = JaxEngine(JaxBert(JAX_BERT["tiny"]), devices=jax.devices()[:1],
                       engine_cfg=JaxEngineConfig())
        pb = HybridEngine(BertAdapter(BERT_CONFIGS["tiny"]), device="cpu")
        assert _spec_tuples(pb.param_specs()) == \
            _spec_tuples(jb.param_specs())


def test_shard_and_gather_tree_round_trip(world):
    """A (dp 2, mp 2) mesh: each rank's shard of every leaf has the shape
    ``assert_placement`` wants, ``placement_report`` counts the distinct
    windows, ``gather_tree`` gives back the full tree on every rank, and
    ``shard_params`` / ``shard_batch`` cut what JAX's rule table and
    batch split place on the rank."""
    rng = np.random.RandomState(0)
    tree = {"wte": rng.randn(8, 6).astype(np.float32),
            "qkv_w": rng.randn(2, 6, 12).astype(np.float32),
            "both": rng.randn(4, 8).astype(np.float32),
            "ln_g": rng.randn(6).astype(np.float32)}
    specs = {"wte": ("mp", None), "qkv_w": (None, None, "mp"),
             "both": ("dp", "mp"), "ln_g": (None,)}
    res = world.run("torch_dist_cases", "mesh_round_trip", 2, 2, tree,
                    specs)
    for r in res:
        assert r["shapes"] == {"wte": [4, 6], "qkv_w": [2, 6, 6],
                               "both": [2, 4], "ln_g": [6]}
        for k in tree:
            np.testing.assert_array_equal(r["back"][k], tree[k])
        assert r["report"]["both"]["distinct_windows"] == 4
        assert r["report"]["ln_g"]["distinct_windows"] == 1
    # the rule table (JAX's GPT_RULES): wte and qkv_w split over mp, the
    # rest whole; and the rank's rows of a batch split over dp
    for r in res:
        mp_i, dp_i = r["coords"]["mp"], r["coords"]["dp"]
        np.testing.assert_array_equal(r["ruled"]["wte"],
                                      tree["wte"][mp_i * 4:(mp_i + 1) * 4])
        np.testing.assert_array_equal(
            r["ruled"]["qkv_w"], tree["qkv_w"][..., mp_i * 6:(mp_i + 1) * 6])
        np.testing.assert_array_equal(r["ruled"]["ln_g"], tree["ln_g"])
        np.testing.assert_array_equal(r["rows"],
                                      tree["both"][dp_i * 2:(dp_i + 1) * 2])
    with pytest.raises(AssertionError):
        mesh.assert_placement(np.zeros((8, 6)), (8, 6), {"dp": 2, "mp": 2},
                              mesh.P("mp", None))
