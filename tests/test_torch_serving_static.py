"""The port's static-shape serving step against the JAX package's.

``gpt_ragged_step`` writes every one of its ``T`` packed tokens to a
target fixed by the shapes (a valid token its page slot, a padding or
invalid token the pool's scratch page and a spare query row), so it
reads nothing on the host and the engine can replay it from a CUDA
graph.  Here, on the CPU at ``tiny`` fp32 with the JAX parameters
carried across: the step's logits (1e-4) and pages (the JAX pool's
``P`` pages, 1e-4) equal JAX's on batches with padding tokens, idle rows
and a token budget far above the valid tokens; a MoE model routes every
(token, expert, slot) cell as JAX does; the step calls no operation
whose result's shape or value the host must wait for; the pool's
storage never moves (defrag writes in place); and the served greedy
tokens, with a ``defrag()`` in the middle, equal the JAX engine's."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

import paddle_tpu.distributed.moe as jax_moe
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.models.gpt import gpt_ragged_step as jax_ragged_step
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import PagedKVCache as JaxCache
from paddle_tpu.serving import SamplingParams as JaxSampling
import paddle_tpu_torch.distributed.moe as moe
from paddle_tpu_torch.models import GPT_CONFIGS, gpt_ragged_step, \
    params_from_jax
from paddle_tpu_torch.serving import Engine, PagedKVCache, SamplingParams

torch.set_num_threads(1)

# the two sides sum products in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
MOE = dict(moe_experts=4, moe_capacity_factor=1.0)


@pytest.fixture(scope="module")
def dense():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jcfg, jparams, cfg, params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def moe_model():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32", **MOE)
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32", **MOE)
    jparams = jax_gpt_init(jcfg, jax.random.key(1), dtype=jnp.float32)
    return jcfg, jparams, cfg, params_from_jax(jparams, device="cpu")


# ------------------------------------------------------------ the batches

# (query_lens, context_lens, token budget T, extra invalid tokens)
BATCHES = {
    # a chunk, two decode rows, an idle row, padding past them and one
    # token of row 1 past its query_len
    "chunk_decode_idle": ([5, 1, 1, 0], [9, 14, 7, 0], 12, [(1, 1)]),
    # a budget four times the valid tokens: 26 padding slots
    "budget_far_above_valid": ([3, 0, 2, 1], [3, 0, 30, 21], 32, []),
    # every row decoding, every padding slot after them
    "all_decode": ([1, 1, 1, 1], [40, 2, 17, 64], 10, []),
    # one idle batch row between two chunks, and the first row idle
    "idle_rows_between": ([0, 6, 0, 4], [0, 6, 0, 28], 16, [(3, 5)]),
}


def _batch(cfg, name, seed=0):
    """The packed step of ``BATCHES[name]`` over random older context in
    a JAX pool of ``P`` pages (tables never share a page).  Returns the
    step's arrays as numpy."""
    qlens, ctxs, T, extra = BATCHES[name]
    rng = np.random.RandomState(seed)
    B, ps, P, max_q = len(qlens), 4, 96, 8
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    width = cfg.max_seq_len // ps
    rows, slots = [], []
    for b, n in enumerate(qlens):
        rows += [b] * n
        slots += list(range(n))
    for b, slot in extra:                   # invalid: slot >= query_len
        rows.append(b)
        slots.append(slot)
    rows += [B] * (T - len(rows))
    slots += [0] * (T - len(slots))
    tables = np.zeros((B, width), np.int32)
    live = rng.permutation(P)[:B * 16].reshape(B, 16)
    tables[:, :16] = live
    return dict(
        tokens=rng.randint(0, cfg.vocab_size, T).astype(np.int32),
        rows=np.asarray(rows, np.int32), slots=np.asarray(slots, np.int32),
        qlens=np.asarray(qlens, np.int32), ctxs=np.asarray(ctxs, np.int32),
        kp=rng.standard_normal((L, P, ps, H, hd)).astype(np.float32),
        vp=rng.standard_normal((L, P, ps, H, hd)).astype(np.float32),
        tables=tables, max_q=max_q)


ARGS = ("tokens", "rows", "slots", "qlens", "ctxs")


def _jax_step(jcfg, jparams, d):
    logits, k, v = jax_ragged_step(
        jcfg, jparams, *(jnp.asarray(d[k]) for k in ARGS),
        jnp.asarray(d["kp"]), jnp.asarray(d["vp"]), jnp.asarray(d["tables"]),
        max_q=d["max_q"])
    return np.asarray(logits), np.asarray(k), np.asarray(v)


def _port_inputs(d):
    """The port step's arguments for ``d``: its pool plus a scratch page
    of NaNs (any read of it would poison the logits)."""
    t = {k: torch.from_numpy(np.array(d[k])) for k in ARGS + ("tables",)}
    kp, vp = (torch.cat([torch.from_numpy(d[k]),
                         torch.full_like(torch.from_numpy(d[k][:, :1]),
                                         float("nan"))], dim=1)
              for k in ("kp", "vp"))
    return (*(t[k] for k in ARGS), kp, vp, t["tables"])


def _port_step(cfg, params, d):
    """Logits and the full pools, scratch page included, as numpy."""
    logits, kp, vp = gpt_ragged_step(cfg, params, *_port_inputs(d),
                                     max_q=d["max_q"])
    return logits.numpy(), kp.numpy(), vp.numpy()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_static_step_matches_jax(dense, name):
    jcfg, jparams, cfg, params = dense
    d = _batch(cfg, name)
    jl, jk, jv = _jax_step(jcfg, jparams, d)
    tl, tk, tv = _port_step(cfg, params, d)
    P = d["kp"].shape[1]
    live = d["qlens"] > 0
    assert np.isfinite(tl[live]).all()
    np.testing.assert_allclose(tl[live], jl[live], **TOL)
    np.testing.assert_allclose(tk[:, :P], jk, **TOL)
    np.testing.assert_allclose(tv[:, :P], jv, **TOL)


def test_padding_writes_only_the_scratch_page(dense):
    """Every padding and invalid token lands in the scratch page (which
    starts as NaN and ends written where they went); the pages a table
    points to change exactly at the valid tokens' slots."""
    _, _, cfg, params = dense
    d = _batch(cfg, "chunk_decode_idle")
    _, tk, _ = _port_step(cfg, params, d)
    P, ps = d["kp"].shape[1], d["kp"].shape[2]
    B = len(d["qlens"])
    written = np.zeros((P, ps), bool)
    scratch = np.zeros(ps, bool)
    for r, s in zip(d["rows"], d["slots"]):
        rc = min(r, B - 1)
        pos = d["ctxs"][rc] - d["qlens"][rc] + s
        if r < B and s < d["qlens"][r]:
            written[d["tables"][r, pos // ps], pos % ps] = True
        else:
            scratch[max(0, min(pos, cfg.max_seq_len - 1)) % ps] = True
    np.testing.assert_array_equal(tk[:, :P][:, ~written],
                                  d["kp"][:, ~written])
    assert np.isfinite(tk[:, P][:, scratch]).all()
    assert np.isnan(tk[:, P][:, ~scratch]).all()


class _HostReads(TorchFunctionMode):
    """Records every call whose result the host would have to wait for
    on a device: a data-dependent shape (``nonzero``, boolean-mask
    indexing) or a value read (``item``, ``tolist``, ``bool``)."""

    READS = {"nonzero", "argwhere", "masked_select", "unique", "item",
             "tolist", "__bool__", "__int__", "__float__", "numpy", "cpu"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        index = args[1] if name in ("__getitem__", "__setitem__",
                                    "index_put_", "index_put") \
            and len(args) > 1 else ()
        index = index if isinstance(index, (tuple, list)) else (index,)
        if name in self.READS or any(
                torch.is_tensor(i) and i.dtype == torch.bool for i in index):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_step_calls_nothing_the_host_waits_for(dense, moe_model, model):
    """The CPU stand-in of the card's ``set_sync_debug_mode("error")``
    check: no op of the step (MoE routing, dispatch and combine
    included) has a data-dependent shape or reads a value."""
    _, _, cfg, params = dense if model == "dense" else moe_model
    d = _batch(cfg, "budget_far_above_valid")
    args = _port_inputs(d)
    with _HostReads() as mode:
        gpt_ragged_step(cfg, params, *args, max_q=d["max_q"])
    assert mode.seen == []


def test_moe_routing_matches_jax_cell_for_cell(moe_model, monkeypatch):
    """The MoE step with 26 padding slots in a 32-token budget: every
    layer's dispatch (token, expert, slot) cells equal JAX's, logits
    and pages at 1e-4."""
    jcfg, jparams, cfg, params = moe_model
    d = _batch(cfg, "budget_far_above_valid")
    jax_seen, port_seen = [], []
    jax_layer, port_route = jax_moe.moe_layer, moe.moe_route

    def jax_spy(p, x, **kw):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, dispatch, _ = jax_moe.moe_gating(
            xt @ p["gate_w"].astype(jnp.float32), top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"])
        jax.debug.callback(lambda a: jax_seen.append(np.asarray(a)),
                           dispatch)
        return jax_layer(p, x, **kw)

    def port_spy(logits, **kw):
        r = port_route(logits, **kw)
        port_seen.append(r)
        return r

    monkeypatch.setattr(jax_moe, "moe_layer", jax_spy)
    monkeypatch.setattr(moe, "moe_route", port_spy)
    jl, jk, jv = _jax_step(jcfg, jparams, d)
    tl, tk, tv = _port_step(cfg, params, d)
    P = d["kp"].shape[1]
    live = d["qlens"] > 0
    np.testing.assert_allclose(tl[live], jl[live], **TOL)
    np.testing.assert_allclose(tk[:, :P], jk, **TOL)
    np.testing.assert_allclose(tv[:, :P], jv, **TOL)
    assert len(jax_seen) == len(port_seen) == cfg.num_layers
    for jd, r in zip(jax_seen, port_seen):
        cells = np.zeros(jd.shape, bool)
        for tok, k in zip(*np.nonzero(r.dispatched.numpy())):
            cells[tok, r.expert[tok, k], r.slot[tok, k]] = True
        np.testing.assert_array_equal(cells, jd)


# --------------------------------------------------------------- the pool


def test_pool_has_a_scratch_page_the_allocator_never_hands_out():
    c = PagedKVCache(num_layers=2, num_heads=2, head_dim=4, num_pages=8,
                     page_size=4, max_seq_len=32, device="cpu")
    assert c.k_pages.shape == c.v_pages.shape == (2, 9, 4, 2, 4)
    assert c.allocate("a", 32)
    assert not c.allocate("b", 1)              # the 8 pages are taken
    assert sorted(c.page_table("a")) == list(range(8))


def test_defrag_writes_in_place_and_matches_jax():
    """The port's defrag moves the same pages as JAX's, keeps the pool's
    storage (a captured graph's addresses stay valid) and leaves the
    scratch page alone."""
    kw = dict(num_layers=2, num_heads=2, head_dim=4, num_pages=12,
              page_size=4, max_seq_len=32)
    jc, tc = JaxCache(**kw, dtype=jnp.float32), \
        PagedKVCache(**kw, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    pages = rng.standard_normal(jc.k_pages.shape).astype(np.float32)
    jc.k_pages = jnp.asarray(pages)
    tc.k_pages[:, :12] = torch.from_numpy(pages)
    tc.k_pages[:, 12] = 7.0
    for c in (jc, tc):
        c.allocate("hole", 9)
        c.allocate("a", 6)
        c.allocate("b", 3)
        c.free("hole")
    ptrs = (tc.k_pages.data_ptr(), tc.v_pages.data_ptr())
    assert tc.defrag() == jc.defrag() > 0
    assert (tc.k_pages.data_ptr(), tc.v_pages.data_ptr()) == ptrs
    for sid in ("a", "b"):
        assert tc.page_table(sid) == jc.page_table(sid)
    np.testing.assert_array_equal(tc.k_pages[:, :12].numpy(),
                                  np.asarray(jc.k_pages))
    assert (tc.k_pages[:, 12] == 7.0).all()


# ------------------------------------------------------- the served tokens


def test_served_tokens_with_defrag_midway_equal_jax(dense):
    """Mixed chunk and decode steps with a ``defrag()`` while requests
    are mid-decode (after a pinned hole is freed): the port's greedy
    tokens equal the JAX engine's, and the pages moved are the same."""
    jcfg, jparams, cfg, params = dense
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (23, 5, 40, 9)]

    def drive(eng, SP):
        eng.cache.allocate("hole", 24)
        sp = SP(max_new_tokens=12)
        reqs = [eng.add_request(p, sp) for p in prompts]
        for _ in range(6):
            eng.step()
        eng.cache.free("hole")
        moved = eng.cache.defrag()
        eng.cache.check_integrity()
        while eng.has_work():
            eng.step()
        return [r.output for r in reqs], moved

    kw = dict(page_size=4, num_pages=64, max_batch_size=3, chunk_len=8)
    je = JaxEngine(jcfg, jparams, **kw)
    te = Engine(cfg, params, device="cpu", **kw)
    (a, ma), (b, mb) = drive(je, JaxSampling), drive(te, SamplingParams)
    assert ma == mb > 0
    assert a == b
    assert all(len(out) == 12 for out in b)
