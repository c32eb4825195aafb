"""The port's serving engine and paged KV cache against the JAX package's.

Both engines run ``tiny`` at fp32 with the same parameters (the JAX
``gpt_init`` tree carried across) and must give token-identical greedy
output: ragged batches with admission mid-decode, prompts longer than
``chunk_len``, preemption under a small pool, prefix-cache hits
(including the fully-cached copy-on-write case) and defrag with shared
pages.  The bookkeeping tests run the JAX suite's cache scenarios on the
port's cache."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax
from paddle_tpu_torch.serving import (Engine, PagedKVCache, RequestState,
                                      SamplingParams, ServingMetrics,
                                      prefix_hashes)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jcfg, jparams, cfg, params_from_jax(jparams, device="cpu")


def _both(models, drive, **kw):
    """Run ``drive(engine, SamplingParams)`` on a JAX and a port engine
    built alike; returns (jax result, port result, jax eng, port eng)."""
    jcfg, jparams, cfg, params = models
    je = JaxEngine(jcfg, jparams, **kw)
    te = Engine(cfg, params, device="cpu", **kw)
    return drive(je, JaxSampling), drive(te, SamplingParams), je, te


def _prompts(rng, *lens, vocab=1024):
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in lens]


def test_ragged_batch_with_admission_mid_decode(models):
    rng = np.random.RandomState(7)
    early = _prompts(rng, 6, 9, 17)
    late = _prompts(rng, 4)[0]

    def drive(eng, SP):
        sp = SP(max_new_tokens=10)
        reqs = [eng.add_request(p, sp) for p in early]
        for _ in range(3):
            eng.step()
        reqs.append(eng.add_request(late, sp))
        while eng.has_work():
            eng.step()
        return [r.output for r in reqs]

    a, b, je, te = _both(models, drive, page_size=8, num_pages=64,
                         max_batch_size=2, prefill_len=32)
    assert a == b
    assert te.metrics.snapshot()["requests"] == \
        je.metrics.snapshot()["requests"]
    assert te.cache.num_free_pages == te.cache.num_pages


def test_prompt_longer_than_chunk_is_chunked(models):
    rng = np.random.RandomState(13)
    prompts = _prompts(rng, 100, 15, 3)

    def drive(eng, SP):
        out = eng.generate(prompts, SP(max_new_tokens=4))
        return out, eng.metrics.snapshot()["tokens"]

    (a, ta), (b, tb), _, _ = _both(models, drive, page_size=8,
                                   num_pages=64, max_batch_size=2,
                                   chunk_len=16)
    assert a == b and ta == tb
    assert tb["prefill_chunks"] >= 100 // 16 + 2


def test_preemption_under_a_small_pool(models):
    rng = np.random.RandomState(3)
    prompts = _prompts(rng, 14, 14)

    def drive(eng, SP):
        out = eng.generate(prompts, SP(max_new_tokens=20))
        return out, eng.metrics.requests_preempted.value

    (a, pa_), (b, pb), _, _ = _both(models, drive, page_size=8,
                                    num_pages=6, max_batch_size=2,
                                    prefill_len=32)
    assert a == b
    assert pb == pa_ > 0


def test_prefix_cache_hits_and_full_prompt_cow(models):
    rng = np.random.RandomState(41)
    system = _prompts(rng, 16)[0]
    tails = _prompts(rng, 5, 9)

    def drive(eng, SP):
        sp = SP(max_new_tokens=6)
        outs = [eng.generate([system + tails[0]], sp)[0]]
        b = eng.add_request(system + tails[1], sp)   # hit, mid-chunk start
        eng.step()
        resumed = b.prompt_pos
        while eng.has_work():
            eng.step()
        outs.append(b.output)
        # an identical page-aligned prompt, twice: the final page is
        # copied on write, the cached original must stay intact
        outs += [eng.generate([system], sp)[0] for _ in range(2)]
        eng.cache.check_integrity()
        return outs, resumed, eng.cache.prefix_stats()

    (a, ra, sa), (b, rb, sb), _, te = _both(models, drive, page_size=4,
                                            num_pages=64, max_batch_size=2,
                                            chunk_len=8)
    assert a == b
    assert rb == ra > 16                 # resumed past the cached prefix
    assert sb == sa
    assert sb["hits"] == 3 and sb["hit_tokens"] == 16 + 2 * 15
    assert te.metrics.snapshot()["prefix_cache"]["hits"] == 3


def test_defrag_with_shared_prefix_decodes_identically(models):
    rng = np.random.RandomState(61)
    system = _prompts(rng, 12)[0]
    tails = _prompts(rng, 6, 6)

    def drive(eng, SP):
        eng.cache.allocate("hole", 16)   # pins low pages below everything
        eng.generate([system + [7, 7, 7]], SP(max_new_tokens=2))
        sp = SP(max_new_tokens=10)
        b = eng.add_request(system + tails[0], sp)
        c = eng.add_request(system + tails[1], sp)
        for _ in range(3):
            eng.step()
        shared = eng.cache.page_table(b.id)[:3]
        assert shared == eng.cache.page_table(c.id)[:3]
        eng.cache.free("hole")
        moved = eng.cache.defrag()
        assert moved > 0 and eng.cache.page_table(b.id)[:3] != shared
        assert eng.cache.page_table(b.id)[:3] == \
            eng.cache.page_table(c.id)[:3]
        eng.cache.check_integrity()
        while eng.has_work():
            eng.step()
        return [b.output, c.output], moved

    a, b, _, _ = _both(models, drive, page_size=4, num_pages=64,
                       max_batch_size=2, chunk_len=16)
    assert a == b


def test_sampling_deterministic_and_traced(models):
    """Host-side sampling is the JAX engine's (same numpy draws), and the
    flight recorder shows the chunked lifecycle."""
    rng = np.random.RandomState(5)
    prompts = _prompts(rng, 6, 12)

    def drive(eng, SP):
        return eng.generate(prompts, SP(max_new_tokens=8, temperature=0.8,
                                        top_k=40, top_p=0.9, seed=1234))

    a, b, _, te = _both(models, drive, page_size=8, num_pages=64,
                        max_batch_size=2, chunk_len=4)
    assert a == b
    names = {s["name"] for tr in te.tracer.traces() for s in tr["spans"]}
    assert {"queued", "chunk[0]", "chunk[2]", "decode[1]"} <= names


def test_deadlines_evict_running_and_queued_requests(models):
    rng = np.random.RandomState(9)
    prompts = _prompts(rng, 6, 5, 7)
    now = [0.0]

    def drive(eng, SP):
        now[0] = 0.0
        short, long_ = SP(max_new_tokens=30, ttl_s=1.0), SP(max_new_tokens=3)
        reqs = [eng.add_request(prompts[0], short),
                eng.add_request(prompts[1], short),     # queued behind it
                eng.add_request(prompts[2], long_)]
        eng.step()
        now[0] = 2.0                                    # both TTLs pass
        evicted = sorted(r.id for r in eng.step())
        while eng.has_work():
            eng.step()
        return ([(r.state, r.finish_reason, r.output) for r in reqs],
                evicted, eng.metrics.deadline_evictions.value)

    a, b, _, te = _both(models, drive, page_size=8, num_pages=64,
                        max_batch_size=1, chunk_len=8,
                        clock=lambda: now[0])
    assert a == b
    states, evicted, n = b
    assert [s for s, _, _ in states] == [RequestState.EVICTED] * 2 + \
        [RequestState.FINISHED]
    assert states[0][1] == "deadline" and evicted == [0, 1] and n == 2
    assert te.cache.num_free_pages == te.cache.num_pages


def test_rejection_and_shedding_states(models):
    *_, cfg, params = models
    eng = Engine(cfg, params, page_size=8, num_pages=4, max_batch_size=2,
                 prefill_len=32, shed_queue_high=2, device="cpu",
                 tracer=None)
    r = eng.add_request(list(range(20)), SamplingParams(max_new_tokens=20))
    assert r.state == RequestState.REJECTED
    assert "page pool exhausted" in r.finish_reason
    sp = SamplingParams(max_new_tokens=2)
    queued = [eng.add_request(list(range(4)), sp) for _ in range(2)]
    shed = eng.add_request(list(range(4)), sp)
    assert [q.state for q in queued] == [RequestState.QUEUED] * 2
    assert shed.state == RequestState.RETRY_AFTER and shed.retry_after_s > 0
    while eng.has_work():
        eng.step()
    assert all(q.state == RequestState.FINISHED for q in queued)


# ---------------------------------------------------- cache bookkeeping


def _cache(**kw):
    args = dict(num_layers=2, num_heads=2, head_dim=4, num_pages=8,
                page_size=4, max_seq_len=32, device="cpu")
    args.update(kw)
    return PagedKVCache(**args)


def test_cache_alloc_free_reuse_and_exhaustion():
    c = _cache()
    assert c.allocate("a", 9)            # 3 pages
    assert c.num_used_pages == 3
    assert len(set(c.page_table("a")[:3])) == 3
    assert not c.allocate("b", 24)       # needs 6, only 5 left
    assert c.num_free_pages == 5         # nothing leaked
    c.free("a")
    assert c.allocate("b", 32)           # all 8 pages
    assert c.num_free_pages == 0
    assert c.occupancy() == 1.0


def test_cache_refcounts_and_cow_copy_in_place():
    c = _cache(num_pages=16, max_seq_len=64)
    toks = list(range(12))               # 3 full pages
    assert c.allocate("a", 12)
    for i, p in enumerate(c.page_table("a")[:3]):
        c.k_pages[:, p] = float(i + 1)
        c.v_pages[:, p] = -float(i + 1)
    c.insert_prefix("a", toks)
    c.free("a")
    assert c.num_free_pages == 16
    assert c.allocate_prefixed("b", toks + [99, 98], chunk_tokens=4) == 12
    shared = c.page_table("b")[:3]
    assert c.allocate_prefixed("cw", toks, chunk_tokens=4) == 11
    cow = c.page_table("cw")[:3]
    assert cow[:2] == shared[:2] and cow[2] != shared[2]
    assert torch.equal(c.k_pages[:, cow[2]], c.k_pages[:, shared[2]])
    assert torch.equal(c.v_pages[:, cow[2]], c.v_pages[:, shared[2]])
    c.check_integrity()
    c.free("b")
    c.free("cw")
    c.check_integrity()
    assert c.prefix_stats()["cached_pages"] == 3
    assert c.num_free_pages == 16
    c.reset()
    assert not c.k_pages.any() and c.num_free_pages == 16


def test_cache_pressure_never_reclaims_the_matched_chain():
    c = _cache(num_layers=1, num_heads=1, head_dim=2, num_pages=3,
               max_seq_len=16)
    toks = list(range(12))
    assert c.allocate("a", 12)
    c.insert_prefix("a", toks)
    c.free("a")
    m = c.allocate_prefixed("b", toks + [99, 98, 97, 96], chunk_tokens=8)
    assert m == 4                        # shrunk hit, not a duplicate page
    table = c.page_table("b")[:3]
    assert len(set(table)) == len(table)
    c.check_integrity()
    c.free("b")
    m = c.allocate_prefixed("cw", toks[:8] + [5, 5, 5, 5], chunk_tokens=4)
    c.check_integrity()
    assert c.allocate_prefixed("x", list(range(40, 56)), 16) is None
    assert "x" not in c.seq_ids()


def test_cache_defrag_with_shared_pages_preserves_contents():
    c = _cache(num_pages=16, max_seq_len=64)
    assert c.allocate("hole", 8)
    toks = list(range(8))
    assert c.allocate("a", 8)
    for i, p in enumerate(c.page_table("a")[:2]):
        c.k_pages[:, p] = float(i + 1)
    c.insert_prefix("a", toks)
    assert c.allocate_prefixed("b", toks + [1, 2], chunk_tokens=4) == 8
    before = c.k_pages[:, c.page_table("b")[:3]].clone()
    c.free("hole")
    assert c.defrag() > 0
    c.check_integrity()
    assert c.page_table("a")[:2] == c.page_table("b")[:2]
    assert sorted(set(c.page_table("a")[:2] + c.page_table("b")[:3])) == \
        [0, 1, 2]
    assert torch.equal(c.k_pages[:, c.page_table("b")[:3]], before)
    assert c.defrag() == 0


def test_prefix_hashes_match_the_summary():
    c = _cache(num_pages=16, max_seq_len=64)
    toks = list(range(16))
    assert c.allocate("a", 16)
    c.insert_prefix("a", toks)
    summary = c.prefix_summary()
    assert set(prefix_hashes(toks, 4)) == set(summary["entries"])
    assert len(c.prefix_summary(max_entries=2)["entries"]) == 2


def test_serving_metrics_snapshot_shape():
    m = ServingMetrics()
    m.ttft.observe(0.5, exemplar="t1")
    snap = m.snapshot()
    assert snap["ttft_s"]["count"] == 1 and snap["ttft_s"]["p50"] == 0.5
    assert "exemplars" in snap["ttft_s"]
