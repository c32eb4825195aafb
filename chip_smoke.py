#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build every CUDA kernel of
     the port from the sources in this checkout (one nvcc per source,
     started together);
  2. kernel vs plain version on the card: edge cases (idle rows,
     qlen == ctx, contexts straddling pages and the kv splits, Q == 1
     decode, head dims 16 to 1024) in fp32 and bf16, then the serving
     shape (a 64-token chunk and seven decode rows) and an all-decode
     shape (eight rows at context 2048), with each
     kernel's time, bound, plain-version time and the time of one
     library call computing the same function;
  3. one full-width ``gpt_ragged_step`` of GPT-3 1.3B (bf16, 24 layers)
     on a mixed chunk + decode + idle batch, kernel against the plain
     attention on the same inputs;
  4. the serving engine at GPT-3 1.3B serving 8 seeded requests (one
     pair sharing a 256-token prefix) to completion, with the kernel's
     launch count held to 24 per step;
  5. the flash-attention kernels (forward; the bf16 backward, dQ, dK
     and dV in one kernel; the fp32 dK/dV and dQ) vs their plain
     versions: edge cases (causal and not, ragged S, head dims 32 to 512,
     fp32 and bf16), flash and the ring at head dim 640 through their
     public entries with gradients, then the 1.3B training shapes with
     each kernel's time, bound, plain-version time and the time of
     PyTorch's SDPA (the backward kernel alone and the whole call),
     forward and backward at head dim 256 beside SDPA's, and the
     forward's host time per call with the TMA maps cached and encoded;
  6. one full-width GPT-3 1.3B training step (bf16, 24 layers, batch
     1 x 2048): loss and every gradient with the kernels against the
     same step on the plain attention;
  7. training throughput: ``HybridEngine`` on GPT-3 1.3B, batch 8 x
     2048, remat "dots", fp32 Adam slots with a master: ms/step,
     tokens/s, MFU, peak memory; the loss falls over 10 steps and the
     flash launch counts are held to 48 forward / 24 backward per step;
  8. ring attention's per-pair backward (bf16: one kernel that adds dQ,
     dK and dV into the ring's fp32 sums; fp32: the scalar kernels, then
     the adds; ring-global lse and delta) vs its plain version from
     non-zero starting sums: edge cases (diagonal and full pairs, shard
     lengths 128/256/512, head dims 32, 64, 128, 256 and a zero-padded
     80, fp32 and bf16; dK and dV bit-equal over two runs), then the
     per-rank shapes of the sep=4 training path with the kernel's time,
     bound, plain-version time, the time of PyTorch's flash attention
     backward on the same pair and of the three fp32 adds the route
     before this kernel ran after its two kernels;
  9. ``ring_attention`` with sep=4 vs ``flash_attention`` on the 1.3B
     training shapes: output and grads, and both times;
 10. ring sequence-parallel training: ``HybridEngine(sep=4)`` with
     ``seq_parallel="ring"`` on GPT-3 1.3B, every rank's shard on this
     card, as in phase 7: ms/step, tokens/s, MFU, peak memory, busy
     share; the loss falls, its first step equals phase 7's, and the
     launches per step are held to the ring's schedule (10 live pairs a
     layer: 480 forward, 240 pair backward).
The line before the last is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores

# tolerances of kernel vs plain version, both computing in fp32: fp32
# differs by summation order only; bf16 by one rounding of the output
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
# flash kernels vs plain: fp32 differs by summation order over up to S
# products of unit-variance terms; bf16 by one rounding of each output
TOL_FLASH = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20, reps=10):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's
    time per call (which can exceed a short kernel's) is not timed."""
    fn()                                    # warm up, build, set up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def make_case(torch, *, B, Q, H, hd, P, ps, M, qlens, ctxs, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    tables = torch.stack([torch.randperm(P, generator=g, device="cuda")[:M]
                          for _ in range(B)]).to(torch.int32)
    return (rnd(B, Q, H, hd), rnd(P, ps, H, hd), rnd(P, ps, H, hd), tables,
            torch.tensor(qlens, dtype=torch.int32, device="cuda"),
            torch.tensor(ctxs, dtype=torch.int32, device="cuda"))


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def prepare(torch):
    """fp32 products in full fp32 (the plain versions are held to 1e-4),
    then every kernel built from this checkout's sources; returns the
    build's seconds."""
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def host_us(torch, fn, iters=200):
    """Host microseconds per call of ``fn`` with the device not waited on:
    the wrapper's Python, its allocations and the kernel launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def phase_kernel_vs_plain(torch, pa):
    """Edge cases, then the serving shapes with timings."""
    span = pa.SPLIT_KEYS
    cases = [
        # mid-prefill chunk, decode, idle rows; ctx straddles ps=4 pages
        dict(B=4, Q=6, H=2, hd=128, P=12, ps=4, M=6,
             qlens=[5, 1, 3, 0], ctxs=[7, 8, 9, 0]),
        dict(B=4, Q=6, H=2, hd=128, P=12, ps=4, M=6,
             qlens=[6, 6, 1, 1], ctxs=[7, 8, 9, 24]),
        # qlen == ctx (whole prompt in one chunk), tiles past 16 queries
        dict(B=3, Q=40, H=3, hd=64, P=40, ps=16, M=8,
             qlens=[17, 40, 33], ctxs=[17, 40, 100]),
        # head dims 32 and 256 (other lane widths and key-tile sizes)
        dict(B=2, Q=20, H=2, hd=32, P=20, ps=8, M=10,
             qlens=[20, 1], ctxs=[70, 13]),
        dict(B=2, Q=20, H=2, hd=256, P=20, ps=8, M=10,
             qlens=[19, 1], ctxs=[50, 80]),
        # the kv splits at the serving widths: contexts either side of a
        # split boundary, one key, a 64-token chunk whose tiles merge 5
        # to 8 splits, decode rows at 2048
        dict(B=4, Q=64, H=2, hd=128, P=600, ps=16, M=128,
             qlens=[1, 1, 1, 0], ctxs=[span - 1, span, span + 1, 0]),
        dict(B=4, Q=64, H=2, hd=128, P=600, ps=16, M=128,
             qlens=[64, 1, 1, 40], ctxs=[2048, 1, 2048, 2 * span])
    ] + [
        # head dims off the 64/128-column chunks and past 128: zero-filled
        # tails, one element a load where a row is not a multiple of 16
        # bytes (hd 17 in both dtypes, 100 in bf16), scores summed over
        # head-dim chunks past 128 and one grid slice per output chunk
        dict(B=3, Q=20, H=2, hd=hd, P=20, ps=8, M=10, qlens=[17, 1, 0],
             ctxs=[60, 75, 0])
        for hd in (16, 17, 48, 80, 100, 320, 512, 544, 1024)
    ]
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for seed, c in enumerate(cases):
            q, kp, vp, tb, ql, cl = make_case(torch, dtype=dtype, seed=seed,
                                              **c)
            scale = 1.0 / np.sqrt(c["hd"])
            out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
            ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl, scale)
            torch.cuda.synchronize()
            check(out.dtype == q.dtype and out.shape == q.shape,
                  "kernel output dtype/shape")
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            err = max_err(torch, out, ref)
            check(torch.allclose(out.float(), ref.float(),
                                 **TOL[dtype_name]),
                  f"kernel != plain ({dtype_name}, case {seed}): max abs "
                  f"err {err:.3g}")
            n += 1
        # the Q == 1 decode entry
        q, kp, vp, tb, _, _ = make_case(torch, B=4, Q=1, H=4, hd=128, P=16,
                                        ps=16, M=4, qlens=[1, 1, 1, 0],
                                        ctxs=[9, 4, 64, 0], dtype=dtype,
                                        seed=99)
        seq = torch.tensor([9, 4, 64, 0], dtype=torch.int32, device="cuda")
        out = pa.paged_attention(q[:, 0], kp, vp, tb, seq)
        ref = pa._ragged_attention_ref(
            q, kp, vp, tb, (seq > 0).to(torch.int32), seq,
            1.0 / np.sqrt(128))[:, 0]
        torch.cuda.synchronize()
        check(torch.allclose(out.float(), ref.float(), **TOL[dtype_name]),
              f"decode entry != plain ({dtype_name}): "
              f"{max_err(torch, out, ref):.3g}")
        n += 1
    print(f"[phase 2] {n} edge cases agree (head dims 16, 17, 32, 48, 64, "
          f"80, 100, 128, 256, 320, 512, 544, 1024; kv splits of {span} "
          f"keys; fp32 atol=rtol=1e-5; bf16 atol 1e-2 rtol 1.6e-2)")

    # ---- serving shape: one chunk row of 64 + 7 decode rows, bf16; then
    # every row decoding at the longest context
    res = ragged_shape(torch, pa, "serving shape", [64] + [1] * 7,
                       [1024, 64, 2048, 1500, 700, 300, 128, 2000])
    res["decode_shape"] = ragged_shape(torch, pa, "all-decode shape",
                                       [1] * 8, [2048] * 8)
    return res


def ragged_shape(torch, pa, name, qlens, ctxs):
    """The kernel against the plain version at one batch of the serving
    engine's shapes (q [8, 64, 16, 128] bf16 over pages [2048, 16, 16,
    128]), then its time, the plain version's, SDPA's and the bound."""
    B, Q, H, hd, P, ps, M = 8, 64, 16, 128, 2048, 16, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, Q, H, hd), generator=g, device="cuda").bfloat16()
    kp = torch.randn((P, ps, H, hd), generator=g, device="cuda").bfloat16()
    vp = torch.randn((P, ps, H, hd), generator=g, device="cuda").bfloat16()
    tb = torch.randperm(P, generator=g, device="cuda")[:B * M] \
        .view(B, M).to(torch.int32)
    ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(hd)
    out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
    ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl, scale)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref)
    check(torch.allclose(out.float(), ref.float(), **TOL["bfloat16"]),
          f"kernel != plain at the {name}: max abs err {err:.3g}")

    # the kernel's device time (the call captured in a CUDA graph, as a
    # serving step would run it), and the time of calls made one by one,
    # where the wrapper's host time can set the pace
    def call():
        return pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)

    ms = graph_ms(torch, call)
    eager_ms = time_ms(torch, call, 100)
    plain_ms = time_ms(torch, lambda: pa._ragged_attention_ref(
        q, kp, vp, tb, ql, cl, scale), 10)
    # library yardstick: SDPA over the gathered dense K/V with the same
    # causal-at-offset mask (the gather itself is not timed)
    S = M * ps
    kd = kp[tb.long()].reshape(B, S, H, hd).transpose(1, 2)
    vd = vp[tb.long()].reshape(B, S, H, hd).transpose(1, 2)
    qd = q.transpose(1, 2)
    t = torch.arange(S, device="cuda")
    tq = torch.arange(Q, device="cuda")
    pos = (cl - ql).long()[:, None] + tq[None, :]
    mask = (t[None, None, :] <= pos[:, :, None])[:, None]       # [B,1,Q,S]
    import torch.nn.functional as F

    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale))
    # least time: the bytes this call must move (live queries read, the
    # whole output written, each row's live K/V and page ids read once)
    kv_bytes = sum(ctxs) * H * hd * 2 * 2
    q_bytes = sum(qlens) * H * hd * 2
    out_bytes = B * Q * H * hd * 2
    meta_bytes = sum(-(-c // ps) for c in ctxs) * 4 + 2 * B * 4
    nbytes = kv_bytes + q_bytes + out_bytes + meta_bytes
    flops = sum((c - ql_ + t_ + 1) * H * hd * 4
                for ql_, c in zip(qlens, ctxs) for t_ in range(ql_))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[phase 2] {name} q{[B, Q, H, hd]} pages{[P, ps, H, hd]} "
          f"bf16, query lens {qlens}, contexts {ctxs}: kernel {ms:.4f} ms "
          f"(device, CUDA graph; {eager_ms:.4f} ms a call made from the "
          f"host), plain {plain_ms:.4f}"
          f" ms, SDPA(dense gathered, CUDA graph) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s; "
          f"{flops / 1e9:.3f} GFLOP), max abs err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "eager_ms": eager_ms}


def phase_full_step(torch, cfg, params, pa, gpt_ragged_step):
    """One full-width step, kernel vs plain attention on equal inputs."""
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    P, ps, B, Q = 2048, 16, 8, 64
    M = cfg.max_seq_len // ps
    g = torch.Generator(device="cuda").manual_seed(11)
    # older context already in the pool: random K/V
    k0 = torch.randn((L, P, ps, H, hd), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    v0 = torch.randn((L, P, ps, H, hd), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    tables = torch.randperm(P, generator=g, device="cuda")[:B * M] \
        .view(B, M).to(torch.int32)
    # row 0 mid-prefill chunk (positions 192..255), rows 1-6 decode,
    # row 7 idle; one padding token
    qlens = [64, 1, 1, 1, 1, 1, 1, 0]
    ctxs = [256, 100, 513, 1024, 2000, 37, 700, 0]
    T = Q + B - 1
    rows = np.full(T, B, np.int32)
    slots = np.zeros(T, np.int32)
    off = 0
    for b, n in enumerate(qlens):
        rows[off:off + n] = b
        slots[off:off + n] = np.arange(n)
        off += n
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    args = (dev(tokens), dev(rows), dev(slots), dev(qlens), dev(ctxs))
    k1, v1 = k0.clone(), v0.clone()
    t0 = time.perf_counter()
    lk, _, _ = gpt_ragged_step(cfg, params, *args, k1, v1, tables, max_q=Q)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    lp, _, _ = gpt_ragged_step(cfg, params, *args, k0, v0, tables, max_q=Q,
                               attention=pa._ragged_attention_ref)
    torch.cuda.synchronize()
    live = torch.tensor([n > 0 for n in qlens], device="cuda")
    lk, lp = lk[live].float(), lp[live].float()
    check(bool(torch.isfinite(lk).all()), "full-width logits not finite")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    page_err = max(float((k1 - k0).abs().max()), float((v1 - v0).abs().max()))
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"[phase 3] gpt3-1.3b bf16 x{L} layers, batch chunk64+6 decode+"
          f"idle: logits max abs err {err:.4g} (max |logit| {scale:.3g}), "
          f"written pages max abs err {page_err:.4g}, argmax agree "
          f"{agree}/{lk.shape[0]}, first kernel step {t_kernel * 1e3:.1f} ms")
    # both sides compute attention in fp32 and round its output to bf16;
    # one-ulp differences there compound through 24 bf16 layers
    check(err <= 0.05 * max(1.0, scale),
          f"full-width step: kernel vs plain logits differ by {err:.4g}")
    del k0, v0, k1, v1
    torch.cuda.empty_cache()


def phase_serving(torch, cfg, params, pa, serving):
    eng = serving.Engine(cfg, params, page_size=16, num_pages=2048,
                         max_batch_size=8, chunk_len=64, device="cuda")
    eng.warmup()
    eng.metrics = serving.ServingMetrics()      # drop the warm-up's samples
    finite = []
    run_step = eng._run_step

    def checked(tokens, rows, slots, qlens, ctxs, tables):
        logits = run_step(tokens, rows, slots, qlens, ctxs, tables)
        finite.append(bool(np.isfinite(logits[qlens > 0]).all()))
        return logits

    eng._run_step = checked
    rng = np.random.default_rng(0)
    lens = [512] + [int(n) for n in rng.integers(64, 1025, 7)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    prompts[7] = prompts[0][:256] + prompts[7][256:] \
        if lens[7] > 256 else prompts[0][:256] + prompts[7]
    sp = serving.SamplingParams(max_new_tokens=32)

    torch.cuda.synchronize()
    pa.ragged_paged_attention.launches = 0
    steps0 = eng.steps
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p in prompts[:7]]
    while reqs[0].prompt_pos < len(prompts[0]):
        eng.step()
    # request 7 arrives once request 0's prompt is in the radix cache
    reqs.append(eng.add_request(prompts[7], sp))
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.ragged_paged_attention.launches
    steps = eng.steps - steps0

    for r in reqs:
        check(r.state == serving.RequestState.FINISHED,
              f"request {r.id} ended {r.state}: {r.finish_reason}")
        check(len(r.output) == 32, f"request {r.id} made {len(r.output)}")
    check(all(finite), "serving logits not finite")
    check(launches == cfg.num_layers * steps,
          f"kernel launches {launches} != {cfg.num_layers} x {steps} steps")
    snap = eng.metrics.snapshot()
    check(snap["prefix_cache"]["hits"] >= 1, "no prefix-cache hit")
    gen = sum(len(r.output) for r in reqs)
    ttft, dec = snap["ttft_s"], snap["decode_token_s"]
    print(f"[phase 4] served {len(reqs)} requests (prompts {lens}, 32 new "
          f"tokens each, greedy) in {steps} steps, {wall:.3f} s: "
          f"{gen / wall:.1f} generated tok/s, TTFT p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p95 {ttft['p95'] * 1e3:.1f} ms, "
          f"decode {dec['mean'] * 1e3:.3f} ms/token (step time / rows), "
          f"mean step {wall / steps * 1e3:.2f} ms, prefix hits "
          f"{snap['prefix_cache']['hits']} ({snap['prefix_cache']['hit_tokens']}"
          f" tokens), kernel launches {launches} = {cfg.num_layers} x "
          f"{steps}")
    profile_serving(torch, eng, serving, cfg.vocab_size)
    return launches


def profile_serving(torch, eng, serving, vocab):
    """Where a serving step's time goes: the same request mix is run
    untraced (step wall time) and then traced with torch.profiler
    (device time by kernel), on fresh prompts so neither run hits the
    other's prefix cache.  Runs after the launch count was read."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    sp = serving.SamplingParams(max_new_tokens=8)

    def fresh():
        return [[int(t) for t in rng.integers(0, vocab, n)]
                for n in (700, 300, 64, 64)]

    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(fresh(), sp)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / (eng.steps - steps0)
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(fresh(), sp)
        torch.cuda.synchronize()
    steps = eng.steps - steps0
    by_kind = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device-side kernel events only: the CPU ops that launched them
        # carry the same device time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = e.key.lower()
        kind = ("attention" if "ragged_paged_attention" in key else
                "matmul" if any(w in key for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "cublas"))
                else "other")
        by_kind[kind] += us
        top.append((us, e.key[:48]))
    busy = sum(by_kind.values()) / steps
    check(busy > 0, "profiler saw no device time")
    print(f"[phase 4] step breakdown over {steps} steps (prompts 700, 300, "
          f"64, 64; 8 new tokens): untraced {step_us / 1e3:.3f} ms/step, "
          f"device {busy / 1e3:.3f} ms/step (busy share "
          f"{busy / step_us:.3f}); device time by kind: "
          + ", ".join(f"{k} {v / steps / 1e3:.3f} ms/step"
                      for k, v in by_kind.items()))
    print("[phase 4] top device kernels, ms/step: " + "; ".join(
        f"{name} {us / steps / 1e3:.3f}" for us, name in sorted(top)[::-1][:6]))


# ------------------------------------------------ flash attention (5-7)


def flash_work(B, H, S, D, causal, nbytes_el=2):
    """(bytes, FLOPs) each flash kernel must move and do for one call on
    these inputs: every input read once, every output written once, and
    the products of the live (q, k) pairs only (k <= q when causal).  The
    backward is one kernel: q, k, v, dO, lse and delta in, dq, dk, dv out,
    five products (S, dP, dV, dK, dQ: 10 * D FLOPs a pair)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    mat = B * H * S * D * nbytes_el            # one [B, H, S, D] tensor
    rows = B * H * S * 4                       # one fp32 [B, H, S] vector
    return {"fwd": (4 * mat + rows, 4 * D * pairs),
            "bwd": (7 * mat + 2 * rows, 10 * D * pairs)}


def phase_flash_kernels(torch, fa, ra):
    """Edge cases, then the training shapes with timings."""
    n = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(S, causal) for S in (1, 17, 64, 200, 256)
             for causal in (True, False) if causal or S != 200]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = TOL_FLASH[dtype_name]
        # 192 pads to 256, 320 to 512; bf16 past 256 runs in fp32
        for D in (32, 64, 128, 192, 256, 320, 512):
            for S, causal in cases:
                g = torch.Generator(device="cuda").manual_seed(n)
                q, k, v, do = (torch.randn((2, 3, S, D), generator=g,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                scale = 1.0 / np.sqrt(D)
                out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
                ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
                dq, dk, dv = fa._flash_bwd_cuda(q, k, v, ref, ref_lse, do,
                                                scale, causal)
                rq, rk, rv = fa._flash_bwd_ref(q, k, v, ref, ref_lse, do,
                                               scale, causal)
                torch.cuda.synchronize()
                pairs = (("out", out, ref), ("dq", dq, rq), ("dk", dk, rk),
                         ("dv", dv, rv))
                for name, a, b in pairs:
                    check(a.dtype == dtype and a.shape == b.shape,
                          f"flash {name} dtype/shape")
                    check(bool(torch.isfinite(a).all()),
                          f"flash {name} not finite")
                    err = max_err(torch, a, b)
                    worst[dtype_name] = max(worst[dtype_name], err)
                    check(torch.allclose(a.float(), b.float(), **tol),
                          f"flash {name} kernel != plain ({dtype_name}, "
                          f"S={S}, D={D}, causal={causal}): max abs err "
                          f"{err:.3g}")
                check(torch.allclose(lse, ref_lse, **TOL_FLASH["float32"]),
                      f"flash lse kernel != plain ({dtype_name}, S={S}, "
                      f"D={D}, causal={causal})")
                n += 1
    print(f"[phase 5] {n} flash edge cases agree on out, lse, dq, dk, dv "
          f"(head dims 32-512; fp32 atol=rtol=1e-4, worst "
          f"{worst['float32']:.3g}; bf16 atol 1e-2 rtol 1.6e-2, worst "
          f"{worst['bfloat16']:.3g})")
    # past 512: padded to 1024, two 512-column chunks (bf16 in fp32),
    # through the public entries with their gradients
    D = 640
    for dtype_name in ("float32", "bfloat16"):
        g = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn((2, 2, 256, D), generator=g,
                                   device="cuda").to(getattr(torch,
                                                             dtype_name))
                       for _ in range(4))
        for name, fn in (("flash_attention", lambda *a: fa.flash_attention(
                              *a, causal=True)),
                         ("ring_attention sep=2", lambda *a:
                          ra.ring_attention(*a, sep=2))):
            outs = []
            for f in (fn, lambda *a: fa.flash_attention_plain(*a,
                                                              causal=True)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = f(*leaves)
                out.backward(do)
                outs.append([out.detach()] + [t.grad for t in leaves])
            torch.cuda.synchronize()
            for part, a, b in zip(("out", "dq", "dk", "dv"), *outs):
                check(a.dtype == q.dtype and a.shape == q.shape,
                      f"{name} D={D} {part} dtype/shape")
                check(torch.allclose(a.float(), b.float(),
                                     **TOL_FLASH[dtype_name]),
                      f"{name} D={D} {part} != plain ({dtype_name}): max "
                      f"abs err {max_err(torch, a, b):.3g}")
    print(f"[phase 5] flash_attention and ring_attention (sep=2) at head "
          f"dim {D}, S=256, causal: out, dq, dk, dv equal the plain "
          f"version in fp32 and bf16")

    # ---- training shapes: GPT-3 1.3B, batch 8 x 2048, bf16, causal
    B, H, S, D = 8, 16, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, True)
    delta = fa._delta(ref, do)
    dq, dk, dv = fa._bwd_sm90(q, k, v, do, ref_lse, delta, scale, True)
    rk, rv = fa._bwd_dkdv_ref(q, k, v, do, ref_lse, delta, scale, True)
    rq = fa._bwd_dq_ref(q, k, v, do, ref_lse, delta, scale, True)
    torch.cuda.synchronize()
    errs = {"fwd": max(max_err(torch, out, ref),
                       max_err(torch, lse, ref_lse)),
            "bwd": max(max_err(torch, dq, rq), max_err(torch, dk, rk),
                       max_err(torch, dv, rv))}
    for name, a, b in (("out", out, ref), ("dq", dq, rq), ("dk", dk, rk),
                       ("dv", dv, rv)):
        check(torch.allclose(a.float(), b.float(), **TOL_FLASH["bfloat16"]),
              f"flash {name} kernel != plain at the training shapes: "
              f"{max_err(torch, a, b):.3g}")
    del ref, rk, rv, rq
    torch.cuda.empty_cache()

    # the backward kernel alone: one launch on fixed buffers (dQ keeps
    # adding into the same fp32 sums, which changes no time)
    lib = fa._lib_bwd_sm90()
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device="cuda")
    gk, gv = torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel_alone():
        rc = lib.flash_bwd_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), B * H, S, D, float(scale), 1, stream)
        check(rc == 0, f"flash_bwd_sm90_launch returned {rc}")

    ms = {"fwd": time_ms(torch, lambda: fa._flash_fwd_cuda(
              q, k, v, scale, True), 10),
          # the whole call: zeroing the dQ sums, the kernel, the cast
          "bwd": time_ms(torch, lambda: fa._bwd_sm90(
              q, k, v, do, lse, delta, scale, True), 10)}
    kernel_ms = time_ms(torch, kernel_alone, 10)
    del acc, gk, gv
    plain_ms = {"fwd": time_ms(torch, lambda: fa._flash_fwd_ref(
                    q, k, v, scale, True), 3, warmup=1),
                "bwd": time_ms(torch, lambda: (fa._bwd_dkdv_ref(
                    q, k, v, do, lse, delta, scale, True), fa._bwd_dq_ref(
                    q, k, v, do, lse, delta, scale, True)), 3, warmup=1)}
    torch.cuda.empty_cache()
    # library yardstick: PyTorch's SDPA (the port never calls it); its
    # forward against the forward kernel, its backward (dq, dk, dv in
    # one call) against the backward call
    import torch.nn.functional as F

    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        lq.detach(), lk.detach(), lv.detach(), is_causal=True), 10)
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do, retain_graph=True), 10)
    del lout
    library_ms = {"fwd": lib_fwd, "bwd": lib_bwd}

    result = {}
    for name, (nbytes, flops) in flash_work(B, H, S, D, True).items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        result[name] = {
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms[name]}
        print(f"[phase 5] flash {name} at q/k/v {[B, H, S, D]} bf16 "
              f"causal: {'whole call ' if name == 'bwd' else 'kernel '}"
              f"{ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({flops / 1e9:.1f} GFLOP at "
              f"989 TFLOP/s; {nbytes / 1e6:.1f} MB at 3.35 TB/s), max abs "
              f"err {errs[name]:.3g}; {flops / ms[name] / 1e9:.1f} TFLOP/s "
              f"achieved")
    bwd_flops = flash_work(B, H, S, D, True)["bwd"][1]
    print(f"[phase 5] flash bwd (flash_bwd_sm90.cu, one launch) at q/k/v "
          f"{[B, H, S, D]} bf16 causal: kernel alone {kernel_ms:.4f} ms "
          f"({bwd_flops / kernel_ms / 1e9:.1f} TFLOP/s), whole call "
          f"(zeroing, kernel, cast) {ms['bwd']:.4f} ms, SDPA backward "
          f"{lib_bwd:.4f} ms, bound at 10 D FLOPs a pair "
          f"{result['bwd']['bound_ms']:.4f} ms; the call is "
          + ("no slower than" if ms["bwd"] <= lib_bwd else "slower than")
          + " SDPA's backward")
    print(f"[phase 5] library: SDPA forward {lib_fwd:.4f} ms (vs fwd), "
          f"SDPA backward {lib_bwd:.4f} ms (dq, dk, dv in one call)")
    result["bwd"]["kernel_ms"] = kernel_ms
    del dq, dk, dv, lq, lk, lv
    # fp32 inputs take the scalar-FMA kernels (not the training path):
    # their times at the same shapes
    q, k, v, do = (t.float() for t in (q, k, v, do))
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    delta = fa._delta(out, do)
    f32 = {"fwd": time_ms(torch, lambda: fa._flash_fwd_cuda(
               q, k, v, scale, True), 3, warmup=1),
           "bwd_dkdv": time_ms(torch, lambda: fa._bwd_dkdv_cuda(
               q, k, v, do, lse, delta, scale, True), 2, warmup=1),
           "bwd_dq": time_ms(torch, lambda: fa._bwd_dq_cuda(
               q, k, v, do, lse, delta, scale, True), 2, warmup=1)}
    print("[phase 5] fp32 inputs (scalar FMA kernels) at the same shapes: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in f32.items()))
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    # the forward's host cost per launch at a ring pair's shape (480
    # launches a ring step): bf16 with its three TMA maps found in the
    # cache, bf16 with every map encoded (each call on tensors at new
    # addresses: views into one buffer at 16-byte steps, cycling through
    # more than the cache's 256 entries hold), and the fp32 entry, through
    # the same wrapper, which encodes none; three rounds in turns, the
    # least of each kept (the host's clock moves with its other load)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (B, H, 512, D)
    numel = B * H * 512 * D
    views = 300
    bufs = [torch.randn(numel + 8 * views, generator=g, device="cuda")
            .bfloat16() for _ in range(3)]
    fresh = [[b[8 * i:8 * i + numel].view(shape) for b in bufs]
             for i in range(views)]
    calls = iter(range(10 ** 9))

    def uncached():
        a, b, c = fresh[next(calls) % views]
        fa._flash_fwd_cuda(a, b, c, scale, False)

    a, b, c = fresh[0]
    a32, b32, c32 = (t.float() for t in fresh[0])
    kinds = {"bf16 cached maps": lambda: fa._flash_fwd_cuda(a, b, c, scale,
                                                           False),
             "bf16 maps encoded": uncached,
             "fp32 (no maps)": lambda: fa._flash_fwd_cuda(a32, b32, c32,
                                                         scale, False)}
    us = {n: [] for n in kinds}
    for order in (list(kinds), list(kinds)[::-1], list(kinds)):
        for n in order:
            us[n].append(host_us(torch, kinds[n]))
    print(f"[phase 5] flash fwd host time per call at q/k/v [{B}, {H}, "
          f"512, {D}] (wrapper and launch, device not waited on; least of "
          f"3 rounds): " + ", ".join(f"{n} {min(t):.2f} us"
                                     for n, t in us.items())
          + "; x 480 launches a ring step: "
          + " / ".join(f"{min(t) * 480 / 1e3:.2f}" for t in us.values())
          + " ms")
    del a32, b32, c32
    del bufs, fresh, a, b, c
    torch.cuda.empty_cache()
    # the widest head dim of the bf16 kernels: forward and backward beside
    # SDPA's
    D = 256
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, True)
    torch.cuda.synchronize()
    err = max(max_err(torch, out, ref), max_err(torch, lse, ref_lse))
    check(torch.allclose(out.float(), ref.float(), **TOL_FLASH["bfloat16"])
          and torch.allclose(lse, ref_lse, **TOL_FLASH["float32"]),
          f"flash fwd kernel != plain at head dim 256: {err:.3g}")
    del ref, ref_lse
    delta = fa._delta(out, do)
    t_fwd = time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, scale, True),
                    10)
    t_bwd = time_ms(torch, lambda: fa._bwd_sm90(q, k, v, do, lse, delta,
                                                scale, True), 5)
    t_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    t_lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do, retain_graph=True), 5)
    del lout, lq, lk, lv
    work = flash_work(B, H, S, D, True)
    print(f"[phase 5] flash at q/k/v {[B, H, S, D]} bf16 causal: forward "
          f"{t_fwd:.4f} ms ({work['fwd'][1] / t_fwd / 1e9:.1f} TFLOP/s), "
          f"SDPA {t_lib:.4f} ms, bound {work['fwd'][1] / BF16_FLOPS * 1e3:.4f}"
          f" ms, max abs err {err:.3g}; backward call {t_bwd:.4f} ms "
          f"({work['bwd'][1] / t_bwd / 1e9:.1f} TFLOP/s), SDPA backward "
          f"{t_lib_bwd:.4f} ms, bound "
          f"{work['bwd'][1] / BF16_FLOPS * 1e3:.4f} ms")
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return result


def phase_train_step(torch, cfg, params, fa, gpt_loss):
    """One full-width training step, kernels vs plain attention."""
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 2048))).cuda()
    leaves = [params["wte"], params["wpe"], params["lnf_g"],
              params["lnf_b"]] + [params["blocks"][k]
                                  for k in sorted(params["blocks"])]
    names = ["wte", "wpe", "lnf_g", "lnf_b"] + [
        f"blocks/{k}" for k in sorted(params["blocks"])]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for label, attention in (("kernel", None),
                             ("plain", lambda q, k, v:
                              fa.flash_attention_plain(q, k, v,
                                                       causal=True))):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        loss = gpt_loss(cfg, params, tokens, attention=attention)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[label] = (float(loss.detach()), grads,
                       time.perf_counter() - t0)
        if label == "kernel":
            got = {n: fa.launches[n] - before[n] for n in before}
            L = cfg.num_layers
            check(got == {"fwd": 2 * L, "bwd": L},
                  f"training step launched {got}")
    for t in leaves:
        t.requires_grad_(False)
    (lk, gk, tk), (lp, gp, _) = runs["kernel"], runs["plain"]
    check(np.isfinite(lk) and np.isfinite(lp), "training loss not finite")
    worst = (0.0, "")
    for name, a, b in zip(names, gk, gp):
        check(bool(torch.isfinite(a).all()), f"grad {name} not finite")
        rel = float((a.float() - b.float()).norm()
                    / b.float().norm().clamp(min=1e-30))
        worst = max(worst, (rel, name))
    print(f"[phase 6] gpt3-1.3b bf16 x{cfg.num_layers} layers, batch "
          f"1 x 2048, one training step: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3g}); worst gradient "
          f"relative L2 error {worst[0]:.4g} ({worst[1]}) over "
          f"{len(names)} leaves; kernel step {tk * 1e3:.1f} ms")
    # both sides compute attention in fp32 and round its output (and
    # its input grads) to bf16; one-ulp differences there (2^-8
    # relative) compound through 24 bf16 layers forward and back
    check(abs(lk - lp) <= 2e-3 * abs(lp),
          f"training step: loss differs by {abs(lk - lp):.4g}")
    check(worst[0] <= 0.05, f"training step: gradient {worst[1]} differs "
          f"by {worst[0]:.4g} relative")
    del runs, gk, gp
    torch.cuda.empty_cache()


def profile_step(torch, step):
    """Device time of one training step by kind (flash kernels, matrix
    products, the rest), traced with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_kind = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    top, spans, ops = [], {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # aten ops, by the device time of the kernels they launched
            if e.key.startswith("aten::"):
                ops.append((us / 1e3, e.key))
            continue
        if e.key.startswith("engine::"):
            # the device-side span of a record_function range, not a
            # kernel: kept apart from the sums
            spans[e.key] = us / 1e3
            continue
        if us <= 0:
            continue
        key = e.key.lower()
        kind = ("flash" if "flash_" in key and "_kernel" in key else
                "matmul" if any(w in key for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "cublas"))
                else "other")
        by_kind[kind] += us / 1e3
        top.append((us, e.key[:48]))
    busy = sum(by_kind.values())
    check(busy > 0, "profiler saw no device time")
    return {"busy_ms": busy, "by_kind": by_kind, "spans": spans,
            "top": sorted(top)[::-1][:6], "ops": sorted(ops)[::-1][:10]}


RING_SEP = 4                       # phase 10's ring shards on the card


def train_launches(sep):
    """Kernel launches of one training step, per layer, by counter.
    Remat "dots" saves matmul outputs only, so every flash forward runs
    again in backward; the bf16 flash backward is one launch.  With sep >
    1 the ring runs its live pairs (j <= i: sep diagonal, the rest full)
    through the flash forward, and each pair through the ring-pair
    backward kernel once."""
    if sep == 1:
        return {"fwd": 2, "bwd": 1, "pair_bwd": 0}
    live = sep * (sep + 1) // 2
    return {"fwd": 2 * live, "bwd": 0, "pair_bwd": live}


def phase_train_throughput(torch, sep=1, tag="phase 7"):
    """HybridEngine at the 1.3B training rung on one card, with ``sep``
    ring shards (``seq_parallel="ring"`` when sep > 1); the launches are
    held to ``train_launches(sep)``.  Returns (launches over the timed
    steps, the first loss)."""
    import importlib

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_flops_per_token

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    counts = [fa.launches, ra.launches]
    cfg = GPT_CONFIGS["gpt3-1.3b"]
    if sep > 1:
        cfg = dataclasses.replace(cfg, seq_parallel="ring")
    B, S = 8, 2048
    # free what earlier phases left in reference cycles (the serving
    # engine and its KV pool) now, so the peak below is this cell's own
    gc.collect()
    torch.cuda.empty_cache()
    eng = distributed.HybridEngine(cfg, sep=sep,
                                   engine_cfg=distributed.EngineConfig(
                                       accum_steps=1), device="cuda")
    check(cfg.remat == "dots" and eng._has_master(),
          "expected remat 'dots' and an fp32 master")
    params, opt = eng.init(seed=0)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)
    losses = []

    def step():
        nonlocal params, opt
        params, opt, loss = eng.step(params, opt, tokens, labels)
        losses.append(loss)

    for _ in range(2):                      # warm-up
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counts:
        for n in c:
            c[n] = 0
    timed = 5
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c[n] for c in counts for n in c}
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        step()
    breakdown = profile_step(torch, step)
    losses = [float(x) for x in losses]
    ms_step = wall / timed * 1e3
    tok_s = B * S * timed / wall
    mfu = tok_s * gpt_flops_per_token(cfg, S) / BF16_FLOPS
    print(f"[{tag}] HybridEngine gpt3-1.3b bf16, sep {sep} "
          f"(seq_parallel {cfg.seq_parallel!r}), batch {B} x {S}, "
          f"remat dots, fp32 Adam slots + master: {ms_step:.1f} ms/step, "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s peak; "
          f"{card_line()}), peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"[{tag}] losses over 10 steps: "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"[{tag}] launches over {timed} timed steps: {launches}")
    print(f"[{tag}] one traced step (10th): device busy "
          f"{breakdown['busy_ms']:.1f} ms of the untraced {ms_step:.1f} "
          f"ms/step (busy share {breakdown['busy_ms'] / ms_step:.3f}); by "
          f"kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                breakdown["by_kind"].items()))
    print(f"[{tag}] top device kernels, ms/step: " + "; ".join(
        f"{name} {us / 1e3:.2f}" for us, name in breakdown["top"]))
    print(f"[{tag}] device span of the optimizer update "
          "(engine::optimizer): " + ", ".join(
              f"{v:.1f} ms" for v in breakdown["spans"].values()))
    print(f"[{tag}] top aten ops by device ms: " + "; ".join(
        f"{name} {ms:.1f}" for ms, name in breakdown["ops"]))
    check(all(np.isfinite(losses)), "training loss not finite")
    check(losses[-1] < losses[0], "training loss did not fall")
    want = {n: k * cfg.num_layers * timed
            for n, k in train_launches(sep).items()}
    check(launches == want, f"launches {launches} != {want}")
    del params, opt
    torch.cuda.empty_cache()
    return launches, losses[0]


# ------------------------------------------------ ring attention (8-10)


def ring_pair_case(torch, fa, B, H, s, D, dtype, seed):
    """Rank 1 of a 2-rank ring on the card, from a seed: its q shard, the
    two blocks it meets (rank 0's: a full pair; its own: the diagonal
    pair), dO in q's dtype (as the ring hands it to a pair), the
    ring-global lse, output and delta over both pairs, and non-zero
    fp32 starting sums for dq, dk, dv."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k0, v0, k1, v1, do = (torch.randn((B, H, s, D), generator=g,
                                         device="cuda").to(dtype)
                             for _ in range(6))
    start = [torch.randn((B, H, s, D), generator=g, device="cuda")
             for _ in range(3)]
    scale = 1.0 / np.sqrt(D)
    o_f, l_f = fa._flash_fwd_ref(q, k0, v0, scale, False)
    o_d, l_d = fa._flash_fwd_ref(q, k1, v1, scale, True)
    lse = torch.logaddexp(l_f, l_d)
    out = (o_f.float() * torch.exp(l_f - lse)[..., None]
           + o_d.float() * torch.exp(l_d - lse)[..., None]).to(dtype)
    return {"q": q, "pairs": {False: (k0, v0), True: (k1, v1)}, "do": do,
            "lse": lse, "out": out, "delta": fa._delta(out, do),
            "scale": scale, "start": start}


def ring_pair_run(torch, ra, c, causal):
    """One pair's backward as the ring runs it: q/k/v/dO at the kernels'
    width (``_pair_operands``), the starting sums padded to it with
    zeros; returns (the sums after the pair, sliced to D, the padded
    sums, the call on the padded operands)."""
    import torch.nn.functional as F

    k, v = c["pairs"][causal]
    D = k.shape[-1]
    ops = ra._pair_operands(c["q"], k, v, c["do"])
    pad = ops[0].shape[-1] - D
    sums = [F.pad(t, (0, pad)) if pad else t.clone() for t in c["start"]]

    def call(sums=sums):
        ra._pair_bwd(*ops, c["lse"], c["delta"], c["scale"], causal, *sums)

    call()
    return [t[..., :D] for t in sums], sums, call


def ring_pair_work(B, H, s, D, causal):
    """(bytes, FLOPs) the bf16 ring-pair backward must move and do: q,
    k, v and dO in bf16 and lse, delta read once; the dq, dk and dv fp32
    sums each read and written once; the five products (10 * D FLOPs) of
    the live (q, k) pairs only."""
    pairs = B * H * (s * (s + 1) // 2 if causal else s * s)
    mat, mat32, rows = B * H * s * D * 2, B * H * s * D * 4, B * H * s * 4
    return 4 * mat + 2 * rows + 3 * 2 * mat32, 10 * D * pairs


def library_pair_bwd(torch, c, causal):
    """PyTorch's flash-attention backward (dq, dk, dv in one call) on the
    same pair: the pair's q/k/v, the ring's global out and lse, dO.
    Returns (a call computing it, why there is none)."""
    op = getattr(torch.ops.aten, "_scaled_dot_product_flash_attention"
                 "_backward", None)
    if op is None:
        return None, "this PyTorch has no aten flash-attention backward"
    q, (k, v) = c["q"], c["pairs"][causal]
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal, False, scale=c["scale"])

        def call():
            return op(c["do"], q, k, v, c["out"], c["lse"], fwd[2], fwd[3],
                      fwd[4], fwd[5], 0.0, causal, fwd[6], fwd[7],
                      scale=c["scale"])

        call()
        torch.cuda.synchronize()
    except Exception as e:  # the yardstick is optional; its absence is printed
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return call, None


def phase_ring_pair_kernels(torch, fa, ra):
    """Edge cases, then the per-rank shapes of the sep=4 training path
    with timings."""
    n = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for s in (128, 256, 512):
            for D in (32, 64, 128, 80, 256):
                c = ring_pair_case(torch, fa, 2, 3, s, D, dtype, seed=n)
                for causal in (True, False):
                    k, v = c["pairs"][causal]
                    before = (ra.launches["pair_bwd"], fa.launches["bwd"])
                    got, _, _ = ring_pair_run(torch, ra, c, causal)
                    again, _, _ = ring_pair_run(torch, ra, c, causal)
                    want = ra._pair_bwd_ref(c["q"], k, v, c["do"], c["lse"],
                                            c["delta"], c["scale"], causal)
                    torch.cuda.synchronize()
                    bf16 = dtype == torch.bfloat16
                    check((ra.launches["pair_bwd"] - before[0],
                           fa.launches["bwd"] - before[1])
                          == ((2, 0) if bf16 else (0, 4)),
                          "ring pair launches not counted")
                    check(torch.equal(got[1], again[1])
                          and torch.equal(got[2], again[2]),
                          f"ring pair dk/dv differ between two runs "
                          f"({dtype_name}, s={s}, D={D}, causal={causal})")
                    for name, a, s0, b in zip(("dq", "dk", "dv"), got,
                                              c["start"], want):
                        check(a.dtype == torch.float32 and a.shape == b.shape,
                              f"ring pair {name} dtype/shape")
                        check(bool(torch.isfinite(a).all()),
                              f"ring pair {name} not finite")
                        err = max_err(torch, a, s0 + b)
                        worst[dtype_name] = max(worst[dtype_name], err)
                        check(torch.allclose(a, s0 + b,
                                             **TOL_FLASH[dtype_name]),
                              f"ring pair {name} != start + plain "
                              f"({dtype_name}, s={s}, D={D}, causal="
                              f"{causal}): max abs err {err:.3g}")
                    n += 1
    print(f"[phase 8] {n} ring-pair edge cases: start + pair == start + "
          f"plain on dq, dk, dv (fp32 atol=rtol=1e-4, worst "
          f"{worst['float32']:.3g}; bf16 q/k/v/dO: atol 1e-2 rtol 1.6e-2, "
          f"worst {worst['bfloat16']:.3g}); dk, dv bit-equal over two "
          f"runs")

    # ---- per-rank shapes of the path: sep=4 over S=2048, bf16
    B, H, s, D = 8, 16, 512, 128
    c = ring_pair_case(torch, fa, B, H, s, D, torch.bfloat16, seed=5)
    res = {}
    for causal in (False, True):
        k, v = c["pairs"][causal]
        args = (c["q"], k, v, c["do"], c["lse"], c["delta"], c["scale"],
                causal)
        got, sums, call = ring_pair_run(torch, ra, c, causal)
        want = ra._pair_bwd_ref(*args)
        torch.cuda.synchronize()
        errs = []
        for name, a, s0, b in zip(("dq", "dk", "dv"), got, c["start"],
                                  want):
            errs.append(max_err(torch, a, s0 + b))
            check(torch.allclose(a, s0 + b, **TOL_FLASH["bfloat16"]),
                  f"ring pair {name} != start + plain at the path shapes "
                  f"(causal={causal}): {errs[-1]:.3g}")
        lib_call, why = library_pair_bwd(torch, c, causal)
        if lib_call is not None:
            lq, lk, lv = lib_call()[:3]
            torch.cuda.synchronize()
            for name, a, b in (("dq", lq, want[0]), ("dk", lk, want[1]),
                               ("dv", lv, want[2])):
                if not torch.allclose(a.float(), b, **TOL_FLASH["bfloat16"]):
                    lib_call = None
                    why = (f"its {name} disagrees with the plain version by "
                           f"{max_err(torch, a, b):.3g}")
                    break
        del got, want

        def plain(sums=sums):
            for acc, t in zip(sums, ra._pair_bwd_ref(*args)):
                acc[..., :D] += t

        # one pair's call keeps adding into the same sums (no time change)
        ms = time_ms(torch, call, 20)
        plain_ms = time_ms(torch, plain, 3, warmup=1)
        lib_ms = (time_ms(torch, lib_call, 20) if lib_call is not None
                  else None)
        # what the route before this kernel ran after its two kernels:
        # each pair's fresh dq, dk, dv added into the sums (three fp32
        # passes, each reading two tensors and writing one)
        parts = [torch.ones_like(t) for t in sums]

        def three_adds():
            for acc, t in zip(sums, parts):
                acc += t

        adds_ms = time_ms(torch, three_adds, 20)
        del parts
        torch.cuda.empty_cache()
        nbytes, flops = ring_pair_work(B, H, s, D, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        kind = "diagonal (causal)" if causal else "full"
        entry = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib_ms}
        print(f"[phase 8] ring pair backward, {kind} pair at q/k/v/dO "
              f"{[B, H, s, D]} bf16 into fp32 sums: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.1f} "
              f"GFLOP at 989 TFLOP/s), max abs err {max(errs):.3g}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        print(f"[phase 8] {kind} pair: aten flash-attention backward (dq, "
              f"dk, dv in one call, fresh bf16 outputs) "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None
                 else f"none ({why})")
              + f"; the three fp32 adds of the route before this kernel "
              f"{adds_ms:.4f} ms")
        if causal:
            res.update({f"diagonal_{key}": entry[key]
                        for key in ("ms", "plain_ms", "bound_ms",
                                    "library_ms", "max_abs_err")})
        else:
            res.update(entry)
        del sums
    del c
    torch.cuda.empty_cache()
    return res


def phase_ring_vs_flash(torch, fa, ra):
    """ring_attention (sep=4) against flash_attention on the 1.3B
    training shapes: output, grads and both times."""
    B, H, S, D = 8, 16, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    fns = {"ring": lambda *a: ra.ring_attention(*a, sep=4),
           "flash": lambda *a: fa.flash_attention(*a, causal=True)}
    res, times = {}, {}
    for name, fn in fns.items():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def run():
            out = fn(*leaves)
            return (out,) + torch.autograd.grad(out, leaves, do)

        res[name] = [t.detach() for t in run()]
        times[name] = time_ms(torch, run, 5, warmup=2)
    torch.cuda.synchronize()
    errs = {}
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        a, b = res["ring"][i], res["flash"][i]
        errs[name] = max_err(torch, a, b)
        check(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
              f"ring {name} dtype or not finite")
        check(torch.allclose(a.float(), b.float(), **TOL_FLASH["bfloat16"]),
              f"ring {name} != flash: max abs err {errs[name]:.3g}")
    print(f"[phase 9] ring_attention sep=4 vs flash_attention at q/k/v "
          f"{[B, H, S, D]} bf16 causal: max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" (atol 1e-2 rtol 1.6e-2); forward + backward: ring "
          f"{times['ring']:.4f} ms, flash {times['flash']:.4f} ms")
    del res, q, k, v, do
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import importlib

        from paddle_tpu_torch import serving
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import paged_attention as pa
        ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
        from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init, gpt_loss
        from paddle_tpu_torch.models.gpt import gpt_ragged_step
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    print(f"[phase 1] built {len(_build.SOURCES)} kernel(s) in "
          f"{prepare(torch):.1f} s")
    for name, log in _build.build_logs().items():
        kernel, spill = "?", ""
        for line in log.splitlines():
            # registers and spills of every kernel, and ptxas's notes on
            # wgmma serialisation or an ignored setmaxnreg
            if "Function properties for " in line:
                kernel = line.split("Function properties for ")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line:
                used = line.split(":", 1)[-1].strip()
                print(f"  {name}: {kernel[:72]}: {used}; {spill}")
            elif "wgmma" in line or "setmaxnreg" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    rpa = phase_kernel_vs_plain(torch, pa)
    print(f"[phase 2] {time.perf_counter() - t0:.1f} s")

    cfg = GPT_CONFIGS["gpt3-1.3b"]
    t0 = time.perf_counter()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    phase_full_step(torch, cfg, params, pa, gpt_ragged_step)
    print(f"[phase 3] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = phase_serving(torch, cfg, params, pa, serving)
    print(f"[phase 4] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flash = phase_flash_kernels(torch, fa, ra)
    print(f"[phase 5] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_train_step(torch, cfg, params, fa, gpt_loss)
    print(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flash_launches, loss1 = phase_train_throughput(torch)
    print(f"[phase 7] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ring = phase_ring_pair_kernels(torch, fa, ra)
    print(f"[phase 8] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_ring_vs_flash(torch, fa, ra)
    print(f"[phase 9] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ring_launches, ring_loss1 = phase_train_throughput(
        torch, sep=RING_SEP, tag="phase 10")
    rel = abs(ring_loss1 - loss1) / abs(loss1)
    print(f"[phase 10] step-1 loss: ring sep={RING_SEP} {ring_loss1:.6f}, "
          f"flash (phase 7) {loss1:.6f}, relative difference {rel:.3g} "
          f"(checked at 2e-3)")
    check(rel <= 2e-3, f"ring step-1 loss differs from phase 7's by "
                       f"{rel:.4g} relative")
    print(f"[phase 10] {time.perf_counter() - t0:.1f} s")

    csrc = "paddle_tpu_torch/kernels/csrc/"
    # rows 2 and 3 of the TPU kernels (dK/dV and dQ) are one kernel now:
    # both entries carry its launches and times
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": csrc + "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:117",
        "launches": launches, **rpa}] + [
        {"name": f"flash_attention_{name}", "route": "cuda",
         "source": csrc + source,
         "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
         "launches": flash_launches[key], **flash[key]}
        for name, key, source, line in (
            ("fwd", "fwd", "flash_fwd_sm90.cu", 64),
            ("bwd_dkdv", "bwd", "flash_bwd_sm90.cu", 168),
            ("bwd_dq", "bwd", "flash_bwd_sm90.cu", 215))
    ] + [
        # the TPU's two per-pair kernels (:105 dK/dV, :133 dQ) are one
        # kernel here; its numbers are the full pair's, the diagonal
        # pair's under diagonal_*
        {"name": "ring_pair_bwd", "route": "cuda",
         "source": csrc + "flash_bwd_sm90.cu",
         "replaces": "paddle_tpu/kernels/ring_attention.py:105",
         "also_replaces": "paddle_tpu/kernels/ring_attention.py:133",
         "launches": ring_launches["pair_bwd"], **ring}]
    # the forward kernel also runs every ring pair's forward (phase 10)
    kernels[1]["ring_launches"] = ring_launches["fwd"]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
