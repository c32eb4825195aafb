#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build every CUDA kernel of
     the port from the sources in this checkout (one nvcc per source,
     started together);
  2. kernel vs plain version on the card: edge cases (idle rows,
     qlen == ctx, contexts straddling pages, Q == 1 decode, several head
     dims) in fp32 and bf16, then the serving shapes, with each
     kernel's time, bound, plain-version time and the time of one
     library call computing the same function;
  3. one full-width ``gpt_ragged_step`` of GPT-3 1.3B (bf16, 24 layers)
     on a mixed chunk + decode + idle batch, kernel against the plain
     attention on the same inputs;
  4. the serving engine at GPT-3 1.3B serving 8 seeded requests (one
     pair sharing a 256-token prefix) to completion, with the kernel's
     launch count held to 24 per step.
The line before the last is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

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


def phase_kernel_vs_plain(torch, pa):
    """Edge cases, then the serving shapes with timings."""
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
    print(f"[phase 2] {n} edge cases agree (fp32 atol=rtol=1e-5; bf16 "
          f"atol 1e-2 rtol 1.6e-2)")

    # ---- serving shapes: one chunk row of 64 + 7 decode rows, bf16
    B, Q, H, hd, P, ps, M = 8, 64, 16, 128, 2048, 16, 128
    qlens = [64, 1, 1, 1, 1, 1, 1, 1]
    ctxs = [1024, 64, 2048, 1500, 700, 300, 128, 2000]
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
          f"kernel != plain at the serving shapes: max abs err {err:.3g}")

    ms = time_ms(torch, lambda: pa.ragged_paged_attention(q, kp, vp, tb, ql,
                                                          cl), 100)
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

    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale), 20)
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
    print(f"[phase 2] serving shapes q{[B, Q, H, hd]} pages{[P, ps, H, hd]} "
          f"bf16, contexts {ctxs}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, SDPA(dense gathered) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s; "
          f"{flops / 1e9:.3f} GFLOP), max abs err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import paged_attention as pa
        from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
        from paddle_tpu_torch.models.gpt import gpt_ragged_step
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[phase 1] built {len(_build.SOURCES)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
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

    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:117",
        "launches": launches, **rpa}]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
