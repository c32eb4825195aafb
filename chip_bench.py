#!/usr/bin/env python3
"""Kernel-level A/B benches of the port on one GPU, each in one process.

    python3 chip_bench.py bwd [SOURCE]
    python3 chip_bench.py pairs OTHER_TREE [SOURCE ...]
    python3 chip_bench.py ragged OTHER_TREE [SOURCE ...]

``bwd``: the bf16 flash backward (``flash_bwd_sm90.cu``, or SOURCE) and
scratch copies of it with parts of the dQ work switched off (its reduce,
or the whole dQ product), built side by side and timed in turns at the
GPT-3 1.3B training shapes ([8, 16, 2048, 128] bf16 causal), after a
check of the full kernel against the plain version at several shapes.
The copies compute wrong dQ on purpose: they only say where the time
goes.

``pairs``: one ring pair's backward at the sep = 4 training shapes
([8, 16, 512, 128] bf16, full and diagonal pair), from the same
non-zero fp32 sums: OTHER_TREE's route (a tree whose
``flash_attention.cu`` has the two ``ring_pair_bwd_dkdv_launch`` /
``ring_pair_bwd_dq_launch`` kernels, fp32 dO and fresh fp32 outputs,
then the three fp32 adds into the sums; for example the parent commit,
unpacked with ``git archive``) against this checkout's one
``ring_pair_bwd_sm90_launch`` (bf16 dO, adding into the sums), in turns
other / this / this / other, with PyTorch's flash-attention backward on
the same pair timed beside them.  The two routes' sums must agree
within the bf16 tolerance (atol 1e-2, rtol 1.6e-2): dQ's order of
summation differs, so not bit for bit.  Any further SOURCE (a variant
of ``flash_bwd_sm90.cu``, with ``sm90.cuh`` beside it) is timed in the
same turns and its disagreement printed, not checked: a variant may
skip work on purpose to show where the time goes.

``ragged``: ``ragged_paged_attention.cu`` of OTHER_TREE, of this
checkout and of any further SOURCE files, at the two shapes of
``chip_smoke.py`` phase 2 (the serving batch and the all-decode batch)
and at the serving batch with head dims 80 and 320, bf16 and fp32, in
turns: device time per call from CUDA graph replays, then the time of
calls made one by one from the host (ctypes).  Each tree is called through its own C entry, whichever of the
three signatures it has (the kv-split entry with its partials scratch,
sized by this checkout's ``_splits``; the two before it).

Every library is built with the package's nvcc flags into
``paddle_tpu_torch/kernels/build/bench/``; ptxas's registers and
spills print by kernel.
The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import graph_ms

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "paddle_tpu_torch", "kernels", "build", "bench")
CSRC = os.path.join("paddle_tpu_torch", "kernels", "csrc")


def build(name, src, defines=()):
    """nvcc ``src`` into OUT/name.so; returns (name, path or None, log)."""
    from paddle_tpu_torch.kernels import _build

    so = os.path.join(OUT, f"{name}.so")
    t0 = time.time()
    r = subprocess.run([_build._nvcc(), *_build._FLAGS, *defines, "-o", so,
                        src], capture_output=True, text=True)
    lines, fn = [f"== {name}: nvcc rc {r.returncode}, "
                 f"{time.time() - t0:.1f} s"], "?"
    for line in r.stderr.splitlines():
        if "Function properties for" in line:
            fn = line.split("for ")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            lines.append(f"   {fn[:80]}: {line.split(':', 1)[1].strip()}; "
                         f"{spill}")
    if r.returncode:
        lines.append(r.stderr[-3000:])
    return name, (so if r.returncode == 0 else None), "\n".join(lines)


def build_all(jobs):
    """jobs: {name: (src, defines)}, built in parallel; {name: CDLL}."""
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(lambda kv: build(kv[0], *kv[1]), jobs.items()))
    libs = {}
    for name, so, log in built:
        print(log, flush=True)
        if so is None:
            raise SystemExit(f"chip_bench: {name} did not build")
        libs[name] = ctypes.CDLL(so)
    return libs


def time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def in_turns(torch, calls, iters=20, timer=None):
    """{name: fn} timed in the order a, b, ..., ..., b, a; {name: [ms]}."""
    names = list(calls)
    res = {n: [] for n in names}
    for n in names + names[::-1]:
        res[n].append((timer or time_ms)(torch, calls[n], iters))
    return res


def print_turns(tag, res):
    for n, ts in res.items():
        print(f"[{tag}] {n}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms",
              flush=True)


# ------------------------------------------------------------------ bwd


def bench_bwd(torch, source):
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    base = open(source).read()
    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(HERE, CSRC, "sm90.cuh"), OUT)

    def variant(name, *pairs):
        src = base
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in src:
                raise SystemExit(f"chip_bench: {source} has no {old[:40]!r}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        open(path, "w").write(src)
        return path, ()

    path = os.path.join(OUT, "as_is.cu")
    open(path, "w").write(base)
    jobs = {"as_is": (path, ())}
    reduce_call = "        tma_reduce_add(&tm_dq,"
    if reduce_call in base:      # the dQ reduce-adds skipped
        jobs["no_dq_reduce"] = variant(
            "no_dq_reduce", reduce_call,
            "        if (false) " + reduce_call.lstrip())
    jobs["no_dq"] = variant(     # no dQ product, no dQ adds, no writers
        "no_dq", "const bool does_dq = DC >= 128 || w == 0;",
        "const bool does_dq = false;",
        "(DC >= 128 || threadIdx.x % 2 == 0)", "false")
    libs = build_all(jobs)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.flash_bwd_sm90_launch.argtypes = [ptr] * 10 + [i] * 3 + [f, i,
                                                                     ptr]
        lib.flash_bwd_sm90_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def case(B, H, S, D, causal, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                       .bfloat16() for _ in range(4))
        scale = 1.0 / np.sqrt(D)
        out, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
        delta = fa._delta(out, do)
        acc = torch.zeros((B, H, S, D), dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(q), torch.empty_like(q)

        def launch(lib):
            rc = lib.flash_bwd_sm90_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), acc.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), fa._dq_turns(q).data_ptr(),
                B * H, S, D, float(scale), int(causal), stream)
            if rc:
                raise SystemExit(f"chip_bench: launch returned {rc}")

        want = (fa._bwd_dq_ref(q, k, v, do, lse, delta, scale, causal),
                *fa._bwd_dkdv_ref(q, k, v, do, lse, delta, scale, causal))
        return launch, (acc, dk, dv), want

    for B, H, S, D, causal in ((2, 2, 384, 64, True), (2, 2, 200, 64, False),
                               (2, 2, 17, 128, True), (2, 2, 200, 128, False),
                               (2, 2, 384, 256, True), (2, 2, 200, 256, False),
                               (8, 16, 2048, 128, True)):
        launch, (acc, dk, dv), want = case(B, H, S, D, causal, S + D)
        launch(libs["as_is"])
        torch.cuda.synchronize()
        got = (acc.bfloat16(), dk, dv)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        ok = all(torch.allclose(a.float(), b.float(), atol=1e-2, rtol=1.6e-2)
                 for a, b in zip(got, want))
        print(f"[bwd] as_is {[B, H, S, D]} causal={causal}: max abs err "
              f"dq/dk/dv {['%.3g' % e for e in errs]} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("chip_bench: the kernel disagrees")
    B, H, S, D = 8, 16, 2048, 128
    launch, _, _ = case(B, H, S, D, True, 5)
    flops = 10 * D * B * H * S * (S + 1) // 2
    res = in_turns(torch, {n: (lambda lib=lib: launch(lib))
                           for n, lib in libs.items()})
    print_turns("bwd", res)
    for n, ts in res.items():
        print(f"[bwd] {n}: {flops / min(ts) / 1e9:.1f} TFLOP/s on the "
              f"10 D FLOPs a pair", flush=True)


# ---------------------------------------------------------------- pairs


def bench_pairs(torch, other, sources):
    from chip_smoke import library_pair_bwd, ring_pair_case
    from paddle_tpu_torch.kernels import flash_attention as fa

    jobs = {"other": (os.path.join(other, CSRC, "flash_attention.cu"), ()),
            "this": (os.path.join(HERE, CSRC, "flash_bwd_sm90.cu"), ())}
    for path in sources:
        jobs[os.path.splitext(os.path.basename(path))[0]] = (path, ())
    libs = build_all(jobs)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old = libs.pop("other")
    old.ring_pair_bwd_dkdv_launch.argtypes = [ptr] * 8 + [i] * 3 + [
        f, i, i, ptr]
    old.ring_pair_bwd_dq_launch.argtypes = [ptr] * 7 + [i] * 3 + [
        f, i, i, ptr]
    entries = {n: lib.ring_pair_bwd_sm90_launch for n, lib in libs.items()}
    for fn in entries.values():
        fn.argtypes = [ptr] * 10 + [i] * 3 + [f, i, ptr]
    stream = torch.cuda.current_stream().cuda_stream
    B, H, S, D = 8, 16, 512, 128
    c = ring_pair_case(torch, fa, B, H, S, D, torch.bfloat16, seed=5)
    do32 = c["do"].float()
    ptrs = (lambda q, k, v, do: [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), c["lse"].data_ptr(),
                                 c["delta"].data_ptr()])

    def check(rc):
        if rc:
            raise SystemExit(f"chip_bench: launch returned {rc}")

    for causal in (False, True):
        k, v = c["pairs"][causal]
        sums = {n: [t.clone() for t in c["start"]]
                for n in ("other", *entries)}
        parts = [torch.empty_like(t) for t in c["start"]]   # dq, dk, dv

        def other_route(sums=sums["other"]):
            # two kernels into fresh fp32 outputs, then the three adds
            check(old.ring_pair_bwd_dkdv_launch(
                *ptrs(c["q"], k, v, do32), parts[1].data_ptr(),
                parts[2].data_ptr(), B * H, S, D, float(c["scale"]),
                int(causal), 1, stream))
            check(old.ring_pair_bwd_dq_launch(
                *ptrs(c["q"], k, v, do32), parts[0].data_ptr(), B * H, S, D,
                float(c["scale"]), int(causal), 1, stream))
            for acc, t in zip(sums, parts):
                acc += t

        def one_kernel(fn, sums):
            check(fn(*ptrs(c["q"], k, v, c["do"]),
                     *[t.data_ptr() for t in sums],
                     fa._dq_turns(c["q"]).data_ptr(), B * H, S, D,
                     float(c["scale"]), int(causal), stream))

        calls = {"other (2 kernels + 3 adds)": other_route}
        tag = f"pairs S={S} {'diagonal' if causal else 'full'}"
        other_route()
        for n, fn in entries.items():
            calls["this (1 kernel)" if n == "this" else n] = (
                lambda fn=fn, sums=sums[n]: one_kernel(fn, sums))
            one_kernel(fn, sums[n])
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max())
                    for a, b in zip(sums["other"], sums[n])]
            ok = all(torch.allclose(a, b, atol=1e-2, rtol=1.6e-2)
                     for a, b in zip(sums["other"], sums[n]))
            print(f"[{tag}] {n} vs other, sums after one pair: max abs "
                  f"diff dq/dk/dv {['%.3g' % e for e in errs]} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if n == "this" and not ok:
                raise SystemExit("chip_bench: the two routes disagree")
        res = in_turns(torch, calls)
        print_turns(tag, res)
        lib_call, why = library_pair_bwd(torch, c, causal)
        print(f"[{tag}] aten flash-attention backward: "
              + (f"{time_ms(torch, lib_call):.4f} ms" if lib_call
                 else f"none ({why})"), flush=True)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        best = min(res["this (1 kernel)"])
        print(f"[{tag}] this: {10 * D * pairs / best / 1e9:.1f} TFLOP/s on "
              f"the 10 D FLOPs a pair", flush=True)


# --------------------------------------------------------------- ragged


def bench_ragged(torch, other, sources):
    from paddle_tpu_torch.kernels import paged_attention as pa

    jobs = {"other": (os.path.join(other, CSRC,
                                   "ragged_paged_attention.cu"), ()),
            "this": (os.path.join(HERE, CSRC, "ragged_paged_attention.cu"),
                     ())}
    for path in sources:
        jobs[os.path.splitext(os.path.basename(path))[0]] = (path, ())
    libs = build_all(jobs)
    kinds = {}
    for name, lib in libs.items():
        fn = lib.ragged_paged_attention_launch
        # three generations of the entry: kv splits with partials
        # scratch; the load mode (one more int); neither
        src = open(jobs[name][0]).read()
        kind = ("split" if "void* partials" in src else
                "vec16" if "int vec16, void* stream" in src else "plain")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "split": [ptr] * 8 + [i] * 9 + [ctypes.c_float, i, i, ptr],
            "vec16": [ptr] * 7 + [i] * 7 + [ctypes.c_float, i, i, ptr],
            "plain": [ptr] * 7 + [i] * 7 + [ctypes.c_float, i, ptr]}[kind]
        fn.restype = ctypes.c_int
        kinds[name] = (fn, kind)
    # the serving engine's batch (q [8, 64, 16, hd] over pages [2048, 16,
    # 16, hd]): chunk + decode rows at the head dim of the 1.3B config
    # and at two others, and every row decoding at the longest context
    serving = ([64] + [1] * 7, [1024, 64, 2048, 1500, 700, 300, 128, 2000])
    shapes = [("serving", 128, *serving), ("all-decode", 128, [1] * 8,
                                           [2048] * 8),
              ("serving", 80, *serving), ("serving", 320, *serving)]
    for (tag, hd, qlens, ctxs), dtype in (
            (shape, dtype) for shape in shapes
            for dtype in (torch.bfloat16, torch.float32)):
        B, Q, H, P, ps, M = 8, 64, 16, 2048, 16, 128
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn((B, Q, H, hd), generator=g, device="cuda").to(dtype)
        kp = torch.randn((P, ps, H, hd), generator=g, device="cuda").to(dtype)
        vp = torch.randn((P, ps, H, hd), generator=g, device="cuda").to(dtype)
        tb = torch.randperm(P, generator=g, device="cuda")[:B * M] \
            .view(B, M).int()
        ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
        cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
        ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
        splits, span = pa._splits(B, Q, H, hd, M * ps)
        part = torch.empty(B * H * Q * splits * (hd + 2), device="cuda")
        dt = 0 if dtype == torch.float32 else 1
        calls = {}
        for name, (fn, kind) in kinds.items():
            out = torch.empty_like(q)
            head = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    tb.data_ptr(), ql.data_ptr(), cl.data_ptr(),
                    out.data_ptr()]
            if kind == "split":
                args = head + [part.data_ptr(), B, Q, H, hd, ps, M, P,
                               splits, span, hd ** -0.5, dt, 1]
            else:
                args = (head + [B, Q, H, hd, ps, M, P, hd ** -0.5, dt]
                        + [1] * (kind == "vec16"))

            def call(fn=fn, args=args):       # on the stream of the moment
                if fn(*args, torch.cuda.current_stream().cuda_stream):
                    raise SystemExit(f"chip_bench: {name} launch failed")

            call()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"[ragged] {name} {tag} hd {hd} {dtype}: max abs err vs "
                  f"plain {err:.3g}", flush=True)
            calls[name] = call
        # device time (CUDA graph replays), then the time with the host's
        # ctypes call in the loop
        print_turns(f"ragged {tag} shape hd {hd} {dtype}, device",
                    in_turns(torch, calls, iters=20, timer=graph_ms))
        print_turns(f"ragged {tag} shape hd {hd} {dtype}, eager",
                    in_turns(torch, calls, iters=200))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("bench", choices=("bwd", "pairs", "ragged"))
    ap.add_argument("paths", nargs="*")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_bench: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.bench == "bwd":
        bench_bwd(torch, args.paths[0] if args.paths else
                  os.path.join(HERE, CSRC, "flash_bwd_sm90.cu"))
    elif not args.paths:
        print(f"chip_bench: {args.bench} needs the other tree",
              file=sys.stderr)
        return 2
    elif args.bench == "pairs":
        bench_pairs(torch, os.path.abspath(args.paths[0]), args.paths[1:])
    else:
        bench_ragged(torch, os.path.abspath(args.paths[0]), args.paths[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
