#!/usr/bin/env python3
"""Kernel-level A/B benches of the port on one GPU, each in one process.

    python3 chip_bench.py bwd [SOURCE]
    python3 chip_bench.py pairs OTHER_TREE
    python3 chip_bench.py ragged OTHER_TREE [SOURCE ...]

``bwd``: the bf16 flash backward (``flash_bwd_sm90.cu``, or SOURCE) and
scratch copies of it with parts of the dQ work switched off (its reduce,
or the whole dQ product), built side by side and timed in turns at the
GPT-3 1.3B training shapes ([8, 16, 2048, 128] bf16 causal), after a
check of the full kernel against the plain version at several shapes.
The copies compute wrong dQ on purpose: they only say where the time
goes.

``pairs``: the ring-pair backward kernels (``ring_pair_bwd_*_launch``
of ``flash_attention.cu``) of OTHER_TREE (for example the parent commit,
unpacked with ``git archive``) and of this checkout, at a ring pair's
shapes ([8, 16, 512, 128], full and diagonal) and over a whole sequence
([8, 16, 2048, 128] causal), in turns other / this / this / other; the
outputs of the two must be equal bit for bit.

``ragged``: ``ragged_paged_attention.cu`` of OTHER_TREE, of this
checkout and of any further SOURCE files, at the serving shapes of
``chip_smoke.py`` phase 2, bf16 and fp32, in turns.

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


def in_turns(torch, calls, iters=20):
    """{name: fn} timed in the order a, b, ..., ..., b, a; {name: [ms]}."""
    names = list(calls)
    res = {n: [] for n in names}
    for n in names + names[::-1]:
        res[n].append(time_ms(torch, calls[n], iters))
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

    def variant(name, old, new):
        if old not in base:
            raise SystemExit(f"chip_bench: {source} has no {old[:40]!r}")
        path = os.path.join(OUT, f"{name}.cu")
        open(path, "w").write(base.replace(old, new))
        return path, ()

    path = os.path.join(OUT, "as_is.cu")
    open(path, "w").write(base)
    jobs = {"as_is": (path, ())}
    reduce_call = "tma_reduce_add(&tm_dq,"
    if reduce_call in base:      # the dQ reduce-adds skipped
        jobs["no_dq_reduce"] = variant(
            "no_dq_reduce", "            " + reduce_call,
            "            if (false) " + reduce_call)
    jobs["no_dq"] = variant(     # no dQ product and no dQ adds
        "no_dq", "const bool does_dq = DC >= 128 || w == 0;",
        "const bool does_dq = false;")
    libs = build_all(jobs)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.flash_bwd_sm90_launch.argtypes = [ptr] * 9 + [i] * 3 + [f, i, ptr]
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
                dk.data_ptr(), dv.data_ptr(), B * H, S, D, float(scale),
                int(causal), stream)
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


def bench_pairs(torch, other):
    jobs = {"other": (os.path.join(other, CSRC, "flash_attention.cu"), ()),
            "this": (os.path.join(HERE, CSRC, "flash_attention.cu"), ())}
    libs = build_all(jobs)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.ring_pair_bwd_dkdv_launch.argtypes = [ptr] * 8 + [i] * 3 + [
            f, i, i, ptr]
        lib.ring_pair_bwd_dq_launch.argtypes = [ptr] * 7 + [i] * 3 + [
            f, i, i, ptr]
    stream = torch.cuda.current_stream().cuda_stream
    for S, causal in ((512, False), (512, True), (2048, True)):
        B, H, D = 8, 16, 128
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        do = torch.randn((B, H, S, D), generator=g, device="cuda")
        lse = torch.randn((B, H, S), generator=g, device="cuda").abs() + 5
        delta = torch.randn((B, H, S), generator=g, device="cuda")
        outs = {}
        calls = {}
        for name, lib in libs.items():
            dk, dv, dq = (torch.empty((B, H, S, D), device="cuda")
                          for _ in range(3))
            common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr())

            def dkdv(lib=lib, dk=dk, dv=dv, common=common):
                lib.ring_pair_bwd_dkdv_launch(
                    *common, dk.data_ptr(), dv.data_ptr(), B * H, S, D,
                    D ** -0.5, int(causal), 1, stream)

            def dq_(lib=lib, dq=dq, common=common):
                lib.ring_pair_bwd_dq_launch(
                    *common, dq.data_ptr(), B * H, S, D, D ** -0.5,
                    int(causal), 1, stream)

            dkdv()
            dq_()
            torch.cuda.synchronize()
            outs[name] = (dk, dv, dq)
            calls[f"{name} dkdv"] = dkdv
            calls[f"{name} dq"] = dq_
        same = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                     outs["this"]))
        tag = f"pairs S={S} causal={causal}"
        for kernel in ("dkdv", "dq"):
            print_turns(tag, in_turns(torch, {
                n: calls[f"{n} {kernel}"] for n in ("other", "this")}))
        print(f"[{tag}] outputs equal bit for bit: {same}", flush=True)
        if not same:
            raise SystemExit("chip_bench: the two trees' pairs differ")


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
    fns = {}
    for name, lib in libs.items():
        fn = lib.ragged_paged_attention_launch
        # a tree whose entry takes the load mode has one more int argument
        src = open(jobs[name][0]).read()
        n = 2 if "int vec16, void* stream" in src else 1
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * n
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = (fn, n)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        B, Q, H, hd, P, ps, M = 8, 64, 16, 128, 2048, 16, 128
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn((B, Q, H, hd), generator=g, device="cuda").to(dtype)
        kp = torch.randn((P, ps, H, hd), generator=g, device="cuda").to(dtype)
        vp = torch.randn((P, ps, H, hd), generator=g, device="cuda").to(dtype)
        tb = torch.randperm(P, generator=g, device="cuda")[:B * M] \
            .view(B, M).int()
        ql = torch.tensor([64, 1, 1, 1, 1, 1, 1, 1], dtype=torch.int32,
                          device="cuda")
        cl = torch.tensor([1024, 64, 2048, 1500, 700, 300, 128, 2000],
                          dtype=torch.int32, device="cuda")
        ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl)
        calls = {}
        for name, (fn, n) in fns.items():
            out = torch.empty_like(q)
            args = ([q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     tb.data_ptr(), ql.data_ptr(), cl.data_ptr(),
                     out.data_ptr(), B, Q, H, hd, ps, M, P, hd ** -0.5,
                     0 if dtype == torch.float32 else 1]
                    + [1] * (n - 1) + [stream])
            if fn(*args):
                raise SystemExit(f"chip_bench: {name} launch failed")
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"[ragged] {name} {dtype}: max abs err vs plain {err:.3g}",
                  flush=True)
            calls[name] = lambda fn=fn, args=args: fn(*args)
        print_turns(f"ragged serving shapes {dtype}",
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
        bench_pairs(torch, os.path.abspath(args.paths[0]))
    else:
        bench_ragged(torch, os.path.abspath(args.paths[0]), args.paths[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
