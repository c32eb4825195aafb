#!/usr/bin/env python3
"""End-to-end A/B of two trees of the port on one GPU, in turns.

    python3 chip_ab.py OTHER_TREE [--phases 7,10,15b] [--dropout 0,0.1]

Runs ``chip_smoke.py``'s training phases (7: ``HybridEngine`` GPT-3 1.3B
at batch 8 x 2048; 10: the same with sep=4 ring sequence parallelism;
15b: hapi ResNet-50 bf16 O1 at its batches 32 and 128, under PyTorch's
default TF32 flags as phase 15 runs it) for this checkout and for
OTHER_TREE (for example the parent commit,
unpacked with ``git archive``), each run in a fresh process, in the
order other, this, this, other, so both are measured on the same card
in one sitting.  Each tree builds and uses its own kernels and runs its
own ``chip_smoke.prepare`` and ``chip_smoke.phase_train_throughput``
(15b: ``resnet_throughput``), so OTHER_TREE must have them.  ``--dropout`` repeats the four runs at
each residual dropout rate given (GPT-3 1.3B's config with its
``dropout`` replaced; default 0, the config's own).  Prints every run's
ms/step, peak memory, device busy time and launch counts, then one JSON
line with the numbers of every run, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = ("other", "this", "this", "other")


def run_tree(root, tag, phases, dropout):
    """``phases`` (7, 10) of ``root``'s chip_smoke.py in this process, at
    residual dropout ``dropout``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.models import GPT_CONFIGS

    for mod in (cs, paddle_tpu_torch):
        if not mod.__file__.startswith(root):
            raise SystemExit(f"chip_ab: imported {mod.__file__}, not {root}")
    if dropout:
        GPT_CONFIGS["gpt3-1.3b"] = dataclasses.replace(
            GPT_CONFIGS["gpt3-1.3b"], dropout=dropout)
    cs.prepare(torch)
    if "7" in phases:
        cs.phase_train_throughput(torch, tag=f"{tag} phase 7")
    if "10" in phases:
        cs.phase_train_throughput(torch, sep=cs.RING_SEP,
                                  tag=f"{tag} phase 10")
    if "15b" in phases:
        import paddle_tpu_torch as paddle

        with cs.torch_default_tf32(torch):
            for B in cs.RESNET_BATCHES:
                cs.resnet_throughput(torch, paddle, B)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--phases", default="7,10",
                    help="the training phases to run, of 7, 10 and 15b")
    ap.add_argument("--dropout", default="0",
                    help="residual dropout rates, comma-separated")
    ap.add_argument("--run", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)   # one run, in a child process
    args = ap.parse_args()
    phases = args.phases.split(",")
    if args.run:
        run_tree(os.path.abspath(args.run[0]), args.run[1], phases,
                 float(args.dropout))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.other is None or not os.path.exists(
            os.path.join(args.other, "chip_smoke.py")):
        print("chip_ab: give the other tree (a checkout with chip_smoke.py)",
              file=sys.stderr)
        return 2
    roots = {"this": HERE, "other": os.path.abspath(args.other)}
    pat = re.compile(r"^\[(\w+) (phase \d+)\] HybridEngine .*?: "
                     r"([\d.]+) ms/step.*?peak memory ([\d.]+) GiB")
    busy = re.compile(r"^\[(\w+) (phase \d+)\] one traced step .*?device "
                      r"busy ([\d.]+) ms")
    resnet = re.compile(r"^\[phase 15b\] ResNet-50 bench_resnet protocol, "
                        r"batch (\d+): ([\d.]+) imgs/s, ([\d.]+) ms/step")
    runs = []
    for rate, tag in ((r, t) for r in args.dropout.split(",")
                      for t in ORDER):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", roots[tag],
             tag, "--phases", args.phases, "--dropout", rate],
            cwd=roots[tag], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
            raise SystemExit(f"chip_ab: the {tag} run failed")
        run = {"tree": tag, "dropout": float(rate)}
        print(f"chip_ab: {tag} tree, dropout {rate}")
        for line in out.stdout.splitlines():
            if line.startswith((f"[{tag} phase", "[phase 15b]")):
                print(line[:300])
            m = resnet.match(line)
            if m:
                run[f"15b batch {m.group(1)} ms/step"] = float(m.group(3))
            m = pat.match(line)
            if m:
                run[f"{m.group(2)} ms/step"] = float(m.group(3))
                run[f"{m.group(2)} peak GiB"] = float(m.group(4))
            m = busy.match(line)
            if m:
                run[f"{m.group(2)} busy ms"] = float(m.group(3))
        runs.append(run)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"runs": runs}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
