"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> --control <k> [--seconds <s>]

For each of ``n`` seeds, in one process: the program's readings (the
numbers a run compares), as a run takes them.  For the first ``k``
seeds also each control's (``reference/lowp.py``: the reference one
precision below the configuration's, put in the program's place; the
cell's own ``control`` unless ``--controls`` names others) and each
fault's the cell can have, planted in the reference put in the
program's place:

- training: half of the batch left out, the mean taken over the rest;
  a state left unchanged reads 1 by the measure and is not run;
- serving: a served token altered where it is produced (each sampled
  request's first served token replaced by the next id).

One JSON line a seed on standard output.  The benchmark's own runs do
not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def detail(prog, ref):
    """The three worst leaves of each gap, and the median leaf's."""
    from statistics import median

    from portbench import compare

    _, gaps = compare.training_gaps(prog, ref)
    return {k: {"worst": sorted(g.items(), key=lambda kv: -kv[1])[:3],
                "median": median(g.values())} for k, g in gaps.items()}


def training(ctx, controls, flags):
    """The program's readings, and each control's and the half-batch
    fault's where ``controls`` names any, all against one reference run
    kept on the device."""
    from portbench import compare
    from portbench.drivers import train
    from portbench.reference import lowp

    flags.restore()
    t = time.perf_counter()
    eng, params, opt, feed, prog = train.first_steps(ctx)
    del eng, params, opt, feed
    free(ctx.device)
    times = {"program": time.perf_counter() - t}
    t = time.perf_counter()
    ref = train.reference(ctx)
    times["reference"] = time.perf_counter() - t
    line = {"program": compare.training(prog, ref),
            "detail": {"program": detail(prog, ref)}}
    del prog
    runs = [(name, {"mm": lowp.CONTROLS[name]}) for name in controls]
    if controls:
        runs.append(("half_batch",
                     {"keep_rows": ctx.cell["traffic"]["batch"] // 2}))
    for name, kw in runs:
        free(ctx.device)
        out = train.reference(ctx, **kw)
        line[name] = compare.training(out, ref)
        line["detail"][name] = detail(out, ref)
        del out
    del ref
    free(ctx.device)
    line["times"] = times
    return line


def serving(ctx, controls, flags):
    """The program's widest gap; each control's, read at the served
    positions as the token the control puts first; and a served token
    altered where it is produced (each sampled request's first served
    token replaced by the next id)."""
    from portbench import compare
    from portbench.drivers import serve
    from portbench.reference import lowp

    flags.restore()
    result, sample = serve.window(ctx)
    free(ctx.device)
    w = serve.reference_weights(ctx.config, ctx.seed, ctx.device)
    gaps = {"program": 0.0}
    for prompt, output in sample:
        ref = serve.reference_logits(ctx.config, w, prompt, output)
        gaps["program"] = max(gaps["program"],
                              compare.widest_gap(ref, output))
        for name in controls:
            low = serve.reference_logits(ctx.config, w, prompt, output,
                                         lowp.CONTROLS[name])
            gaps[name] = max(gaps.get(name, 0.0), compare.widest_gap(
                ref, low.argmax(1).tolist()))
            del low
        if controls:
            bad = [(output[0] + 1) % ctx.config["vocab_size"]] + output[1:]
            gaps["token_altered"] = max(gaps.get("token_altered", 0.0),
                                        compare.widest_gap(ref, bad))
        del ref
    line = {k: {"logit_gap": v} for k, v in gaps.items()}
    line.update(served_checked=result["run"]["served_checked"],
                metrics=result["metrics"])
    del w
    free(ctx.device)
    return line


class Flags:
    """PyTorch's float32 product flags as the process started, which the
    program runs under; the reference turns TF32 off for itself."""

    def __init__(self):
        import torch

        self.torch = torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())

    def restore(self):
        t = self.torch
        (t.backends.cuda.matmul.allow_tf32, t.backends.cudnn.allow_tf32,
         prec) = self.saved
        t.set_float32_matmul_precision(prec)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also run the controls")
    ap.add_argument("--controls", default=None,
                    help="comma-separated names of reference/lowp.py's "
                    "controls (default: the cell's own)")
    ap.add_argument("--first-seed", type=int, default=3000000017)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from portbench import harness, run

    run.caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.benchmark(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    cell = harness.load_json(ROOT, "portbench", "workloads",
                             f"{args.workload}.json")
    config = harness.load_json(ROOT, "portbench", "configs",
                               f"{entry['config']}.json")
    flags = Flags()
    kind = {"train": training, "serve": serving}[cell["driver"]]
    names = (args.controls.split(",") if args.controls
             else [cell["control"]])
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        ctx = harness.Ctx(args.workload, cell, config, seed, args.seconds,
                          False, dev, t0)
        line = kind(ctx, names if i < args.control else [], flags)
        line.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
