"""Run one cell of the benchmark of ``paddle_tpu_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
run's result as one JSON object; the last lines of standard error give
each number compared beside its limit.  Exits with 2, printing no
result, where CUDA or the cell's cards are missing, and with 3 where a
module of JAX or of the JAX package was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_tpu")


def caches(root):
    """Every compile cache at a fixed directory inside the checkout."""
    base = os.path.join(root, "portbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_loaded(names=None):
    """The forbidden top-level names among ``names`` (default: the
    modules this process holds), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device=None, override=None):
    """The command.  ``device`` and ``override`` are the CPU tests': a
    device given skips the look for a card, and ``override(cell,
    config)`` cuts the sizes (``harness.run_cell``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches(ROOT)
    sys.path.insert(0, ROOT)
    from portbench import harness

    import torch

    entry = harness.cell_entry(harness.benchmark(ROOT), args.workload)
    if device is None and (not torch.cuda.is_available() or
                           torch.cuda.device_count() < entry["chips"]):
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch

    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(
            os.path.join(ROOT, "")):
        print(f"portbench: paddle_tpu_torch is not this checkout's "
              f"({paddle_tpu_torch.__file__})", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device or torch.device("cuda", 0),
                              T_START, root=ROOT, override=override)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: this process loaded {bad}", file=sys.stderr)
        return 3
    result["card"] = card() if device is None else "none"
    print(f"portbench: the check took {result.pop('check_s'):.3f} s",
          file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
