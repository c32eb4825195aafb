"""No run loads JAX or the JAX package, and the reference loads nothing
of the program.  Each check runs in a fresh interpreter, so what it sees
in ``sys.modules`` is what the run itself loaded; names are compared by
their part before the first dot, so ``paddle_tpu_torch`` is not
``paddle_tpu``."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_tpu")


def loaded(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = (f"{code}\nimport sys, json\n"
             f"print(json.dumps(sorted({{m.split('.')[0] for m in "
             f"sys.modules}})))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_loads_no_jax(cell, trace):
    names = loaded(f"from portbench.tests import small\n"
                   f"small.run({cell!r}, seconds=2.0, trace={trace})")
    assert "paddle_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = loaded("import portbench.reference.models, "
                   "portbench.reference.training, portbench.reference.lowp")
    assert not names & {"paddle_tpu_torch", *FORBIDDEN}


def test_run_names_a_loaded_jax_package_by_its_whole_name():
    from portbench import run

    assert run.forbidden_loaded(["paddle_tpu_torch", "paddle_tpu_torch.nn",
                                 "jaxtyping", "numpy"]) == []
    assert run.forbidden_loaded(["paddle_tpu.kernels", "jax.numpy",
                                 "flax", "torch"]) == ["flax", "jax",
                                                       "paddle_tpu"]
