"""The PyTorch port imports neither jax nor the JAX package.

Importing any ``paddle_tpu`` submodule runs ``paddle_tpu/__init__.py``,
which imports jax, so the port keeps its own copies of what it needs.
The import check runs in a subprocess: this pytest process has jax
loaded already (conftest)."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_sources():
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "build"]   # kernel build output
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py", "chip_ab.py", "chip_bench.py",
                          "chip_probe.py"]


def _module_names():
    names = []
    for rel in _port_sources():
        if not rel.startswith("paddle_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        names.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                     else mod)
    return names


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_module_names()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", _port_sources())
def test_source_imports_no_jax(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{rel} imports {bad}"


def test_entry_points_default_to_cuda_and_never_fall_back():
    """device=None means CUDA; without it every entry point raises and
    names device="cpu" instead of running on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.serving import Engine, PagedKVCache

    cfg = GPT_CONFIGS["tiny"]
    for make in (lambda: gpt_init(cfg),
                 lambda: Engine(cfg),
                 lambda: PagedKVCache(num_layers=1, num_heads=1, head_dim=2,
                                      num_pages=2, page_size=2,
                                      max_seq_len=4)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
