"""The port's serving engine over mp ranks (``Engine(mesh=)``) against the
JAX package, mirroring ``tests/test_mesh.py::TestServingGSPMD``: at that
file's ``CFG`` (fp32) the mp = 2 and mp = 4 engines, one process a rank,
generate the greedy tokens of the JAX ``Engine(mesh=)`` on the same mesh
and of the port's one-process engine, every rank the same tokens; under
dp × mp the page pool is split on mp only; preemption by recompute keeps
token parity.

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``); the
JAX side runs on the virtual CPU devices of ``tests/conftest.py``."""

import jax
import numpy as np
import pytest

from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.serving.engine import Engine as JaxEngine
from paddle_tpu.serving.engine import SamplingParams as JaxSampling

from paddle_tpu_torch.models import GPTConfig, params_from_jax
from paddle_tpu_torch.serving import Engine, SamplingParams
from torch_world import World

CFG_KW = dict(vocab_size=512, max_seq_len=64, hidden=64, num_layers=2,
              num_heads=4, ffn_hidden=256, dtype="float32", use_flash=False,
              remat="nothing")
KW = dict(page_size=8, num_pages=64, max_batch_size=4, chunk_len=16)


def _prompts(n=4):
    return [[int(t) for t in np.random.RandomState(i).randint(
        1, CFG_KW["vocab_size"] - 1, 6 + i)] for i in range(n)]


def _params(seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_gpt_init(JaxGPTConfig(**CFG_KW), jax.random.key(seed)))


def _jax_tokens(params, prompts, sp, kw, **axes):
    mesh = jax_mesh.build_mesh(**axes) if axes else None
    eng = JaxEngine(JaxGPTConfig(**CFG_KW), jax.tree_util.tree_map(
        jax.numpy.asarray, params), mesh=mesh, **kw)
    return [[int(t) for t in o] for o in eng.generate(
        prompts, JaxSampling(**sp))]


def _one_process(params, prompts, sp, kw):
    eng = Engine(GPTConfig(**CFG_KW), params_from_jax(params, device="cpu"),
                 device="cpu", **kw)
    return eng.generate(prompts, SamplingParams(**sp))


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.mark.parametrize("mp", [2, 4])
def test_mp_engine_tokens_equal_jax_mesh_and_one_process(world, mp):
    params = _params(0)
    sp = dict(max_new_tokens=8)
    prompts = _prompts()
    want = _jax_tokens(params, prompts, sp, KW, mp=mp)
    assert _one_process(params, prompts, sp, KW) == want
    res = world.run("torch_dist_cases", "mesh_serving_case", CFG_KW, params,
                    prompts, sp, dict(mp=mp), KW)
    for r in res[:mp]:
        assert r["tokens"] == want
        # the pool holds this rank's H/mp heads; qkv_w its columns
        assert r["pool"][3] == CFG_KW["num_heads"] // mp
        assert r["qkv_w"][-1] == 3 * CFG_KW["hidden"] // mp
        assert r["calls"]["all_reduce"] >= 2 * CFG_KW["num_layers"] * \
            r["steps"]
        assert r["calls"]["broadcast"] == r["steps"]


def test_dp_mp_mesh_pages_split_on_mp_only(world):
    """dp 2 × mp 2: each dp row is its own mp engine; the pool splits on
    mp (H/2 heads a rank), never on dp, and both rows serve."""
    params = _params(0)
    sp = dict(max_new_tokens=4)
    kw = dict(KW, max_batch_size=2)
    prompts = _prompts(2)
    want = _jax_tokens(params, prompts, sp, kw, dp=2, mp=2)
    res = world.run("torch_dist_cases", "mesh_serving_case", CFG_KW, params,
                    prompts, sp, dict(dp=2, mp=2), kw)
    for r in res:
        assert r["pool"][3] == CFG_KW["num_heads"] // 2
        assert r["tokens"] == want
        assert all(len(o) == 4 for o in r["tokens"])


def test_mesh_engine_preemption_keeps_parity(world):
    """A pool of 12 pages of 4 under 3 requests preempts by recompute;
    the mp = 4 engine stays token-identical to the unsharded one."""
    params = _params(1)
    sp = dict(max_new_tokens=6)
    prompts = _prompts(3)
    kw = dict(page_size=4, num_pages=12, max_batch_size=3, chunk_len=8)
    want = _jax_tokens(params, prompts, sp, kw)
    assert _one_process(params, prompts, sp, kw) == want
    res = world.run("torch_dist_cases", "mesh_serving_case", CFG_KW, params,
                    prompts, sp, dict(mp=4), kw)
    for r in res:
        assert r["tokens"] == want
