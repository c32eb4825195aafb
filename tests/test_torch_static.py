"""The port's ``static`` (Program capture, Executor, passes and control
flow) against the JAX package's, case by case as ``tests/test_static.py``
and ``tests/test_control_flow.py`` (and the pass cases of
``tests/test_enforce_passes_ops.py``): each program is built in both
packages on the same weights (carried from JAX) and run on the same
numpy feeds; fp32 results at 1e-5, the bf16 pass at 0.1 as in JAX.

The port records torch calls under ``program_guard`` (a
``TorchFunctionMode``); its cases add an encoder program run at two
batch sizes and the route the executor takes, which is ``"cpu"`` here."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
import paddle_tpu.static as jstatic

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import jit
from torch_eager_ref import carry

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One thread (see ``test_torch_jit.py``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(static, program, feed, fetch, **kw):
    return static.Executor().run(program, feed=feed, fetch_list=fetch, **kw)


def _both(build, feed, seed=0, **kw):
    """``build(static, nn, ops) -> (program, fetch list, layers)`` in each
    package (the port's layers take the JAX layers' weights, in order),
    then both executors on ``feed``; returns (jax outs, port outs, port
    program, port layers)."""
    jpaddle.seed(seed)
    jprog, jfetch, jlayers = build(jstatic, jnn, _JOPS)
    tprog, tfetch, tlayers = build(tstatic, tnn, _TOPS)
    for j, t in zip(jlayers, tlayers):
        carry(j, t)
    jout = _run(jstatic, jprog, feed, jfetch, **kw)
    tout = _run(tstatic, tprog, feed, tfetch, **kw)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b, a, **TOL)
    return jout, tout, tprog, tlayers


class _JOPS:
    relu = staticmethod(jpaddle.ops.relu)
    exp = staticmethod(jpaddle.ops.exp)
    tanh = staticmethod(jpaddle.ops.tanh)
    const = staticmethod(lambda v: jpaddle.to_tensor(np.asarray(v)))


class _TOPS:
    relu = staticmethod(torch.relu)
    exp = staticmethod(torch.exp)
    tanh = staticmethod(torch.tanh)
    const = staticmethod(lambda v: torch.tensor(np.asarray(v)))


class TestProgramCapture:
    def test_build_and_run(self):
        def build(static, nn, ops):
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [None, 8], "float32")
                net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                    nn.Linear(16, 4))
                y = net(x)
            return main, [y], [net]

        arr = np.random.RandomState(0).randn(4, 8).astype(np.float32)
        _, (out,), prog, (net,) = _both(build, {"x": arr})
        assert len(prog.ops) >= 3
        with torch.no_grad():
            np.testing.assert_allclose(out, net(torch.from_numpy(arr)),
                                       **TOL)

    def test_feed_shape_polymorphism(self):
        def build(static, nn, ops):
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [None, 4], "float32")
                lin = nn.Linear(4, 2)
                y = lin(x)
            return main, [y], [lin]

        for bs in (2, 7):
            _, (out,), _, _ = _both(build, {"x": np.ones((bs, 4),
                                                         np.float32)}, 1)
            assert out.shape == (bs, 2)

    def test_param_updates_visible(self):
        tnn_lin = tnn.Linear(3, 3)
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [None, 3], "float32")
            y = tnn_lin(x)
        exe = tstatic.Executor()
        arr = np.eye(3, dtype=np.float32)
        (before,) = exe.run(main, feed={"x": arr}, fetch_list=[y])
        with torch.no_grad():                       # in place
            tnn_lin.weight.mul_(2.0)
            tnn_lin.bias.mul_(2.0)
        (after,) = exe.run(main, feed={"x": arr}, fetch_list=[y])
        np.testing.assert_allclose(after, before * 2.0, **TOL)
        tnn_lin.weight.data = tnn_lin.weight.data * 0.5   # replaced
        tnn_lin.bias.data = tnn_lin.bias.data * 0.5
        (again,) = exe.run(main, feed={"x": arr}, fetch_list=[y])
        np.testing.assert_allclose(again, before, **TOL)
        assert exe.last_route == "cpu"

    def test_program_to_string(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [None, 4], "float32")
            torch.relu(x)
            _ = x.shape                  # attribute reads are not ops
        s = str(main)
        assert "feed x" in s and "relu" in s
        assert [op.name for op in main.ops] == ["relu"]

    def test_multiple_fetches(self):
        def build(static, nn, ops):
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [None, 4], "float32")
                a, b = ops.relu(x), ops.exp(x)
            return main, [a, b], []

        arr = np.array([[-1.0, 0.0, 1.0, 2.0]], np.float32)
        _, (a, b), _, _ = _both(build, {"x": arr})
        np.testing.assert_allclose(a, np.maximum(arr, 0), atol=1e-6)
        np.testing.assert_allclose(b, np.exp(arr), rtol=1e-6)

    def test_encoder_program_at_two_batches(self):
        """The port's encoder records no batch size, so a program built
        at ``[None, 128, 64]`` runs at batch 2 and 3 (the JAX encoder's
        reshape bakes it); each equals the JAX encoder's forward."""
        def build(nn):
            return nn.TransformerEncoder(nn.TransformerEncoderLayer(
                64, 4, 128, dropout=0.0, activation="gelu"), 2)

        jpaddle.seed(4)
        jenc = build(jnn)
        tenc = carry(jenc, build(tnn))
        jenc.eval()
        tenc.eval()
        main = tstatic.Program()
        with tstatic.program_guard(main):
            src = tstatic.data("src", [None, 128, 64], "float32")
            out = tenc(src)
        exe = tstatic.Executor()
        for bs in (2, 3):
            x = np.random.RandomState(bs).randn(bs, 128, 64).astype(
                np.float32)
            (got,) = exe.run(main, feed={"src": x}, fetch_list=[out])
            ref = np.asarray(jjit.to_static(jenc)(jpaddle.to_tensor(x)).data)
            np.testing.assert_allclose(got, ref, **TOL)
        assert "flash_fwd" in str(main)


class TestPasses:
    def test_dead_code_elimination(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [None, 4], "float32")
            live = torch.relu(x)
            dead = torch.exp(x)
            torch.tanh(dead)
        prog = main.clone()
        removed = tstatic.new_pass("dead_code_elimination").apply(
            prog, [main.lookup(live)])
        assert removed == 2
        assert [op.name for op in prog.ops] == ["relu"]
        arr = np.array([[-2.0, 3.0, 0.0, 1.0]], np.float32)
        (out,) = _run(tstatic, main, {"x": arr}, [live])
        np.testing.assert_allclose(out, np.maximum(arr, 0), atol=1e-6)

    def test_amp_bf16_pass(self):
        def build(static, nn, ops):
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [None, 16], "float32")
                lin = nn.Linear(16, 16)
                y = lin(x)
            return main, [y], [lin]

        arr = np.random.RandomState(0).randn(4, 16).astype(np.float32)
        (jfp32,), (fp32,), prog, (lin,) = _both(
            build, {"x": arr}, 3,
            use_passes=("dead_code_elimination", "amp_bf16"))
        assert fp32.dtype == np.float32
        with torch.no_grad():
            ref = lin(torch.from_numpy(arr)).numpy()
        np.testing.assert_allclose(fp32, ref, atol=0.1)
        assert np.abs(fp32 - ref).max() > 0              # really bf16
        n = tstatic.new_pass("amp_bf16").apply(prog.clone())
        assert n >= 1

    def test_pass_registry(self):
        from paddle_tpu_torch.static.passes import PASS_REGISTRY

        for name in ("dead_code_elimination", "amp_bf16",
                     "constant_folding",
                     "common_subexpression_elimination"):
            assert name in PASS_REGISTRY

    @staticmethod
    def _program(static, ops):
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [4], "float32")
            c = ops.const(np.float32(2.0)) * ops.const(np.float32(3.0))
            a = x * 2.0
            b = x * 2.0
            out = a + b + c
        return prog, out

    @pytest.mark.parametrize("name", ["constant_folding",
                                      "common_subexpression_elimination"])
    def test_folding_and_cse(self, name):
        outs = []
        for static, ops in ((jstatic, _JOPS), (tstatic, _TOPS)):
            prog, out = self._program(static, ops)
            n_before = len(prog.ops)
            assert static.new_pass(name).apply(prog, []) >= 1
            assert len(prog.ops) < n_before
            outs.append(_run(static, prog, {"x": np.ones(4, np.float32)},
                             [out], use_passes=())[0])
        np.testing.assert_allclose(outs[1], outs[0], **TOL)
        np.testing.assert_allclose(outs[1], np.full(4, 10.0))

    def test_random_ops_survive_optimization(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            a = torch.rand(4)
            b = torch.rand(4)
            out = a + b
        tstatic.new_pass("constant_folding").apply(prog, [prog.lookup(out)])
        tstatic.new_pass("common_subexpression_elimination").apply(prog, [])
        assert [op.name for op in prog.ops].count("rand") == 2
        ra, rb = _run(tstatic, prog, {}, [a, b], use_passes=())
        assert not np.allclose(ra, rb)


class TestEager:
    def test_cond_eager(self):
        x = torch.tensor(3.0)
        assert float(tstatic.cond(x > 2.0, lambda: x * 2.0,
                                  lambda: x - 1.0)) == 6.0
        assert float(tstatic.cond(x > 5.0, lambda: x * 2.0,
                                  lambda: x - 1.0)) == 2.0

    def test_while_eager(self):
        i, s = tstatic.while_loop(lambda i, s: i < 4.0,
                                  lambda i, s: (i + 1.0, s * 2.0),
                                  [torch.tensor(0.0), torch.tensor(1.0)])
        assert float(i) == 4.0 and float(s) == 16.0

    def test_case_and_switch_eager(self):
        x = torch.tensor(1.0)
        out = tstatic.nn.case([(x > 2.0, lambda: x * 10.0),
                               (x > 0.0, lambda: x + 1.0)],
                              default=lambda: x)
        assert float(out) == 2.0
        out = tstatic.nn.switch_case(torch.tensor(1), {0: lambda: x + 1.0,
                                                       1: lambda: x * 10.0})
        assert float(out) == 10.0


class TestCapturedCond:
    def test_cond_matches_jax_both_ways(self):
        outs = []
        for static in (jstatic, tstatic):
            prog = static.Program()
            with static.program_guard(prog):
                x = static.data("x", [4], "float32")
                out = static.cond(x.sum() > 0.0, lambda: x * 2.0,
                                  lambda: x - 1.0)
            outs.append([_run(static, prog, {"x": v}, [out])[0]
                         for v in (np.ones(4, np.float32),
                                   -np.ones(4, np.float32))])
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, **TOL)
        np.testing.assert_allclose(outs[1][0], np.full(4, 2.0))
        np.testing.assert_allclose(outs[1][1], np.full(4, -2.0))

    def test_branch_mismatch_is_loud(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")
            with pytest.raises(ValueError, match="mismatch"):
                tstatic.cond(x.sum() > 0, lambda: x.reshape([2, 2]),
                             lambda: x * 1.0)
            with pytest.raises(ValueError, match="same number"):
                tstatic.cond(x.sum() > 0, lambda: (x, x), lambda: x)

    def test_params_inside_branch_stay_live(self):
        lin = tnn.Linear(4, 4)
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")
            out = tstatic.cond(x.sum() > 0.0, lambda: lin(x).sum(),
                               lambda: x.sum() * 0.0)
        feed = {"x": np.ones(4, np.float32)}
        exe = tstatic.Executor()
        (before,) = exe.run(prog, feed=feed, fetch_list=[out])
        with torch.no_grad():
            lin.weight.mul_(2.0)
            lin.bias.mul_(2.0)
        (after,) = exe.run(prog, feed=feed, fetch_list=[out])
        np.testing.assert_allclose(after, before * 2.0, rtol=1e-6)

    def test_switch_case_captured(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            idx = tstatic.data("i", [], "int32")
            x = tstatic.data("x", [3], "float32")
            out = tstatic.nn.switch_case(
                idx, {0: lambda: x + 1.0, 1: lambda: x * 10.0},
                default=lambda: x * 0.0)
        xs = np.array([1.0, 2.0, 3.0], np.float32)
        for i, expect in ((0, xs + 1.0), (1, xs * 10.0), (9, xs * 0.0)):
            (r,) = _run(tstatic, prog, {"i": np.int32(i), "x": xs}, [out])
            np.testing.assert_allclose(r, expect)


class TestCapturedWhile:
    def test_while_matches_jax(self):
        outs = []
        for static, const in ((jstatic, jpaddle.to_tensor),
                              (tstatic, torch.tensor)):
            prog = static.Program()
            with static.program_guard(prog):
                x = static.data("x", [], "float32")
                _, acc = static.while_loop(
                    lambda i, acc: i < x, lambda i, acc: (i + 1.0, acc + i),
                    [const(np.float32(0.0)), const(np.float32(0.0))])
            outs.append(_run(static, prog, {"x": np.float32(5.0)}, [acc])[0])
        assert float(outs[1]) == float(outs[0]) == 0 + 1 + 2 + 3 + 4

    def test_loop_until_converged_model(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            a = tstatic.data("a", [], "float32")
            tol = tstatic.data("tol", [], "float32")
            (x,) = tstatic.while_loop(
                lambda x: (x * x - a).abs() > tol,
                lambda x: (0.5 * (x + a / x),), [a / 2.0])
        for val in (9.0, 2.0, 100.0):
            (r,) = _run(tstatic, prog, {"a": np.float32(val),
                                        "tol": np.float32(1e-4)}, [x])
            np.testing.assert_allclose(r, np.sqrt(val), rtol=1e-3)

    def test_carry_signature_change_is_loud(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")
            with pytest.raises(ValueError, match="shape-static"):
                tstatic.while_loop(lambda v: v.sum() < 10.0,
                                   lambda v: (v.reshape([2, 2]),), [x])

    def test_nested_cond_in_while(self):
        def collatz(n):
            steps = 0
            while n != 1:
                n = n // 2 if n % 2 == 0 else 3 * n + 1
                steps += 1
            return steps

        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            n0 = tstatic.data("n", [], "int32")
            _, steps = tstatic.while_loop(
                lambda n, s: n != 1,
                lambda n, s: (tstatic.cond((n % 2) == 0, lambda: n // 2,
                                           lambda: 3 * n + 1), s + 1),
                [n0, torch.tensor(np.int32(0))])
        for val in (6, 27):
            (r,) = _run(tstatic, prog, {"n": np.int32(val)}, [steps])
            assert int(r) == collatz(val)

    def test_control_flow_program_takes_the_eager_route(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")
            out = tstatic.cond(x.sum() > 0.0, lambda: x * 2.0,
                               lambda: x - 1.0)
        assert prog.has_control_flow()
        exe = tstatic.Executor()
        exe.run(prog, feed={"x": np.ones(4, np.float32)}, fetch_list=[out])
        assert exe.last_route == "cpu" and exe.captures == 0


class TestTraceGuard:
    def test_branch_on_traced_tensor_is_loud(self):
        @jit.to_static(device="cpu")
        def f(x):
            if x.sum() > 0:
                return x * 2.0
            return x

        with pytest.raises(Exception, match="cond"):
            f(torch.ones(4))

    def test_cond_and_while_work_under_to_static(self):
        @jit.to_static(device="cpu")
        def f(x):
            doubled = tstatic.cond(x.sum() > 0.0, lambda: x * 2.0,
                                   lambda: x - 1.0)
            (count,) = tstatic.while_loop(
                lambda c: c.sum() < 20.0, lambda c: (c + doubled.sum(),),
                [doubled * 0.0])
            return count

        np.testing.assert_allclose(f(torch.ones(4)).numpy(), np.full(4, 8.0))
        np.testing.assert_allclose(f(torch.full((4,), 2.0)).numpy(),
                                   np.full(4, 16.0))
        ep = f.exported_program(torch.ones(4))
        names = {n.target.name() for n in ep.graph_module.graph.nodes
                 if isinstance(n.target, torch._ops.HigherOrderOperator)}
        assert {"cond", "while_loop"} <= names


class TestReviewRegressions:
    def test_case_without_default_under_capture(self):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")
            out = tstatic.nn.case([(x.sum() > 0.0, lambda: x * 2.0),
                                   (x.sum() <= 0.0, lambda: x - 1.0)])
        pos, neg = np.ones(4, np.float32), -np.ones(4, np.float32)
        (r_pos,) = _run(tstatic, prog, {"x": pos}, [out])
        (r_neg,) = _run(tstatic, prog, {"x": neg}, [out])
        np.testing.assert_allclose(r_pos, pos * 2.0)
        np.testing.assert_allclose(r_neg, neg - 1.0)

    def test_inner_block_tensor_escape_is_loud(self):
        leak = []
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            x = tstatic.data("x", [4], "float32")

            def tf():
                h = x * 2.0
                leak.append(h)
                return h

            tstatic.cond(x.sum() > 0.0, tf, lambda: x * 1.0)
            with pytest.raises(RuntimeError, match="sub-block"):
                _ = leak[0] + 1.0
