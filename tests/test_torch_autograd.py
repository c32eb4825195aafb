"""The port's ``autograd`` (``PyLayer``, ``backward``, ``grad``) against
the JAX package's, case by case as ``tests/test_autograd_extras.py``:
each case runs once through each package on the same numpy inputs, and
the port's gradients must equal the JAX package's at 1e-6 and the closed
form or the numeric reference the JAX test holds them to.  The tape
behaviours of the JAX package (hooks, pruned partial grads) are torch's
own autograd in the port; their cases are held the same way."""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from torch_eager_ref import carry

TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_tensor(a, requires_grad=True):
    t = jpaddle.to_tensor(np.asarray(a, np.float32))
    t.stop_gradient = not requires_grad
    return t


JAX = types.SimpleNamespace(
    t=_jax_tensor, np=lambda t: np.asarray(t.data),
    grad_of=lambda x: np.asarray(x.grad.data),
    retain=lambda t: t.retain_grads(),
    grad=jpaddle.grad, backward=jpaddle.autograd.backward,
    PyLayer=jpaddle.autograd.PyLayer, stopped=lambda t: t.stop_gradient)
PORT = types.SimpleNamespace(
    t=lambda a, requires_grad=True: torch.tensor(
        np.asarray(a, np.float32), requires_grad=requires_grad),
    np=lambda t: t.detach().numpy(), grad_of=lambda x: x.grad.numpy(),
    retain=lambda t: t.retain_grad(),
    grad=tpaddle.grad, backward=tpaddle.autograd.backward,
    PyLayer=tpaddle.autograd.PyLayer,
    stopped=lambda t: not t.requires_grad)


def both(case, expect=None):
    """Run ``case(pkg)`` in each package; the results (lists of arrays)
    must agree at 1e-6, and with ``expect`` where given."""
    j, t = case(JAX), case(PORT)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, **TOL)
    if expect is not None:
        for b, e in zip(t, expect):
            np.testing.assert_allclose(b, e, **TOL)
    return t


class TestHooks:
    def test_hook_sees_final_accumulated_grad(self):
        def case(p):
            x = p.t([1.0, 2.0])
            seen = []
            x.register_hook(lambda g: seen.append(p.np(g)))
            ((x * x).sum() + (3.0 * x).sum()).backward()
            assert len(seen) == 1
            return [seen[0], p.grad_of(x)]

        both(case, [[5.0, 7.0], [5.0, 7.0]])

    def test_hook_modifies_propagated_grad(self):
        def case(p):
            x = p.t([1.0, 2.0])
            y = x * 2.0
            y.register_hook(lambda g: g * 10.0)
            y.sum().backward()
            return [p.grad_of(x)]

        both(case, [[20.0, 20.0]])

    def test_hook_remove(self):
        def case(p):
            x = p.t([1.0])
            calls = []
            handle = x.register_hook(lambda g: calls.append(1))
            handle.remove()
            (x * 2.0).sum().backward()
            return [np.float32(len(calls))]

        both(case, [0.0])

    def test_intermediate_hook_affects_retained_grad(self):
        def case(p):
            x = p.t([3.0])
            y = x * 2.0
            p.retain(y)
            y.register_hook(lambda g: g * 5.0)
            (y * 1.0).sum().backward()
            return [p.grad_of(y), p.grad_of(x)]

        both(case, [[5.0], [10.0]])


class TestFunctionalGrad:
    @pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
    def test_grad_outputs_length_mismatch_raises(self, p):
        x = p.t([1.0, 1.0, 1.0])
        y1, y2 = (x * 2.0).sum(), (x * 3.0).sum()
        with pytest.raises(ValueError, match="lengths must match"):
            p.grad([y1, y2], [x], grad_outputs=[p.t(1.0, False)])

    def test_hook_on_output_that_feeds_another_output(self):
        def case(p):
            x = p.t([1.0, 1.0, 1.0])
            y = x * 2.0
            z = (y * 3.0).sum()
            seen = []

            def hook(g):
                seen.append(p.np(g).copy())
                return g * 2.0

            y.register_hook(hook)
            gx = p.grad([y.sum(), z], [x])[0]
            return [seen[0], p.np(gx)]

        both(case, [[4.0] * 3, [16.0] * 3])

    def test_grad_basic(self):
        def case(p):
            x = p.t([2.0, 3.0])
            (gx,) = p.grad((x ** 3).sum(), [x])
            assert x.grad is None
            return [p.np(gx)]

        both(case, [[12.0, 27.0]])

    def test_grad_allow_unused(self):
        def case(p):
            x, z = p.t([1.0]), p.t([1.0])
            with pytest.raises(RuntimeError, match="allow_unused"):
                p.grad((x * 2.0).sum(), [x, z])
            gx, gz = p.grad((x * 2.0).sum(), [x, z], allow_unused=True)
            assert gz is None
            return [p.np(gx)]

        both(case, [[2.0]])

    def test_double_grad_closed_form(self):
        def case(p):
            x = p.t([2.0])
            (gx,) = p.grad((x ** 3).sum(), [x], create_graph=True)
            (ggx,) = p.grad(gx.sum(), [x])
            return [p.np(ggx)]

        both(case, [[12.0]])

    def test_gradient_penalty_matches_jax(self):
        """loss = f(x) + ||∇x f||² through a small MLP carried from JAX;
        the JAX test holds its own to central differences."""
        jpaddle.seed(7)
        jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(),
                              jnn.Linear(8, 1))
        tnet = carry(jnet, tnn.Sequential(tnn.Linear(4, 8), tnn.Tanh(),
                                          tnn.Linear(8, 1)))
        x0 = np.random.RandomState(0).randn(2, 4).astype(np.float32)

        def case(p, net):
            x = p.t(x0)
            f = net(x).sum()
            (gx,) = p.grad(f, [x], create_graph=True)
            (f + (gx ** 2).sum()).backward()
            return [p.grad_of(x)]

        np.testing.assert_allclose(case(PORT, tnet)[0], case(JAX, jnet)[0],
                                   rtol=1e-5, atol=1e-6)

    def test_double_grad_through_params(self):
        def case(p):
            x, w = p.t([1.5]), p.t([2.0])
            (gx,) = p.grad((w * x ** 2).sum(), [x], create_graph=True)
            (gw,) = p.grad(gx.sum(), [w])
            return [p.np(gw)]

        both(case, [[3.0]])


def _square(p):
    class Square(p.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2.0 * x

    return Square


class TestPyLayer:
    def test_forward_backward_round_trip(self):
        x0 = np.random.RandomState(3).randn(5).astype(np.float32)

        def case(p):
            x = p.t(x0)
            y = _square(p).apply(x)
            (y * p.t(np.arange(5.0), False)).sum().backward()
            return [p.np(y), p.grad_of(x)]

        both(case, [x0 * x0, 2.0 * x0 * np.arange(5.0)])

    def test_multiple_inputs_and_outputs(self):
        def case(p):
            class MulAdd(p.PyLayer):
                @staticmethod
                def forward(ctx, a, b):
                    ctx.save_for_backward(a, b)
                    return a * b, a + b

                @staticmethod
                def backward(ctx, d_mul, d_add):
                    a, b = ctx.saved_tensor()
                    return d_mul * b + d_add, d_mul * a + d_add

            a, b = p.t([2.0]), p.t([5.0])
            prod, tot = MulAdd.apply(a, b)
            (prod + 2.0 * tot).sum().backward()
            return [p.grad_of(a), p.grad_of(b)]

        both(case, [[7.0], [4.0]])

    @pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
    def test_wrong_grad_count_is_loud(self, p):
        class Bad(p.PyLayer):
            @staticmethod
            def forward(ctx, a, b):
                return a + b

            @staticmethod
            def backward(ctx, dy):
                return dy        # two inputs, one grad

        a, b = p.t([1.0]), p.t([1.0])
        with pytest.raises(RuntimeError, match="gradient"):
            Bad.apply(a, b).sum().backward()

    @pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
    def test_no_track_when_inputs_stopped(self, p):
        class Ident(p.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 1.0

            @staticmethod
            def backward(ctx, dy):
                return dy

        assert p.stopped(Ident.apply(p.t([1.0], requires_grad=False)))

    def test_double_grad_through_pylayer(self):
        def case(p):
            class Cube(p.PyLayer):
                @staticmethod
                def forward(ctx, x):
                    ctx.save_for_backward(x)
                    return x * x * x

                @staticmethod
                def backward(ctx, dy):
                    (x,) = ctx.saved_tensor()
                    return dy * 3.0 * x * x

            x = p.t([2.0])
            (gx,) = p.grad(Cube.apply(x).sum(), [x], create_graph=True)
            (ggx,) = p.grad(gx.sum(), [x])
            return [p.np(gx), p.np(ggx)]

        both(case, [[12.0], [12.0]])


class TestMultiRootBackward:
    def test_shared_subgraph_joint_walk(self):
        def case(p):
            x = p.t([1.0, 2.0])
            h = x * 2.0
            p.backward([(h * h).sum(), (h * 3.0).sum()])
            return [p.grad_of(x)]

        both(case, [[14.0, 22.0]])

    @pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
    def test_length_mismatch_raises(self, p):
        x = p.t([1.0])
        with pytest.raises(ValueError, match="lengths must match"):
            p.backward([(x * 2.0).sum(), (x * 3.0).sum()],
                       grad_tensors=[p.t([1.0], False)])

    def test_duplicate_roots_accumulate(self):
        def case(p):
            x = p.t([2.0])
            y = (x * x).sum()
            p.backward([y, y], retain_graph=True)
            return [p.grad_of(x)]

        both(case, [[8.0]])


class TestPartialGradPruning:
    def test_side_branch_not_differentiated(self):
        def case(p):
            x = p.t([1.0, 2.0])
            mid = x * 3.0
            (g,) = p.grad((mid * mid).sum(), [mid])
            mid.sum().backward()
            return [p.np(g), p.grad_of(x)]

        both(case, [[6.0, 12.0], [3.0, 3.0]])

    def test_pruned_grad_still_exact_with_fanout(self):
        def case(p):
            x = p.t([1.0, 3.0])
            h = x * x
            (g,) = p.grad((h * 2.0).sum() + (h * 5.0).sum(), [x])
            return [p.np(g)]

        both(case, [14.0 * np.array([1.0, 3.0])])

    def test_hook_on_nontarget_leaf_with_pruned_consumer_stays_silent(self):
        def case(p):
            x = p.t([1.0, 2.0])
            h = p.t([3.0, 4.0])
            fired = []
            h.register_hook(lambda g: fired.append(1))
            (g,) = p.grad((x * h).sum() + (h * h).sum(), [x])
            assert fired == []
            return [p.np(g)]

        both(case, [[3.0, 4.0]])

    def test_hook_on_pruned_producer_target_still_fires(self):
        def case(p):
            x = p.t([1.0, 2.0])
            mid = x * 3.0
            mid.register_hook(lambda g: g * 10.0)
            (g,) = p.grad((mid * mid).sum(), [mid])
            return [p.np(g)]

        both(case, [[60.0, 120.0]])

    def test_hook_on_nontarget_pruned_intermediate_does_not_fire(self):
        def case(p):
            x, w = p.t([1.0, 2.0]), p.t([3.0, 4.0])
            m = w * 2.0
            fired = []
            m.register_hook(lambda g: fired.append(1))
            (g,) = p.grad((x * m).sum() + (m * m).sum(), [x])
            assert fired == []
            return [p.np(g)]

        both(case, [[6.0, 8.0]])
