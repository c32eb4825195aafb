"""User-facing autograd (the port of ``paddle_tpu/autograd``): ``PyLayer``,
``PyLayerContext``, ``backward``, and the functional ``grad``,
``no_grad``, ``enable_grad`` and ``is_grad_enabled`` that the JAX
package's top level exports from ``core/autograd.py``.

torch's autograd takes the role of the JAX package's tape: a ``PyLayer``
runs as a ``torch.autograd.Function`` built once for each subclass, so
it composes with hooks, ``grad``, ``retain_graph`` and, when the user's
backward is made of differentiable ops, grad-of-grad.  The port's
tensors are torch tensors, so Paddle's ``stop_gradient`` is
``requires_grad`` negated."""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext", "grad", "backward", "no_grad",
           "enable_grad", "is_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: seed several roots into one joint walk,
    so roots sharing a subgraph accumulate correctly."""
    tensors = _as_list(tensors)
    grad_tensors = ([None] * len(tensors) if grad_tensors is None
                    else _as_list(grad_tensors))
    if len(grad_tensors) != len(tensors):
        raise ValueError(
            f"backward(): {len(tensors)} tensors but {len(grad_tensors)} "
            f"grad_tensors — lengths must match")
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad: gradients of ``outputs`` with respect to ``inputs``,
    written to no ``.grad``; a list, one entry an input.  An input the
    outputs do not reach raises unless ``allow_unused`` (then its
    gradient is None)."""
    outs, ins = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
        if len(grad_outputs) != len(outs):
            raise ValueError(
                f"grad(): {len(outs)} outputs but {len(grad_outputs)} "
                f"grad_outputs — lengths must match")
    got = torch.autograd.grad(outs, ins, grad_outputs,
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError(
            "grad(): an input is not reached by the outputs; pass "
            "allow_unused=True to get None for it")
    return list(got)


class PyLayerContext:
    """Carries state from forward to backward (``py_layer.py``
    ``PyLayerContext``): ``save_for_backward`` and ``saved_tensor``."""

    def __init__(self):
        self._saved = ()
        self.not_inplace = False

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return list(self._saved)


def _function(cls):
    """The ``torch.autograd.Function`` of a ``PyLayer`` subclass, made on
    its first ``apply``.  The tensors the user saves go through torch's
    ``save_for_backward``, so a backward run with ``create_graph``
    differentiates through them."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        pctx = PyLayerContext()
        outputs = cls.forward(pctx, *args, **kwargs)
        outs = _as_list(outputs)
        for o in outs:
            if not isinstance(o, torch.Tensor):
                raise TypeError(f"{cls.__name__}.forward must return "
                                f"Tensor(s), got {type(o).__name__}")
        ctx.pylayer = pctx
        ctx.tensor_at = [i for i, a in enumerate(args)
                         if isinstance(a, torch.Tensor)]
        ctx.n_args = len(args)
        ctx.save_for_backward(*pctx._saved)
        return outputs

    def backward(ctx, *grads):
        pctx = ctx.pylayer
        pctx._saved = ctx.saved_tensors
        gs = _as_list(cls.backward(pctx, *grads))
        if len(gs) != len(ctx.tensor_at):
            raise RuntimeError(
                f"{cls.__name__}.backward returned {len(gs)} gradient(s) "
                f"for {len(ctx.tensor_at)} Tensor input(s)")
        full = [None] * ctx.n_args
        for i, g in zip(ctx.tensor_at, gs):
            full[i] = g
        return (None, *full)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """Custom autograd op: subclass with ``@staticmethod forward(ctx,
    ...)`` and ``backward(ctx, *output_grads)``; call ``.apply(...)``.
    backward returns one gradient per Tensor positional input of forward,
    in order (None for one that needs none)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function(cls).apply(kwargs, *args)
