"""Static control flow — cond / while_loop (the port of
``paddle_tpu/static/control_flow.py``; reference parity:
paddle.static.nn.cond / while_loop over
operators/controlflow/conditional_block_op.cc and while_op.cc).

Three settings, as in the JAX package:

- eagerly (no program being built, no trace): Python ``if`` / ``while``
  on the concrete predicate, the reference's dygraph path;
- under program capture: a branch or body is recorded into a CHILD
  Program whose free variables (enclosing-block vids) become inputs of
  ONE ``cond`` / ``while`` op in the parent block; replaying the op runs
  the child's op list under a Python ``if`` / ``while`` on the
  predicate.  A program holding such an op replays eagerly on the card
  (``Executor`` reports the route): the predicate is read on the host;
- under ``jit.to_static`` (a ``torch.export`` trace): ``torch.cond`` and
  torch's ``while_loop`` higher-order operator, the counterparts of
  ``lax.cond`` / ``lax.while_loop``.
"""
from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop as _torch_while

from .program import Program, _paused, current_program, program_guard

__all__ = ["cond", "while_loop"]


def _as_tensor_list(out, what):
    if out is None:
        return []
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise TypeError(f"{what} must return Tensor(s), got "
                            f"{type(o).__name__}")
    return outs


def _aval(t):
    return (tuple(t.shape), t.dtype)


class _Block:
    """One captured sub-block: child Program, its out vids and free
    variables."""

    def __init__(self, fn, parent, placeholders=()):
        self.sub = Program(parent=parent)
        phs, self.ph_vids = [], []
        for t in placeholders:
            ph, vid = self.sub.add_local_like(t)
            phs.append(ph)
            self.ph_vids.append(vid)
        with program_guard(self.sub):
            outs = _as_tensor_list(fn(*phs), getattr(fn, "__name__", "block"))
        self.outs = outs
        self.out_vids = []
        for o in outs:
            # an output computed in the block, or a pass-through of a
            # placeholder or an outer variable
            vid = self.sub.lookup_chain(o)
            if vid is None:
                raise ValueError(
                    "control-flow block returned a tensor that was not "
                    "computed from its inputs or enclosing-block variables")
            self.out_vids.append(vid)
        self.free = dict(self.sub.free_vars)       # vid -> tensor


def _free_of(*blocks):
    vids = sorted(set().union(*(b.free for b in blocks)))
    tensors = [next(b.free[v] for b in blocks if v in b.free) for v in vids]
    return vids, tensors


def _record(prog, name, fn, inputs, outs):
    """Record ``fn(*inputs) -> outs`` as one op of ``prog``."""
    prog.record(fn, tuple(inputs), {}, tuple(outs), always=True)
    prog.ops[-1].name = name


def cond(pred, true_fn=None, false_fn=None, name=None):
    """paddle.static.nn.cond parity.  Eagerly: Python if/else.  Under
    program capture: ONE cond op.  Under ``jit.to_static``: ``torch.cond``
    (the construct the trace's error tells users to reach for)."""
    prog = current_program()
    if prog is None:
        if torch.compiler.is_compiling():
            return torch.cond(pred.reshape(()),
                              true_fn or (lambda: None),
                              false_fn or (lambda: None), ())
        taken = true_fn if bool(pred) else false_fn
        return taken() if taken is not None else None

    tb = _Block(true_fn or (lambda: []), prog)
    fb = _Block(false_fn or (lambda: []), prog)
    if len(tb.outs) != len(fb.outs):
        raise ValueError(
            f"cond branches must return the same number of tensors: "
            f"true_fn returned {len(tb.outs)}, false_fn {len(fb.outs)}")
    for i, (a, b) in enumerate(zip(tb.outs, fb.outs)):
        if _aval(a) != _aval(b):
            raise ValueError(
                f"cond branch output {i} mismatch: true_fn "
                f"{_aval(a)} vs false_fn {_aval(b)} — both branches must "
                f"produce identical shapes/dtypes")
    free_vids, free_tensors = _free_of(tb, fb)
    t_sub, f_sub, t_out, f_out = tb.sub, fb.sub, tb.out_vids, fb.out_vids

    def run_cond(pred_val, *vals):
        env = dict(zip(free_vids, vals))
        if bool(pred_val):
            return tuple(t_sub.replay_env(env, t_out))
        return tuple(f_sub.replay_env(env, f_out))

    # capture-time value: the true branch's outputs stand for both (their
    # shapes and dtypes were checked equal above)
    with _paused():
        outs = [o.detach() for o in tb.outs]
    _record(prog, "cond", run_cond, (pred, *free_tensors), outs)
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """paddle.static.nn.while_loop parity.  Eagerly: a Python while.
    Under capture: ONE while op (condition and body each captured into a
    child Program with the loop vars as block-local placeholders).  Under
    ``jit.to_static``: torch's ``while_loop`` operator."""
    loop_vars = list(loop_vars)
    for v in loop_vars:
        if not isinstance(v, torch.Tensor):
            raise TypeError("while_loop loop_vars must be Tensors")
    prog = current_program()
    if prog is None:
        if torch.compiler.is_compiling():
            def body(*carry):
                return tuple(_as_tensor_list(body_fn(*carry),
                                             "while_loop body"))

            return list(_torch_while(
                lambda *c: cond_fn(*c).reshape(()), body, tuple(loop_vars)))
        vals = loop_vars
        while bool(cond_fn(*vals)):
            vals = _as_tensor_list(body_fn(*vals), "while_loop body")
            if len(vals) != len(loop_vars):
                raise ValueError(
                    f"while_loop body returned {len(vals)} vars for "
                    f"{len(loop_vars)} loop_vars")
        return vals

    cb = _Block(cond_fn, prog, placeholders=loop_vars)
    bb = _Block(body_fn, prog, placeholders=loop_vars)
    if len(cb.outs) != 1 or cb.outs[0].numel() != 1:
        raise ValueError("while_loop condition must return one scalar "
                         "boolean tensor")
    if len(bb.outs) != len(loop_vars):
        raise ValueError(
            f"while_loop body returned {len(bb.outs)} vars for "
            f"{len(loop_vars)} loop_vars")
    for i, (v, o) in enumerate(zip(loop_vars, bb.outs)):
        if _aval(v) != _aval(o):
            raise ValueError(
                f"while_loop carry {i} changed signature: init {_aval(v)} "
                f"vs body output {_aval(o)} — loop carries are "
                f"shape-static")
    free_vids, free_tensors = _free_of(cb, bb)
    n_loop = len(loop_vars)
    c_sub, b_sub = cb.sub, bb.sub
    c_ph, b_ph, c_out, b_out = cb.ph_vids, bb.ph_vids, cb.out_vids, \
        bb.out_vids

    def run_while(*vals):
        carry = tuple(vals[:n_loop])
        free_env = dict(zip(free_vids, vals[n_loop:]))

        def step(sub, ph, out):
            env = dict(free_env)
            env.update(zip(ph, carry))
            return sub.replay_env(env, out)

        while bool(step(c_sub, c_ph, c_out)[0]):
            carry = tuple(step(b_sub, b_ph, b_out))
        return carry

    with _paused():
        outs = [v.detach() for v in loop_vars]
    _record(prog, "while", run_while, (*loop_vars, *free_tensors), outs)
    return outs
