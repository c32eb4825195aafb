"""paddle.static.nn namespace parity (the port of
``paddle_tpu/static/nn.py``): control flow.  The layer functions (fc,
conv2d, ...) are the same nn.functional ops recorded under
program_guard, so they need no static variants."""
from __future__ import annotations

from .control_flow import cond, while_loop

__all__ = ["cond", "while_loop", "case", "switch_case"]


def case(pred_fn_pairs, default=None, name=None):
    """Chained cond (reference static/nn/control_flow.py case): the first
    true predicate's fn runs; built as nested cond ops.  With
    ``default=None`` the LAST pair's fn is the default (reference
    semantics)."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("case() needs at least one (pred, fn) pair")
    if default is None:
        _, default = pairs.pop()
        if not pairs:
            return default()

    def build(rest):
        (pred, fn), tail = rest[0], rest[1:]
        if not tail:
            return cond(pred, fn, default)
        return cond(pred, fn, lambda: build(tail))

    return build(pairs)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Integer-indexed dispatch (reference switch_case), built as nested
    cond on equality tests.  With ``default=None`` the fn of the max
    index is the default (reference semantics)."""
    items = (sorted(branch_fns.items()) if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))
    if default is None:
        _, default = items.pop()          # max index (items sorted)
        if not items:
            return default()
    pairs = [(branch_index == int(i), fn) for i, fn in items]
    return case(pairs, default=default)
