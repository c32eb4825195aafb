"""Program passes (the port of ``paddle_tpu/static/passes.py``; reference
parity: framework/ir/pass.h:53 ``Pass`` + REGISTER_PASS:317, and the
python pass registry distributed/passes/pass_base.py).

Passes rewrite a Program's op list in place: dead-op elimination, bf16
auto-cast over the matmul-class calls (the static-AMP pass), constant
folding and common-subexpression elimination.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .program import OpDesc, Program, _ParamRef, _VarRef

__all__ = ["Pass", "register_pass", "new_pass", "PASS_REGISTRY",
           "DeadCodeEliminationPass", "AmpBf16Pass", "ConstantFoldingPass",
           "CSEPass"]

PASS_REGISTRY: dict[str, type] = {}

# calls whose replay must DRAW, not replay a baked sample: folding or
# merging them changes semantics (the reference constant_folding_pass
# excludes nondeterministic ops the same way)
RANDOM_OPS = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "uniform", "uniform_", "normal",
              "normal_", "bernoulli", "bernoulli_", "multinomial",
              "exponential_", "poisson", "dropout", "native_dropout",
              "alpha_dropout", "feature_alpha_dropout", "rrelu"}


def register_pass(name):
    def deco(cls):
        cls.pass_name = name
        PASS_REGISTRY[name] = cls
        return cls

    return deco


def new_pass(name, attrs=None):
    cls = PASS_REGISTRY[name]
    return cls(**(attrs or {}))


class Pass:
    pass_name = "base"

    def apply(self, program: Program, fetch_vids=()):
        raise NotImplementedError


@register_pass("dead_code_elimination")
class DeadCodeEliminationPass(Pass):
    """Drop ops whose outputs reach neither a fetch target nor another
    live op (prune.cc / graph DCE analog)."""

    def apply(self, program, fetch_vids=()):
        live = set(fetch_vids)
        kept = []
        for op in reversed(program.ops):
            if any(v in live for v in op.out_vids):
                kept.append(op)
                live.update(op.input_vids())
        removed = len(program.ops) - len(kept)
        program.ops = list(reversed(kept))
        program.version += 1
        return removed


@register_pass("amp_bf16")
class AmpBf16Pass(Pass):
    """Static AMP: the matmul-class calls compute on bf16 copies of their
    fp32 tensor inputs, and their bf16 results return in fp32 (the
    reference's fluid/contrib/mixed_precision program rewrite; white-list
    style)."""

    WHITE_LIST = {"matmul", "__matmul__", "mm", "bmm", "addmm", "einsum",
                  "linear", "conv1d", "conv2d", "conv3d"}

    def __init__(self, white_list=None):
        self.white = set(white_list) if white_list else set(self.WHITE_LIST)

    def apply(self, program, fetch_vids=()):
        count = 0
        for op in program.ops:
            if op.name in self.white:
                op.fn = self._wrap(op.fn)
                count += 1
        program.version += 1
        return count

    @staticmethod
    def _wrap(fn):
        if getattr(fn, "_amp_bf16_wrapped", False):
            return fn

        def fp32(x):
            return isinstance(x, torch.Tensor) and x.dtype == torch.float32

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            upcast = any(fp32(a) for a in pytree.tree_leaves((args, kwargs)))
            args, kwargs = pytree.tree_map(
                lambda x: x.to(torch.bfloat16) if fp32(x) else x,
                (args, kwargs))
            out = fn(*args, **kwargs)
            if upcast:
                out = pytree.tree_map(
                    lambda o: o.float() if isinstance(o, torch.Tensor)
                    and o.dtype == torch.bfloat16 else o, out)
            return out

        wrapped._amp_bf16_wrapped = True
        return wrapped


@register_pass("constant_folding")
class ConstantFoldingPass(Pass):
    """Evaluate ops whose inputs are all constants and splice the result
    in as a literal (reference: framework/ir/constant_folding_pass.cc).
    Captured plain tensors are constants; trainable Parameters fold only
    when ``fold_params`` (inference mode) — training reads them live."""

    def __init__(self, fold_params=False):
        self.fold_params = fold_params

    def apply(self, program, fetch_vids=()):
        folded_vals = {}
        count = 0
        new_ops = []
        for op in program.ops:
            def resolve(leaf):
                if isinstance(leaf, _VarRef):
                    return folded_vals.get(leaf.vid, leaf)
                if isinstance(leaf, _ParamRef):
                    if self.fold_params or not isinstance(
                            leaf.tensor, torch.nn.Parameter):
                        return leaf.tensor
                    return leaf
                return leaf

            res = [resolve(leaf) for leaf in op.leaves]
            if (op.name in RANDOM_OPS
                    or any(isinstance(leaf, (_VarRef, _ParamRef))
                           for leaf in res)):
                # random ops never fold but STILL need their folded inputs
                # spliced in (their producers may be removed); partially
                # constant ops likewise keep resolved leaves
                op.leaves = [_ParamRef(leaf)
                             if isinstance(leaf, torch.Tensor) else leaf
                             for leaf in res]
                new_ops.append(op)
                continue
            args, kwargs = pytree.tree_unflatten(res, op.treedef)
            with torch.no_grad():
                out = op.fn(*args, **kwargs)
            outs = [o for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            for vid, o in zip(op.out_vids, outs):
                folded_vals[vid] = o
            count += 1
        # fetched vids that folded away need a passthrough const op
        for vid in fetch_vids:
            if vid in folded_vals:
                leaves, treedef = pytree.tree_flatten(
                    ((folded_vals[vid],), {}))
                new_ops.append(OpDesc("const", lambda v: v, treedef,
                                      [_ParamRef(leaves[0])], [vid]))
        program.ops = new_ops
        program.version += 1
        return count


@register_pass("common_subexpression_elimination")
class CSEPass(Pass):
    """Merge ops with identical (name, callable, resolved inputs) —
    framework/ir CSE analog.  VarRefs compare by vid, live tensors by
    identity, array literals by raw bytes, other literals by repr."""

    def apply(self, program, fetch_vids=()):
        seen = {}          # key -> out_vids of the first occurrence
        alias = {}         # dropped vid -> kept vid
        kept = []
        count = 0

        def leaf_key(leaf):
            if isinstance(leaf, _VarRef):
                return ("v", alias.get(leaf.vid, leaf.vid))
            if isinstance(leaf, _ParamRef):
                return ("p", id(leaf.tensor))
            if isinstance(leaf, np.ndarray):
                return ("a", str(leaf.dtype), leaf.shape, leaf.tobytes())
            return ("l", repr(leaf))

        for op in program.ops:
            # fresh leaf list: OpDesc leaves are SHARED with the source
            # program across clone() — rewriting them in place would leak
            # into it (and past its version counter)
            op.leaves = [
                _VarRef(alias[leaf.vid])
                if isinstance(leaf, _VarRef) and leaf.vid in alias else leaf
                for leaf in op.leaves]
            key = (op.name, id(op.fn), repr(op.treedef),
                   tuple(leaf_key(leaf) for leaf in op.leaves))
            prev = seen.get(key)
            if (prev is not None and len(prev) == len(op.out_vids)
                    and op.name not in RANDOM_OPS
                    and not any(v in fetch_vids for v in op.out_vids)):
                # fetch targets keep their producer: replay fetches the
                # vid directly, aliases are invisible to it
                for dropped, kept_vid in zip(op.out_vids, prev):
                    alias[dropped] = kept_vid
                count += 1
                continue
            seen[key] = op.out_vids
            kept.append(op)
        program.ops = kept
        program.version += 1
        return count
