"""Auto-parallel runtime API: ``shard_tensor`` / ``reshard`` /
``parallelize`` (the port of ``paddle_tpu/distributed/auto_parallel/
api.py``).

Reference parity: auto_parallel/interface.py (``shard_tensor``),
reshard.py (``Resharder``: slice/concat/send/recv between process
meshes) and engine.py (``Engine.prepare``: complete → partition →
reshard).  The JAX package completes the specs and hands them to GSPMD
(jit ``in_shardings``), which partitions every op and inserts the
collectives.  The port has no GSPMD, so :func:`parallelize` partitions
itself: it traces the function once to aten operations (``make_fx``,
fake mode), completes the layout of every value of the graph
(``propagation.py``), and runs the graph on every rank of the world
over the rank's blocks — each operation on its local blocks where the
layouts allow, with the port's ``distributed/collective.py`` calls
between them (so the flight recorder, the byte counters and the gloo
staging of CUDA tensors see every one of them):

- an operand whose layout differs from what its operation needs is
  **redistributed**: all-gathered along a dim sharded over an axis the
  operation cannot keep, sliced along a dim the operation wants
  sharded (a slice is local, no traffic);
- a contraction over a sharded dim (``mm``/``bmm`` with both operands
  split along K; a sum, mean or scatter-add over a sharded dim) leaves
  a **partial** result, all-reduced over that axis at once (sum, or
  the mean of the shards' means, which is the mean: the shards are
  equal);
- an operation with no rule here runs on whole operands (all-gathered)
  and its result is sliced to its layout: slower, never wrong.

Each rank therefore holds only its blocks of the split parameters and
activations.  ``shard_tensor`` and ``reshard`` put a leaf, or a tree
under one spec or a spec tree, into each rank's window (a
:class:`DistTensor`, the port's ``mesh.Shard`` with its mesh and spec),
from whole tensors or from another layout or mesh.
"""
from __future__ import annotations

import math
import operator

import torch
from torch.utils import _pytree as pytree

from .. import collective
from ..mesh import P, PartitionSpec, Shard, _names, axis_sizes, window_of
from .propagation import (ShardingPropagator, op_name, reshape_groups,
                          shape_of, trace, value_key)

__all__ = ["DistTensor", "shard_tensor", "reshard", "parallelize"]


# ------------------------------------------------------------- layouts


class DistTensor(Shard):
    """A rank's window of a global tensor laid out on ``mesh`` by
    ``spec``: ``data`` the local block, ``shape`` the global shape,
    ``index`` the window; ``full()`` all-gathers the whole tensor."""

    def __init__(self, data, shape, mesh, spec):
        spec = _full_spec(spec, len(shape))
        idx = window_of(spec, shape, axis_sizes(mesh), mesh.coords)
        super().__init__(data, shape, idx, owner=True)
        self.mesh, self.spec = mesh, spec

    def full(self):
        return _gather(self.data, self.spec, self.mesh)

    def numpy(self):
        t = self.full().detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __repr__(self):
        return f"DistTensor({_trim(self.spec)} of {self.shape})"


def _full_spec(spec, ndim):
    spec = tuple(spec) if spec is not None else ()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} longer than rank {ndim}")
    return spec + (None,) * (ndim - len(spec))


def _trim(spec):
    e = list(spec)
    while e and e[-1] is None:
        e.pop()
    return P(*e)


def _size(mesh, entry):
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _names(entry))


def _gather_dim(x, d, entry, mesh):
    sizes = axis_sizes(mesh)
    for a in reversed(_names(entry)):
        if sizes[a] > 1:
            x = collective.all_gather(x.contiguous(), group=mesh.group(a),
                                      axis=d)
    return x


def _slice_dim(x, d, entry, mesh):
    sizes, coords = axis_sizes(mesh), mesh.coords
    n, idx = 1, 0
    for a in _names(entry):
        n, idx = n * sizes[a], idx * sizes[a] + coords[a]
    if n == 1:
        return x
    size = x.shape[d] // n
    return x.narrow(d, idx * size, size)


def _gather(x, spec, mesh):
    for d, e in enumerate(spec):
        if e is not None:
            x = _gather_dim(x, d, e, mesh)
    return x


def redistribute(x, have, want, mesh):
    """``x``, this rank's block under layout ``have``, as its block under
    ``want``: all-gathers where ``have`` splits a dim ``want`` does not
    split the same way, then local slices."""
    have, want = tuple(have), tuple(want)
    if have == want:
        return x
    for d, (h, w) in enumerate(zip(have, want)):
        if h is not None and h != w:
            x = _gather_dim(x, d, h, mesh)
    for d, (h, w) in enumerate(zip(have, want)):
        if w is not None and h != w:
            x = _slice_dim(x, d, w, mesh)
    return x


def _dist_leaf(x, spec, mesh):
    if isinstance(x, Shard):
        src = getattr(x, "mesh", None)
        src_spec = getattr(x, "spec", None)
        if src is None:
            raise TypeError("reshard takes whole tensors or DistTensors")
        if src is mesh:
            local = redistribute(x.data, src_spec, spec, mesh)
        else:       # another mesh: through the whole tensor
            local = _local_block(_gather(x.data, src_spec, src), spec, mesh)
        return DistTensor(local.contiguous(), x.shape, mesh, spec)
    return DistTensor(_local_block(x, spec, mesh).contiguous(),
                      tuple(x.shape), mesh, spec)


def _local_block(x, spec, mesh):
    for d, e in enumerate(spec):
        if e is not None:
            x = _slice_dim(x, d, e, mesh)
    return x


def shard_tensor(x, mesh, spec):
    """``x`` (a whole tensor on every rank, or a :class:`DistTensor`) as
    this rank's window under ``spec`` (a PartitionSpec or a list of axis
    names per dim)."""
    return _dist_leaf(x, _full_spec(spec, len(x.shape)), mesh)


def _is_leaf(x):
    return isinstance(x, (torch.Tensor, Shard))


def reshard(tree, specs, mesh):
    """Move a pytree into each rank's windows of ``mesh`` laid out by
    ``specs`` (a matching pytree of PartitionSpecs, or one spec applied
    to every leaf).  Leaves may be whole tensors or :class:`DistTensor`s
    of another layout or mesh (cross-mesh moves go through the whole
    tensor)."""
    flat, treedef = pytree.tree_flatten(tree, is_leaf=_is_leaf)
    if isinstance(specs, PartitionSpec) or specs is None:
        flat_specs = [specs] * len(flat)
    else:
        flat_specs = pytree.tree_flatten(
            specs, is_leaf=lambda s: isinstance(s, PartitionSpec)
            or s is None)[0]
        if len(flat_specs) != len(flat):
            raise ValueError(f"{len(flat_specs)} specs for {len(flat)} "
                             f"leaves")
    out = [_dist_leaf(x, _full_spec(s, len(x.shape)), mesh)
           for x, s in zip(flat, flat_specs)]
    return pytree.tree_unflatten(out, treedef)


# ----------------------------------------------------------- the runner


class _NotLocal(Exception):
    """The operation cannot run on these blocks; run it whole."""


def _local_size(size, entry, mesh):
    return size if entry is None or size < 0 else size // _size(mesh,
                                                                 entry)


class _Runner:
    """Runs a completed graph on this rank's blocks (see the module
    docstring).  ``layout[key]`` is the layout a value is held in; the
    target of each value is the completion's spec for it."""

    def __init__(self, completion, mesh, device):
        self.c, self.mesh, self.device = completion, mesh, device
        self.gm = completion.gm
        self.stats = {"nodes": 0, "whole": 0, "gathers": 0, "partials": 0}
        self.whole_ops = {}
        self._last_use = {}
        for node in self.gm.graph.nodes:
            for a in node.all_input_nodes:
                self._last_use[a] = node

    def target(self, key):
        node = key[0] if isinstance(key, tuple) else key
        v = node.meta["val"]
        if isinstance(key, tuple):
            v = v[key[1]]
        return self.c.spec_of(key, tuple(v.shape))

    def run(self, flat_inputs):
        env, lay = {}, {}
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                x = flat_inputs.pop(0)
                env[node], lay[node] = x, self.target(node)
            elif node.op == "call_function":
                self.stats["nodes"] += 1
                self._call(node, env, lay)
            elif node.op == "output":
                out = []
                for a in pytree.tree_leaves(node.args[0]):
                    if isinstance(a, torch.fx.Node):
                        out.append((*self._arg(a, env, lay), shape_of(a)))
                    else:
                        out.append((a, None, None))
            for a in node.all_input_nodes:
                if self._last_use.get(a) is node and a.op != "placeholder":
                    env.pop(a, None)
        return out

    # ------------------------------------------------------------- nodes
    def _call(self, node, env, lay):
        if node.target is operator.getitem:
            src, i = node.args
            env[node] = env[src][i]
            lay[node] = lay[src][i]
            return
        name = op_name(node)
        rule = getattr(self, "_x_" + name, None)
        if rule is None and torch.Tag.pointwise in getattr(
                node.target, "tags", ()):
            rule = self._x_pointwise
        res = None
        if rule is not None:
            try:
                res = rule(node, env, lay)
            except _NotLocal:
                res = None
        if res is None:
            self.stats["whole"] += 1
            self.whole_ops[name] = self.whole_ops.get(name, 0) + 1
            res = self._whole(node, env, lay)
        val, have = res
        multi = isinstance(node.meta.get("val"), (tuple, list))
        if multi:
            vals, lays = [], []
            for i, (v, h) in enumerate(zip(val, have)):
                if isinstance(v, torch.Tensor):
                    want = self.target((node, i))
                    v = redistribute(v, h, want, self.mesh)
                    h = want
                vals.append(v)
                lays.append(h)
            env[node], lay[node] = tuple(vals), tuple(lays)
        else:
            want = self.target(node)
            env[node] = redistribute(val, have, want, self.mesh)
            lay[node] = want

    def _arg(self, a, env, lay, want=None):
        """A tensor argument's block, in ``want`` (default: as held)."""
        x, have = env[a], lay[a]
        if want is None:
            return x, have
        want = tuple(want)
        if want != have:
            self.stats["gathers"] += 1
        return redistribute(x, have, want, self.mesh), want

    def _map_args(self, args, fn):
        def m(a):
            if isinstance(a, torch.fx.Node):
                return fn(a)
            if isinstance(a, (list, tuple)):
                return type(a)(m(x) for x in a)
            return a
        return [m(a) for a in args]

    def _kwargs(self, node):
        kw = dict(node.kwargs)
        if "device" in kw:
            kw["device"] = self.device
        return kw

    def _whole(self, node, env, lay):
        """Run the operation on whole operands; its result is whole."""
        def full(a):
            s = shape_of(a)
            if s is None:
                return env[a]
            return self._arg(a, env, lay, (None,) * len(s))[0]

        args = self._map_args(node.args, full)
        out = node.target(*args, **self._kwargs(node))
        if isinstance(out, (tuple, list)):
            return out, [(None,) * o.dim() if isinstance(o, torch.Tensor)
                         else None for o in out]
        return out, (None,) * out.dim()

    def _partial(self, x, axes, op=collective.ReduceOp.SUM):
        for e in axes:
            if e is None:
                continue
            for a in _names(e):
                if axis_sizes(self.mesh)[a] > 1:
                    self.stats["partials"] += 1
                    x = collective.all_reduce(x.contiguous(), op=op,
                                              group=self.mesh.group(a))
        return x

    def _sizes(self, sizes, layout):
        return [_local_size(s, e, self.mesh) for s, e in zip(sizes, layout)]

    # --------------------------------------------------------- the rules
    def _x_pointwise(self, node, env, lay):
        want = self.target(node)
        n = len(want)

        def coerce(a):
            s = shape_of(a)
            if s is None:
                return self._arg(a, env, lay)[0]
            off = n - len(s)
            if off < 0:
                raise _NotLocal
            w = tuple(want[d + off] if s[d] == shape_of(node)[d + off]
                      else None for d in range(len(s)))
            return self._arg(a, env, lay, w)[0]

        args = self._map_args(node.args, coerce)
        return node.target(*args, **self._kwargs(node)), want

    def _x_mm(self, node, env, lay):
        a, b = node.args[:2]
        om, on = self.target(node)
        (_, ha), (_, hb) = self._arg(a, env, lay), self._arg(b, env, lay)
        k = ha[1] if ha[1] == hb[0] and ha[1] not in (om, on) else None
        if om is not None and om == on:
            raise _NotLocal
        x, _ = self._arg(a, env, lay, (om, k))
        y, _ = self._arg(b, env, lay, (k, on))
        return self._partial(torch.mm(x, y), [k]), (om, on)

    def _x_bmm(self, node, env, lay):
        a, b = node.args[:2]
        ob, om, on = self.target(node)
        (_, ha), (_, hb) = self._arg(a, env, lay), self._arg(b, env, lay)
        k = ha[2] if ha[2] == hb[1] and ha[2] not in (ob, om, on) else None
        x, _ = self._arg(a, env, lay, (ob, om, k))
        y, _ = self._arg(b, env, lay, (ob, k, on))
        return self._partial(torch.bmm(x, y), [k]), (ob, om, on)

    def _x_t(self, node, env, lay):
        want = self.target(node)
        x, _ = self._arg(node.args[0], env, lay, tuple(reversed(want)))
        return x.t(), want

    def _x_transpose(self, node, env, lay):
        x, d0, d1 = node.args[:3]
        want = list(self.target(node))
        n = len(want)
        d0, d1 = d0 % n, d1 % n
        src = list(want)
        src[d0], src[d1] = want[d1], want[d0]
        v, _ = self._arg(x, env, lay, tuple(src))
        return v.transpose(d0, d1), tuple(want)

    def _x_permute(self, node, env, lay):
        x, perm = node.args[:2]
        want = self.target(node)
        n = len(perm)
        src = [None] * n
        for o, i in enumerate(perm):
            src[i % n] = want[o]
        v, _ = self._arg(x, env, lay, tuple(src))
        return v.permute(*perm), want

    def _x_view(self, node, env, lay):
        x = node.args[0]
        ishape, oshape = shape_of(x), shape_of(node)
        want = self.target(node)
        src = [None] * len(ishape)
        for si, sj, pairs in reshape_groups(ishape, oshape):
            major = dict(pairs)
            # only the group's major factor may carry an axis, on both
            # sides, and it must divide both
            for j in sj:
                if want[j] is not None and j not in major.values():
                    raise _NotLocal
            for a, b in pairs:
                e = want[b]
                if e is not None and ishape[a] % _size(self.mesh, e):
                    raise _NotLocal
                src[a] = e
            if len(pairs) == 1:
                a, b = pairs[0]
                if want[b] is not None and any(
                        ishape[d] > 1 for d in si if d < a):
                    raise _NotLocal
        v, _ = self._arg(x, env, lay, tuple(src))
        return v.reshape(self._sizes(oshape, want)), want

    _x__unsafe_view = _x_reshape = _x_view

    def _x_expand(self, node, env, lay):
        x = node.args[0]
        ishape, oshape = shape_of(x), shape_of(node)
        want = self.target(node)
        off = len(oshape) - len(ishape)
        src = tuple(want[d + off] if ishape[d] == oshape[d + off] else None
                    for d in range(len(ishape)))
        v, _ = self._arg(x, env, lay, src)
        return v.expand(self._sizes(oshape, want)), want

    def _x_unsqueeze(self, node, env, lay):
        x, dim = node.args[:2]
        want = self.target(node)
        dim %= len(want)
        v, _ = self._arg(x, env, lay, want[:dim] + want[dim + 1:])
        return v.unsqueeze(dim), want[:dim] + (None,) + want[dim + 1:]

    def _x_squeeze(self, node, env, lay):
        x = node.args[0]
        ishape = shape_of(x)
        n = len(ishape)
        dims = list(range(n)) if len(node.args) < 2 else [
            d % n for d in (node.args[1] if isinstance(
                node.args[1], (list, tuple)) else [node.args[1]])]
        gone = [d for d in dims if ishape[d] == 1]
        want = iter(self.target(node))
        src = tuple(None if d in gone else next(want) for d in range(n))
        v, _ = self._arg(x, env, lay, src)
        return v.squeeze(gone) if gone else v, self.target(node)

    def _drop(self, want, dim):
        return want[:dim] + (None,) + want[dim:]

    def _x_select(self, node, env, lay):
        x, dim, idx = node.args[:3]
        n = len(shape_of(x))
        dim %= n
        want = self.target(node)
        v, _ = self._arg(x, env, lay, self._drop(want, dim))
        return v.select(dim, idx), want

    def _x_select_backward(self, node, env, lay):
        grad, sizes, dim, idx = node.args[:4]
        want = self.target(node)
        dim %= len(sizes)
        if want[dim] is not None:
            raise _NotLocal
        g, _ = self._arg(grad, env, lay, want[:dim] + want[dim + 1:])
        return torch.ops.aten.select_backward(
            g, self._sizes(sizes, want), dim, idx), want

    def _x_unbind(self, node, env, lay):
        x = node.args[0]
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(shape_of(x))
        want = self.target((node, 0))
        v, _ = self._arg(x, env, lay, self._drop(want, dim))
        outs = v.unbind(dim)
        return outs, [want] * len(outs)

    def _x_stack(self, node, env, lay):
        tensors = node.args[0]
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(
            shape_of(node))
        want = self.target(node)
        inner = want[:dim] + want[dim + 1:]
        vs = [self._arg(t, env, lay, inner)[0] for t in tensors]
        return torch.stack(vs, dim), want[:dim] + (None,) + want[dim + 1:]

    def _x_slice(self, node, env, lay):
        x = node.args[0]
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(shape_of(x))
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        v, _ = self._arg(x, env, lay, want)
        return node.target(v, *node.args[1:]), want

    def _x_slice_backward(self, node, env, lay):
        grad, sizes, dim = node.args[:3]
        dim %= len(sizes)
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        g, _ = self._arg(grad, env, lay, want)
        return torch.ops.aten.slice_backward(
            g, self._sizes(sizes, want), dim, *node.args[3:]), want

    def _x_cat(self, node, env, lay):
        tensors = node.args[0]
        n = len(shape_of(node))
        dim = (node.args[1] if len(node.args) > 1 else 0) % n
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        vs = [self._arg(t, env, lay, want)[0] for t in tensors]
        return torch.cat(vs, dim), want

    def _x_roll(self, node, env, lay):
        x = node.args[0]
        n = len(shape_of(x))
        dims = node.args[2] if len(node.args) > 2 else list(range(n))
        dims = [d % n for d in (dims if isinstance(dims, (list, tuple))
                                else [dims])]
        want = tuple(None if d in dims else e
                     for d, e in enumerate(self.target(node)))
        v, _ = self._arg(x, env, lay, want)
        return node.target(v, *node.args[1:]), want

    def _reduce(self, node, env, lay, op):
        x = node.args[0]
        ishape = shape_of(x)
        n = len(ishape)
        dims = node.args[1] if len(node.args) > 1 else None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(n))
        dims = {d % n for d in (dims if isinstance(dims, (list, tuple))
                                else [dims])}
        keep = node.args[2] if len(node.args) > 2 else \
            node.kwargs.get("keepdim", False)
        want = self.target(node)
        _, have = self._arg(x, env, lay)
        src, kept, o = [], set(), 0
        for i in range(n):
            if i in dims:
                src.append(None)
                if keep:
                    o += 1
                continue
            src.append(want[o])
            kept.update(_names(want[o]))
            o += 1
        # a reduced dim keeps its axis where the output does not use it:
        # each rank reduces its block, then the blocks are combined
        partial = []
        for i in dims:
            if have[i] is not None and not (set(_names(have[i])) & kept):
                src[i] = have[i]
                kept.update(_names(have[i]))
                partial.append(have[i])
        v, _ = self._arg(x, env, lay, tuple(src))
        out = node.target(v, *node.args[1:], **self._kwargs(node))
        return self._partial(out, partial, op), want

    def _x_sum(self, node, env, lay):
        return self._reduce(node, env, lay, collective.ReduceOp.SUM)

    def _x_mean(self, node, env, lay):
        return self._reduce(node, env, lay, collective.ReduceOp.AVG)

    def _x_amax(self, node, env, lay):
        return self._reduce(node, env, lay, collective.ReduceOp.MAX)

    def _x_amin(self, node, env, lay):
        return self._reduce(node, env, lay, collective.ReduceOp.MIN)

    def _softmax(self, node, env, lay, nargs):
        dim = node.args[nargs] % len(shape_of(node))
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        args = [self._arg(a, env, lay, want)[0]
                for a in node.args[:nargs]]
        return node.target(*args, *node.args[nargs:]), want

    def _x__log_softmax(self, node, env, lay):
        return self._softmax(node, env, lay, 1)

    _x__softmax = _x__log_softmax

    def _x__log_softmax_backward_data(self, node, env, lay):
        return self._softmax(node, env, lay, 2)

    _x__softmax_backward_data = _x__log_softmax_backward_data

    def _x_gather(self, node, env, lay):
        x, dim, index = node.args[:3]
        n = len(shape_of(x))
        dim %= n
        xs, os_ = shape_of(x), shape_of(node)
        if any(xs[d] != os_[d] for d in range(n) if d != dim):
            raise _NotLocal
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        v, _ = self._arg(x, env, lay, want)
        i, _ = self._arg(index, env, lay, want)
        return torch.gather(v, dim, i), want

    def _x_scatter_add(self, node, env, lay):
        x, dim, index, src = node.args[:4]
        n = len(shape_of(x))
        dim %= n
        if any(shape_of(src)[d] != shape_of(x)[d] for d in range(n)
               if d != dim):
            raise _NotLocal
        want = list(self.target(node))
        want[dim] = None
        want = tuple(want)
        v, _ = self._arg(x, env, lay, want)
        i, _ = self._arg(index, env, lay, want)
        s, _ = self._arg(src, env, lay, want)
        return torch.scatter_add(v, dim, i, s), want

    def _x_index(self, node, env, lay):
        x, indices = node.args[:2]
        idx = [i for i in indices if i is not None]
        if len(idx) != 1 or indices[0] is None:
            raise _NotLocal
        want = self.target(node)
        k = len(shape_of(idx[0]))
        v, _ = self._arg(x, env, lay, (None,) + tuple(want[k:]))
        i, _ = self._arg(idx[0], env, lay, tuple(want[:k]))
        return v[i], want

    def _x_index_put(self, node, env, lay):
        x, indices, values = node.args[:3]
        accumulate = node.args[3] if len(node.args) > 3 else \
            node.kwargs.get("accumulate", False)
        idx = [i for i in indices if i is not None]
        if len(idx) != 1 or indices[0] is None or not accumulate:
            raise _NotLocal
        want = self.target(node)
        if want[0] is not None:
            raise _NotLocal
        k = len(shape_of(idx[0]))
        _, hv = self._arg(values, env, lay)
        lead = tuple(hv[:k])
        used = {a for e in want for a in _names(e)}
        if any(set(_names(e)) & used for e in lead):
            lead = (None,) * k
        v, _ = self._arg(values, env, lay, lead + tuple(want[1:]))
        i, _ = self._arg(idx[0], env, lay, lead)
        base, _ = self._arg(x, env, lay, want)
        # each rank scatters its rows into zeros; the blocks are summed
        # over the axes the rows were split along, then added to the base
        part = torch.zeros_like(base).index_put_((i,), v, accumulate=True)
        return base + self._partial(part, lead), want

    def _x_embedding(self, node, env, lay):
        w, idx = node.args[:2]
        want = self.target(node)
        k = len(shape_of(idx))
        wv, _ = self._arg(w, env, lay, (None, want[k]))
        iv, _ = self._arg(idx, env, lay, tuple(want[:k]))
        return torch.ops.aten.embedding(wv, iv, *node.args[2:]), want

    def _factory(self, node, env, lay, sizes_pos):
        want = self.target(node)
        args = list(node.args)
        args[sizes_pos] = self._sizes(args[sizes_pos], want)
        args = self._map_args(args, lambda a: self._arg(a, env, lay)[0])
        return node.target(*args, **self._kwargs(node)), want

    def _x_new_zeros(self, node, env, lay):
        return self._factory(node, env, lay, 1)

    _x_new_ones = _x_new_empty = _x_new_zeros

    def _x_zeros(self, node, env, lay):
        return self._factory(node, env, lay, 0)

    _x_ones = _x_empty = _x_full = _x_zeros

    def _x_scalar_tensor(self, node, env, lay):
        return node.target(*node.args, **self._kwargs(node)), ()

    def _like(self, node, env, lay):
        want = self.target(node)
        x, _ = self._arg(node.args[0], env, lay, want)
        return node.target(x, *node.args[1:], **self._kwargs(node)), want

    _x_ones_like = _x_zeros_like = _x_empty_like = _x_full_like = _like
    # layout-keeping single-operand operations
    _x_detach = _x_clone = _x_alias = _x__to_copy = _x_contiguous = _like
    _x_lift_fresh_copy = _like

    def _x_flash_fwd(self, node, env, lay):
        """The flash operators (forward and backward): attention runs over
        whole sequences and head dims, split only over batch and heads;
        lse (3-d) follows q's first three dims."""
        want = self.target((node, 0))
        if want[2] is not None or want[3] is not None:
            raise _NotLocal
        args = []
        for a in node.args:
            if isinstance(a, torch.fx.Node):
                w = want[:3] if len(shape_of(a)) == 3 else want
                # the kernels take dense, aligned operands: a block cut
                # by a redistribution is a strided view
                args.append(self._arg(a, env, lay, w)[0].contiguous())
            else:
                args.append(a)
        outs = node.target(*args)
        return outs, [want[:o.dim()] for o in outs]

    _x_flash_bwd = _x_flash_fwd


# --------------------------------------------------------- parallelize


class ParallelStep:
    """The SPMD step :func:`parallelize` returns: call it with the
    arguments' pytrees (whole tensors, or :class:`DistTensor`s of any
    layout); it returns the function's outputs as :class:`DistTensor`s
    of their completed layouts.  ``specs`` are the completed input specs
    (``out_specs`` the outputs'), ``stats`` the last call's counts of
    operations, whole-operand fallbacks, redistributions and partial
    sums."""

    def __init__(self, completion, mesh, treedef, out_tree, device):
        self.completion = completion
        self.mesh, self._treedef, self._out_tree = mesh, treedef, out_tree
        self.device = device
        flat = [_trim(s) for s in completion.input_specs]
        self.specs = pytree.tree_unflatten(flat, treedef)
        self.out_specs = [None if s is None else _trim(s)
                          for s in completion.output_specs]
        self.stats, self.whole_ops = {}, {}

    def __call__(self, *args):
        flat, treedef = pytree.tree_flatten(tuple(args), is_leaf=_is_leaf)
        if treedef != self._treedef:
            raise ValueError("arguments differ in structure from the "
                             "example the step was traced on")
        local = []
        for x, spec in zip(flat, self.completion.input_specs):
            d = _dist_leaf(x, spec, self.mesh)
            local.append(d.data)
        runner = _Runner(self.completion, self.mesh, self.device)
        outs = runner.run(local)
        self.stats, self.whole_ops = runner.stats, runner.whole_ops
        res = []
        for (val, have, shape) in outs:
            if isinstance(val, torch.Tensor):
                res.append(DistTensor(val, shape, self.mesh, have))
            else:
                res.append(val)
        return pytree.tree_unflatten(res, self._out_tree)


def parallelize(fn, mesh, example_args, annotations, *,
                return_specs=False):
    """Complete the sharding of ``fn`` from sparse ``annotations`` and
    return its SPMD step over ``mesh`` (plus the completed input specs
    tree if ``return_specs``).  ``example_args`` (tensors, or anything
    with their shapes and dtypes on the device the step will run on)
    are traced in fake mode: nothing is computed.  Every rank of the
    mesh calls the step with the same arguments, in the same order."""
    gm, leaves = trace(fn, example_args)
    completion = ShardingPropagator(mesh).complete_graph(gm, leaves,
                                                         annotations)
    _, treedef = pytree.tree_flatten(tuple(example_args))
    out_tree = _out_tree(gm)
    device = leaves[0][1].device if leaves else torch.device("cpu")
    step = ParallelStep(completion, mesh, treedef, out_tree, device)
    if return_specs:
        return step, step.specs
    return step


def _out_tree(gm):
    """The pytree structure of the traced function's outputs (the graph
    returns them flat; ``make_fx`` keeps the structure)."""
    return gm.graph._codegen.pytree_info.out_spec
