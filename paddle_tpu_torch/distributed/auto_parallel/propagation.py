"""Sharding propagation — the semi-auto SPMD "Completer" (the port of
``paddle_tpu/distributed/auto_parallel/propagation.py``).

Reference parity: python/paddle/distributed/auto_parallel/completion.py
(``Completer.complete_forward_annotation``: per-op SPMD rules run to a
fixpoint over a program).  As in the JAX package, one union-find over
``(tensor, dim)`` factor groups replaces the fixpoint: every operation
contributes "these dims must share a mesh axis" links, sparse user
annotations seed axis names into the classes they touch, and one pass
reads a complete ``PartitionSpec`` off every input.

The JAX module walks the jaxpr of the user's function; this one walks a
``torch.fx`` graph of aten operations, traced by
``torch.fx.experimental.proxy_tensor.make_fx`` in fake mode (shapes
without data, as jaxpr avals).  Each JAX rule has its aten counterpart:
``dot_general`` → ``mm``/``addmm``/``bmm``, ``transpose`` →
``t``/``transpose``/``permute``, ``broadcast_in_dim`` → ``expand`` and
the implicit broadcasting of pointwise ops, the reductions →
``sum``/``mean``/``amax``…, ``reshape`` → ``view``/``reshape``,
``slice`` → ``slice``/``select``/``unbind``, ``concatenate`` →
``cat``/``stack``, ``pad`` → ``constant_pad_nd``, ``gather`` →
``index``/``embedding``/``index_select``/``gather`` and their backward
scatters.  The rank-aligned elementwise rule (``_r_default``) covers the
port's flash operators (``paddle_tpu_torch::flash_fwd`` /
``flash_bwd``: q, k, v, o and their gradients are all ``[B, H, S, D]``),
as it covers ``pallas_call`` in JAX.  A torch trace unrolls Python loops
(the GPT's layer loop becomes one ``unbind`` of each stacked leaf and
the per-layer operations), so the JAX ``scan``/``while``/``cond`` rules
have nothing to walk here.

Conservative by construction: an operation with no rule contributes no
links, which can only under-shard (replicate) — never mis-shard.  The
executor in ``api.py`` is the correctness backstop for any layout this
emits.  The factor-group union-find (``_UnionFind``,
``_grouped_factors``) is the JAX module's, copied.
"""
from __future__ import annotations

import fnmatch
import math
import operator

import torch

from ..mesh import P, _names, axis_sizes

__all__ = ["ShardingPropagator", "complete", "trace"]


# --------------------------------------------------------------- union-find


class _UnionFind:
    def __init__(self):
        self._parent = {}

    def find(self, k):
        p = self._parent
        path = []
        while k in p:
            path.append(k)
            k = p[k]
        for q in path:              # path compression
            p[q] = k
        return k

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[ra] = rb


def _grouped_factors(src_shape, dst_shape):
    """Greedy left-to-right grouping of a reshape: yields (src_dims,
    dst_dims) lists whose element products match.  The standard two-pointer
    walk used by every reshape-sharding rule."""
    i = j = 0
    while i < len(src_shape) or j < len(dst_shape):
        si, sj = [], []
        pi = pj = 1
        if i < len(src_shape):
            pi *= src_shape[i]; si.append(i); i += 1
        if j < len(dst_shape):
            pj *= dst_shape[j]; sj.append(j); j += 1
        while pi != pj:
            if pi < pj:
                if i >= len(src_shape):
                    return
                pi *= src_shape[i]; si.append(i); i += 1
            else:
                if j >= len(dst_shape):
                    return
                pj *= dst_shape[j]; sj.append(j); j += 1
        # absorb trailing size-1 dims into the current group
        while i < len(src_shape) and src_shape[i] == 1:
            si.append(i); i += 1
        while j < len(dst_shape) and dst_shape[j] == 1:
            sj.append(j); j += 1
        yield si, sj


def reshape_groups(ishape, oshape):
    """[(major input dim, major output dim, 1:1 pairs)] of a reshape: the
    leading non-1 factor of each group on either side (the only factor a
    layout-preserving split may shard), and, where a group maps dims of
    equal sizes one to one, every pair."""
    out = []
    for si, sj in _grouped_factors(ishape, oshape):
        ci = [d for d in si if ishape[d] > 1] or si[:1]
        cj = [d for d in sj if oshape[d] > 1] or sj[:1]
        if not (ci and cj):
            continue
        pairs = [(ci[0], cj[0])]
        if len(ci) == len(cj) and all(ishape[a] == oshape[b]
                                      for a, b in zip(ci, cj)):
            pairs += list(zip(ci[1:], cj[1:]))
        out.append((si, sj, pairs))
    return out


# ---------------------------------------------------------- fx values


def _vals(node):
    """The tensors a node produces: [(key, shape)] (key = node for one
    output, (node, i) for the i-th of several)."""
    v = node.meta.get("val")
    if isinstance(v, torch.Tensor):
        return [(node, tuple(v.shape))]
    if isinstance(v, (tuple, list)):
        return [((node, i), tuple(t.shape)) for i, t in enumerate(v)
                if isinstance(t, torch.Tensor)]
    return []


def value_key(node):
    """The union-find key of a tensor argument (a node, or the getitem
    of a multi-output node)."""
    if node.op == "call_function" and node.target is operator.getitem:
        return (node.args[0], node.args[1])
    return node


def shape_of(node):
    v = node.meta.get("val")
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def op_name(node):
    """``mm``, ``view``, ``flash_fwd`` ...: the aten (or custom) op's
    packet name, '' for anything else."""
    t = node.target
    packet = getattr(t, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__.split(".")[-1]
    return ""


def _is_pointwise(node):
    return torch.Tag.pointwise in getattr(node.target, "tags", ())


def _dims(d, n):
    ds = d if isinstance(d, (list, tuple)) else [d]
    return [x % n for x in ds] if n else []


# -------------------------------------------------------------- the rules


_FACTORY = {"new_zeros", "new_ones", "new_empty", "new_full", "zeros_like",
            "ones_like", "empty_like", "full_like", "zeros", "ones",
            "empty", "full", "scalar_tensor", "arange", "rand_like",
            "randn_like"}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin",
           "any", "all", "var", "std", "logsumexp", "max", "min"}


class _LinkBuilder:
    """Walks an fx graph emitting union-find links: a link between
    (value a, dim i) and (value b, dim j) asserts that if one is sharded
    over a mesh axis, the other lives on that same axis shard-for-shard."""

    def __init__(self, uf: _UnionFind):
        self.uf = uf

    def link(self, a, da, b, db):
        self.uf.union((a, da), (b, db))

    def walk(self, graph):
        for node in graph.nodes:
            if node.op != "call_function":
                continue
            if node.target is operator.getitem:
                self._r_getitem(node)
                continue
            name = op_name(node)
            rule = getattr(self, "_r_" + name, None)
            try:
                if rule is not None:
                    rule(node)
                elif name in _REDUCE:
                    self._reduce(node)
                elif name in _FACTORY:
                    continue
                elif _is_pointwise(node):
                    self._r_pointwise(node)
                else:
                    self._r_default(node)
            except (IndexError, KeyError, TypeError, ValueError,
                    AttributeError):
                # silent-ok: a malformed/unexpected node shape only
                # costs inference power (replication), never correctness
                continue

    def _tensor_args(self, node):
        out = []
        for a in node.args:
            if isinstance(a, torch.fx.Node) and shape_of(a) is not None:
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out += [x for x in a if isinstance(x, torch.fx.Node)
                        and shape_of(x) is not None]
        return out

    def _r_getitem(self, node):
        src, i = node.args
        shape = shape_of(node)
        if shape is None:
            return
        for d in range(len(shape)):
            self.link(node, d, (src, i), d)

    def _r_default(self, node):
        """Rank-aligned elementwise rule: same-rank operands link their
        equal-size dims with every output (the JAX ``_r_default``)."""
        for key, oshape in _vals(node):
            if not oshape:
                continue
            for a in self._tensor_args(node):
                ishape = shape_of(a)
                if len(ishape) != len(oshape):
                    continue
                for d in range(len(oshape)):
                    if ishape[d] == oshape[d]:
                        self.link(value_key(a), d, key, d)

    def _r_pointwise(self, node):
        """Implicit broadcasting: dims aligned from the right, linked
        where the sizes agree (the size-1 side of a broadcast is not)."""
        for key, oshape in _vals(node):
            for a in self._tensor_args(node):
                ishape = shape_of(a)
                off = len(oshape) - len(ishape)
                if off < 0:
                    continue
                for d in range(len(ishape)):
                    if ishape[d] == oshape[d + off]:
                        self.link(value_key(a), d, key, d + off)

    def _r_mm(self, node):
        a, b = node.args[:2]
        A, B = value_key(a), value_key(b)
        self.link(A, 1, B, 0)
        self.link(A, 0, node, 0)
        self.link(B, 1, node, 1)

    def _r_addmm(self, node):
        bias, a, b = node.args[:3]
        A, B = value_key(a), value_key(b)
        self.link(A, 1, B, 0)
        self.link(A, 0, node, 0)
        self.link(B, 1, node, 1)
        bs, os_ = shape_of(bias), shape_of(node)
        off = len(os_) - len(bs)
        for d in range(len(bs)):
            if bs[d] == os_[d + off]:
                self.link(value_key(bias), d, node, d + off)

    def _r_bmm(self, node):
        a, b = node.args[:2]
        A, B = value_key(a), value_key(b)
        self.link(A, 0, B, 0)
        self.link(A, 0, node, 0)
        self.link(A, 2, B, 1)
        self.link(A, 1, node, 1)
        self.link(B, 2, node, 2)

    def _r_t(self, node):
        x = value_key(node.args[0])
        n = len(shape_of(node))
        if n == 2:
            self.link(x, 0, node, 1)
            self.link(x, 1, node, 0)
        elif n == 1:
            self.link(x, 0, node, 0)

    def _r_transpose(self, node):
        x, d0, d1 = node.args[:3]
        n = len(shape_of(node))
        d0, d1 = d0 % n, d1 % n
        perm = list(range(n))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        for o, i in enumerate(perm):
            self.link(value_key(x), i, node, o)

    def _r_permute(self, node):
        x, perm = node.args[:2]
        n = len(perm)
        for o, i in enumerate(perm):
            self.link(value_key(x), i % n, node, o)

    def _r_view(self, node):
        x = node.args[0]
        for _, _, pairs in reshape_groups(shape_of(x), shape_of(node)):
            for a, b in pairs:
                self.link(value_key(x), a, node, b)

    _r__unsafe_view = _r_reshape = _r_view

    def _r_expand(self, node):
        x = node.args[0]
        ishape, oshape = shape_of(x), shape_of(node)
        off = len(oshape) - len(ishape)
        for d in range(len(ishape)):
            if ishape[d] == oshape[d + off]:
                self.link(value_key(x), d, node, d + off)

    def _r_unsqueeze(self, node):
        x, dim = node.args[:2]
        n = len(shape_of(node))
        dim %= n
        o = 0
        for i in range(n - 1):
            if o == dim:
                o += 1
            self.link(value_key(x), i, node, o)
            o += 1

    def _r_squeeze(self, node):
        x = node.args[0]
        ishape = shape_of(x)
        dims = (list(range(len(ishape))) if len(node.args) < 2 else
                _dims(node.args[1], len(ishape)))
        gone = {d for d in dims if ishape[d] == 1}
        o = 0
        for i in range(len(ishape)):
            if i not in gone:
                self.link(value_key(x), i, node, o)
                o += 1

    def _drop_dim(self, src, dim, dst, n_src):
        o = 0
        for i in range(n_src):
            if i == dim:
                continue
            self.link(src, i, dst, o)
            o += 1

    def _r_select(self, node):
        x, dim = node.args[:2]
        n = len(shape_of(x))
        self._drop_dim(value_key(x), dim % n, node, n)

    def _r_select_backward(self, node):
        grad, sizes, dim = node.args[:3]
        n = len(sizes)
        self._drop_dim(node, dim % n, value_key(grad), n)

    def _r_unbind(self, node):
        x = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else 0
        n = len(shape_of(x))
        for key, _ in _vals(node):
            self._drop_dim(value_key(x), dim % n, key, n)

    def _r_stack(self, node):
        tensors = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else 0
        n = len(shape_of(node))
        for t in tensors:
            self._drop_dim(node, dim % n, value_key(t), n)

    def _same_size_dims(self, a, b):
        sa, sb = shape_of(a), shape_of(b)
        for d in range(min(len(sa), len(sb))):
            if sa[d] == sb[d]:
                self.link(value_key(a), d, value_key(b), d)

    def _r_slice(self, node):
        """Full-size dims only (the JAX ``_r_slice``)."""
        self._same_size_dims(node.args[0], node)

    def _r_slice_backward(self, node):
        grad, sizes = node.args[:2]
        for d in range(len(sizes)):
            if shape_of(grad)[d] == sizes[d]:
                self.link(value_key(grad), d, node, d)

    def _r_cat(self, node):
        tensors = node.args[0]
        n = len(shape_of(node))
        dim = (node.args[1] if len(node.args) > 1 else 0) % n
        for t in tensors:
            if len(shape_of(t)) != n:
                continue
            for d in range(n):
                if d != dim:
                    self.link(value_key(t), d, node, d)

    def _r_constant_pad_nd(self, node):
        x, pad = node.args[:2]
        n = len(shape_of(x))
        padded = set()
        for k in range(len(pad) // 2):
            if pad[2 * k] or pad[2 * k + 1]:
                padded.add(n - 1 - k)
        for d in range(n):
            if d not in padded:
                self.link(value_key(x), d, node, d)

    def _r_roll(self, node):
        x = node.args[0]
        n = len(shape_of(x))
        rolled = set(_dims(node.args[2] if len(node.args) > 2 else
                           list(range(n)), n))
        for d in range(n):
            if d not in rolled:
                self.link(value_key(x), d, node, d)

    def _reduce(self, node):
        x = node.args[0]
        ishape = shape_of(x)
        n = len(ishape)
        dims = node.args[1] if len(node.args) > 1 else None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(n))
        dims = set(_dims(dims, n))
        keep = node.args[2] if len(node.args) > 2 else \
            node.kwargs.get("keepdim", False)
        o = 0
        for i in range(n):
            if i in dims:
                o += 1 if keep else 0
                continue
            self.link(value_key(x), i, node, o)
            o += 1

    def _r_gather(self, node):
        x, dim, index = node.args[:3]
        n = len(shape_of(x))
        dim %= n
        oshape = shape_of(node)
        for d in range(n):
            self.link(value_key(index), d, node, d)
            if d != dim and shape_of(x)[d] == oshape[d]:
                self.link(value_key(x), d, node, d)

    def _r_scatter_add(self, node):
        x, dim, index, src = node.args[:4]
        n = len(shape_of(x))
        dim %= n
        for d in range(n):
            self.link(value_key(x), d, node, d)
            self.link(value_key(index), d, value_key(src), d)
            if d != dim and shape_of(src)[d] == shape_of(x)[d]:
                self.link(value_key(src), d, node, d)

    _r_scatter = _r_scatter_add

    @staticmethod
    def _single_index(indices):
        """The one index tensor of an ``x[idx]`` on dim 0, else None."""
        idx = [i for i in indices if i is not None]
        if len(idx) == 1 and indices[0] is not None:
            return idx[0]
        return None

    def _r_index(self, node):
        x, indices = node.args[:2]
        idx = self._single_index(indices)
        if idx is None:
            return
        k = len(shape_of(idx))
        for d in range(k):
            self.link(value_key(idx), d, node, d)
        for d in range(1, len(shape_of(x))):
            self.link(value_key(x), d, node, k + d - 1)

    def _r_index_put(self, node):
        x, indices, values = node.args[:3]
        n = len(shape_of(x))
        for d in range(n):
            self.link(value_key(x), d, node, d)
        idx = self._single_index(indices)
        if idx is None:
            return
        k = len(shape_of(idx))
        vs = shape_of(values)
        if len(vs) != k + n - 1:
            return
        for d in range(k):
            self.link(value_key(idx), d, value_key(values), d)
        for d in range(1, n):
            self.link(value_key(values), k + d - 1, node, d)

    _r__unsafe_index_put = _r_index_put

    def _r_embedding(self, node):
        w, idx = node.args[:2]
        k = len(shape_of(idx))
        for d in range(k):
            self.link(value_key(idx), d, node, d)
        self.link(value_key(w), 1, node, k)

    def _r_embedding_dense_backward(self, node):
        grad, idx = node.args[:2]
        k = len(shape_of(idx))
        for d in range(k):
            self.link(value_key(idx), d, value_key(grad), d)
        self.link(value_key(grad), k, node, 1)

    def _r_index_select(self, node):
        x, dim, idx = node.args[:3]
        n = len(shape_of(x))
        dim %= n
        for d in range(n):
            if d != dim:
                self.link(value_key(x), d, node, d)
        self.link(value_key(idx), 0, node, dim)


# ----------------------------------------------------------- the tracer


def _path_str(path):
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
        elif hasattr(p, "name"):
            out.append(str(p.name))
        else:
            out.append(str(p))
    return "/".join(out)


def trace(fn, args):
    """``(graph module, [(path, leaf)])``: ``fn(*args)`` traced to aten
    operations by ``make_fx`` in fake mode (no data is computed), and the
    flattened argument leaves with their paths (``"0/blocks/qkv_w"``),
    in the order of the graph's placeholders."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    leaves_p, _ = pytree.tree_flatten_with_path(tuple(args))
    leaves = [(_path_str(p), x) for p, x in leaves_p]
    for path, x in leaves:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"argument leaf {path} is a "
                            f"{type(x).__name__}, not a tensor")
    with torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake")(*args)
    return gm, leaves


# ----------------------------------------------------------- the propagator


class ShardingPropagator:
    """Complete a full PartitionSpec tree from sparse annotations.

    ``mesh`` supplies axis names/sizes for validity checks (a port
    ``Mesh``, or a dict of axis sizes); annotations map fnmatch-style
    path patterns (over the flattened args pytree, e.g.
    ``"0/blocks/qkv_w"`` or ``"*qkv_w"``) to PartitionSpecs.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_sizes = axis_sizes(mesh)

    def complete(self, fn, args, annotations, *, return_out_specs=False):
        gm, leaves = trace(fn, args)
        res = self.complete_graph(gm, leaves, annotations)
        specs = _unflatten_like(args, [_trim(s) for s in res.input_specs])
        if return_out_specs:
            return specs, [_trim(s) for s in res.output_specs]
        return specs

    def complete_graph(self, gm, leaves, annotations):
        """The completed layout of every tensor of the traced graph: a
        ``Completion`` with the inputs' specs, the outputs' and
        ``spec_of(key)`` for any value."""
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(leaves):
            raise ValueError(
                f"flattened args ({len(leaves)}) != graph placeholders "
                f"({len(placeholders)}) — fn must take exactly the given "
                f"positional pytrees")
        paths = [p for p, _ in leaves]
        uf = _UnionFind()
        _LinkBuilder(uf).walk(gm.graph)

        class_axis = {}          # root -> (axis_or_tuple, owner_path)
        for pat, spec in annotations.items():
            hits = [i for i, p in enumerate(paths)
                    if fnmatch.fnmatch(p, pat)]
            if not hits:
                raise ValueError(
                    f"annotation {pat!r} matches no input; paths are like "
                    f"{paths[:5]}...")
            for i in hits:
                shape = tuple(leaves[i][1].shape)
                if len(spec) > len(shape):
                    raise ValueError(
                        f"{pat!r}: spec {spec} longer than rank of "
                        f"{paths[i]} {shape}")
                entries = tuple(spec) + (None,) * (len(shape) - len(spec))
                for d, ax in enumerate(entries):
                    if ax is None:
                        continue
                    self._check_div(shape[d], ax, paths[i], d)
                    root = uf.find((placeholders[i], d))
                    prev = class_axis.get(root)
                    if prev is not None and prev[0] != ax:
                        raise ValueError(
                            f"conflicting annotations: {paths[i]} dim {d} "
                            f"wants {ax!r} but its factor group already "
                            f"carries {prev[0]!r} (from {prev[1]})")
                    class_axis[root] = (ax, f"{paths[i]}[{d}]")
        return Completion(self, uf, class_axis, gm, placeholders)

    # ------------------------------------------------------------- helpers
    def _axis_size(self, ax):
        return math.prod(self.axis_sizes[a] for a in _names(ax))

    def _divides(self, dim, ax):
        return dim % self._axis_size(ax) == 0

    def _check_div(self, dim, ax, path, d):
        unknown = [a for a in _names(ax) if a not in self.axis_sizes]
        if unknown:
            raise ValueError(f"unknown mesh axis {unknown} in annotation "
                             f"for {path}[{d}] (mesh has "
                             f"{list(self.axis_sizes)})")
        if not self._divides(dim, ax):
            raise ValueError(
                f"{path} dim {d} of size {dim} not divisible by axis "
                f"{ax!r} (size {self._axis_size(ax)})")


class Completion:
    """The layout the union-find gives every value of a traced graph:
    ``spec_of(key, shape)`` (a full-length tuple, None where
    replicated), the inputs' (``input_specs``) and outputs'
    (``output_specs``), in graph order."""

    def __init__(self, prop, uf, class_axis, gm, placeholders):
        self.prop, self.uf, self.class_axis = prop, uf, class_axis
        self.gm, self.placeholders = gm, placeholders
        self._cache = {}

    def spec_of(self, key, shape):
        got = self._cache.get(key)
        if got is not None:
            return got
        used, entries = set(), []
        for d, size in enumerate(shape):
            hit = self.class_axis.get(self.uf.find((key, d)))
            ax = hit[0] if hit else None
            if ax is not None:
                flat = _names(ax)
                if any(a in used for a in flat) or \
                        not self.prop._divides(size, ax):
                    ax = None
                else:
                    used.update(flat)
            entries.append(ax)
        self._cache[key] = out = tuple(entries)
        return out

    @property
    def input_specs(self):
        return [self.spec_of(n, shape_of(n)) for n in self.placeholders]

    @property
    def output_specs(self):
        out = next(n for n in self.gm.graph.nodes if n.op == "output")
        flat = out.args[0]
        flat = flat if isinstance(flat, (list, tuple)) else [flat]
        return [self.spec_of(value_key(n), shape_of(n))
                if isinstance(n, torch.fx.Node) and shape_of(n) is not None
                else None for n in flat]


def _trim(spec):
    if spec is None:
        return None
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _unflatten_like(args, flat):
    from torch.utils import _pytree as pytree

    _, treedef = pytree.tree_flatten(tuple(args))
    return pytree.tree_unflatten(flat, treedef)


def complete(fn, args, annotations, mesh, **kw):
    """Functional form of ShardingPropagator.complete."""
    return ShardingPropagator(mesh).complete(fn, args, annotations, **kw)
