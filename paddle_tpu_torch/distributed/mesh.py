"""Mesh construction, the sharding rule table and a rank's shards (the
port of ``paddle_tpu/distributed/mesh.py``).

The JAX module lays devices out in a named ``jax.sharding.Mesh`` and
puts arrays on it; here a ``Mesh`` is the same named grid of global
ranks (one process a rank), and a rank holds the LOCAL shard of each
leaf: ``shard_tree`` (``shard_params`` under the rule table) cuts it
from a full tree, ``gather_tree`` puts the full tree back together on
every rank, and ``shard_batch`` takes a rank's rows.

- ``PartitionSpec`` (``P``) is a tuple of axis names (or tuples of
  them, or None) per dimension, as JAX's.
- ``GPT_RULES`` / ``param_specs`` / ``resolve_spec`` are the JAX rule
  table and its resolution, unchanged: an axis the mesh lacks, or whose
  degree does not divide the dimension, resolves to replicated.
- ``zero_opt_specs``: each optimizer slot takes its parameter's spec
  plus a ``sharding`` split of the largest free dimension that divides.
- ``assert_placement`` / ``placement_report`` check the LOCAL shards a
  rank holds against the spec (the JAX versions read
  ``addressable_shards``).
- ``replica_peers``: the ranks of a (dp, mp, pp, sharding) grid that
  hold the same state as ``rank``.
"""
from __future__ import annotations

import re
import threading

import numpy as np

from . import collective
from .env import get_rank, get_world_size

__all__ = ["AXIS_ORDER", "PartitionSpec", "P", "Mesh", "build_mesh",
           "axis_sizes", "mesh_axis", "GPT_RULES", "resolve_spec",
           "param_specs", "shard_tree", "shard_params", "shard_batch",
           "gather_tree", "gather_leaf", "local_shard",
           "zero_opt_specs", "assert_placement", "placement_report",
           "replica_peers", "default_mesh", "set_default_mesh", "Shard",
           "window_of"]

AXIS_ORDER = ("dp", "mp", "pp", "sharding")

_LOCK = threading.Lock()
_DEFAULT_MESH = None     # guarded-by: _LOCK


class PartitionSpec(tuple):
    """Per-dimension axis names, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A named grid of global ranks: ``axis_names`` and ``shape``, the
    ranks in row-major order (``ranks``), and this process's
    coordinates (``coords``; None when it is not on the mesh)."""

    def __init__(self, sizes, ranks=None):
        self.axis_names = tuple(sizes)
        self.shape = tuple(int(n) for n in sizes.values())
        n = int(np.prod(self.shape))
        self.ranks = list(range(n)) if ranks is None else list(ranks)
        me = get_rank()
        self.coords = None
        if me in self.ranks:
            c = np.unravel_index(self.ranks.index(me), self.shape)
            self.coords = dict(zip(self.axis_names, (int(i) for i in c)))
        # every rank makes every axis group, in one order
        # (torch.distributed.new_group's rule)
        from .topology import axis_groups

        self._groups = {}
        for i, axis in enumerate(self.axis_names):
            for row in axis_groups(list(self.shape), [i]):
                g = collective.new_group([self.ranks[r] for r in row],
                                         axis_name=axis)
                if me in g.ranks:
                    self._groups[axis] = g

    @property
    def size(self):
        return len(self.ranks)

    def group(self, axis):
        """This rank's group along ``axis``."""
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"


def build_mesh(dp=1, mp=1, pp=1, sharding=1, ranks=None):
    """A ``(dp, mp, pp, sharding)`` mesh over the world's first
    ``dp·mp·pp·sharding`` ranks (or ``ranks``); the world must hold
    them."""
    sizes = {"dp": int(dp), "mp": int(mp), "pp": int(pp),
             "sharding": int(sharding)}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {n}")
    need = int(np.prod(list(sizes.values())))
    have = get_world_size() if ranks is None else len(ranks)
    if need > have:
        raise ValueError(
            f"mesh dp={dp} mp={mp} pp={pp} sharding={sharding} needs "
            f"{need} ranks; only {have} available (launch with "
            f"--nproc_per_node {need})")
    return Mesh(sizes, ranks=list(range(need)) if ranks is None else ranks)


def axis_sizes(mesh):
    """{axis name: degree}; ``mesh`` may also be such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.shape))


def mesh_axis(mesh, name):
    return axis_sizes(mesh).get(name, 1)


def default_mesh():
    with _LOCK:
        return _DEFAULT_MESH


def set_default_mesh(mesh):
    global _DEFAULT_MESH
    with _LOCK:
        _DEFAULT_MESH = mesh
    return mesh


# ------------------------------------------------------- the rule table

GPT_RULES = (
    (r"(^|[/_])wte$",     P("mp", None)),
    (r"(^|[/_])wpe$",     P(None, None)),
    (r"(^|[/_])lm_head$", P(None, "mp")),
    (r"qkv_w$",  P(None, None, "mp")),
    (r"qkv_b$",  P(None, "mp")),
    (r"proj_w$", P(None, "mp", None)),
    (r"proj_b$", P(None, None)),
    (r"(^|[/_])up_w$",   P(None, None, "mp")),
    (r"(^|[/_])up_b$",   P(None, "mp")),
    (r"(^|[/_])down_w$", P(None, "mp", None)),
    (r"(^|[/_])down_b$", P(None, None)),
    (r"(ln\d?|lnf)_[gb]$", P()),
)


def _leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict in insertion order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_leaf_paths(v, path + "/"))
        else:
            out.append((path, v))
    return out


def _map(tree, fn, prefix=""):
    return {k: (_map(v, fn, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


def _names(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def resolve_spec(spec, shape, mesh):
    """Prune ``spec`` against ``mesh``: an entry survives only if the mesh
    has every axis it names and their degree divides the dimension."""
    sizes = axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(None)
            continue
        degree = int(np.prod([sizes.get(a, 0) for a in _names(ax)]))
        out.append(ax if degree and dim % degree == 0 else None)
    return P(*out)


def _match_rule(path, rules):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P()


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def param_specs(tree, mesh, rules=GPT_RULES, extra_rules=()):
    """The resolved spec of every leaf of ``tree`` (same structure)."""
    rules = tuple(extra_rules) + tuple(rules)
    return _map(tree, lambda p, leaf: resolve_spec(
        _match_rule(p, rules), _shape(leaf), mesh))


def zero_opt_specs(param_spec_tree, state_like, mesh, axis="sharding"):
    """Each slot leaf under a parameter gets the parameter's spec plus an
    ``axis`` split of its largest free dimension that divides."""
    degree = mesh_axis(mesh, axis)

    def leaf_spec(spec, shape):
        shape = tuple(shape)
        if degree <= 1 or not shape:
            return resolve_spec(spec, shape, mesh)
        base = list(resolve_spec(spec, shape, mesh))
        base += [None] * (len(shape) - len(base))
        free = [(shape[i], i) for i in range(len(shape))
                if base[i] is None and shape[i] % degree == 0]
        if free:
            _, i = max(free)
            base[i] = axis
        return P(*base)

    def per_param(specs, sub):
        if isinstance(specs, dict):
            return {k: per_param(specs[k], sub[k]) for k in specs}
        if isinstance(sub, dict):
            return {k: per_param(specs, v) for k, v in sub.items()}
        return leaf_spec(specs, _shape(sub))

    return per_param(param_spec_tree, state_like)


# ------------------------------------------------------- a rank's shards


def _coords(mesh):
    if isinstance(mesh, dict):
        raise TypeError("a rank's shard needs a Mesh (its coordinates), "
                        "not a dict of sizes")
    if mesh.coords is None:
        raise ValueError(f"rank {get_rank()} is not on {mesh}")
    return mesh.coords


def local_shard(full, spec, sizes, coords):
    """The block of ``full`` that the rank at ``coords`` holds under
    ``spec`` (a view; dims split over several axes take them in the
    order the entry names them, the first outermost)."""
    out = full
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        n, idx = 1, 0
        for a in names:
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def shard_tree(tree, mesh, spec_tree):
    """This rank's shard of every leaf of the full ``tree`` under the
    same-structure ``spec_tree`` (contiguous copies)."""
    sizes, coords = axis_sizes(mesh), _coords(mesh)
    return _map(tree, lambda p, leaf: local_shard(
        leaf, _spec_at(spec_tree, p), sizes, coords).contiguous())


def shard_params(tree, mesh, rules=GPT_RULES, extra_rules=()):
    """This rank's shard of every leaf of the full ``tree`` under the
    resolved rule table (``param_specs``)."""
    return shard_tree(tree, mesh, param_specs(tree, mesh, rules=rules,
                                              extra_rules=extra_rules))


def shard_batch(mesh, *arrays, axis="dp"):
    """This rank's rows of each array: its leading (batch) dim split over
    ``axis`` (whole where the degree does not divide it).  One array or
    a tuple, matching the call."""
    n, i = mesh_axis(mesh, axis), _coords(mesh).get(axis, 0)
    out = []
    for x in arrays:
        rows = x.shape[0] if len(x.shape) else 0
        out.append(x[i * (rows // n):(i + 1) * (rows // n)]
                   if rows and rows % n == 0 else x)
    return out[0] if len(out) == 1 else tuple(out)


class Shard:
    """A rank's window of a global array (the port's form of a JAX
    ``addressable_shard``): ``data`` the local tensor, ``shape`` the
    global shape, ``index`` the window as ``[(start, stop)]`` per
    dimension, and ``owner``: whether this rank is the one that writes
    the window (several ranks may hold it).  ``checkpoint.save_sharded``
    writes it under its window, ``integrity.shard_fingerprint`` digests
    it as ``path@start:stop,...``."""

    def __init__(self, data, shape, index, owner=True):
        self.data = data
        self.shape = tuple(int(n) for n in shape)
        self.index = [(int(a), int(b)) for a, b in index]
        self.owner = bool(owner)
        want = tuple(b - a for a, b in self.index)
        if tuple(data.shape) != want:
            raise ValueError(f"a shard of shape {tuple(data.shape)} does "
                             f"not fill its window {self.index}")

    @property
    def key(self):
        return ",".join(f"{a}:{b}" for a, b in self.index) or "0:1"

    def __repr__(self):
        return f"Shard({self.key} of {self.shape})"


def window_of(spec, shape, sizes, coords):
    """``[(start, stop)]`` of the block of a ``shape`` array that the
    rank at ``coords`` holds under ``spec`` (``local_shard``'s block)."""
    out = []
    for d, n in enumerate(shape):
        names = _names(spec[d]) if d < len(spec) else ()
        k, idx = 1, 0
        for a in names:
            k, idx = k * sizes[a], idx * sizes[a] + coords[a]
        out.append((idx * (n // k), (idx + 1) * (n // k)))
    return out


def _spec_at(specs, path):
    node = specs
    for k in path.split("/"):
        node = node[k]
    return node


def gather_leaf(x, spec, mesh):
    """The whole array from every rank's block ``x`` under ``spec``
    (all-gathered along each split dimension over its axis group)."""
    sizes = axis_sizes(mesh)
    for dim in reversed(range(len(spec))):
        for a in reversed(_names(spec[dim])):
            if sizes[a] > 1:
                x = collective.all_gather(x.contiguous(),
                                          group=mesh.group(a), axis=dim)
    return x


def gather_tree(local, mesh, spec_tree):
    """Inverse of ``shard_tree``: the full tree on every rank of the
    mesh, gathered along each sharded dimension over its axis group."""
    return _map(local, lambda path, x: gather_leaf(
        x, _spec_at(spec_tree, path), mesh))


# -------------------------------------------------- placement assertions


def _want_shape(full_shape, spec, sizes):
    want, tiles = [], 1
    for i, dim in enumerate(full_shape):
        ax = spec[i] if i < len(spec) else None
        degree = int(np.prod([sizes[a] for a in _names(ax)])) if ax else 1
        want.append(dim // degree)
        tiles *= degree
    return tuple(want), tiles


def assert_placement(local, full_shape, mesh, spec, name="array"):
    """Assert that ``local`` is this rank's shard of a ``full_shape``
    array under ``resolve_spec(spec)``: its shape is the full shape over
    the axis degrees."""
    spec = resolve_spec(spec, full_shape, mesh)
    want, _ = _want_shape(full_shape, spec, axis_sizes(mesh))
    if tuple(local.shape) != want:
        raise AssertionError(
            f"{name}: local shard shape {tuple(local.shape)} != expected "
            f"{want} under spec {spec}")
    return True


def placement_report(local_tree, full_tree, mesh, specs, prefix=""):
    """{leaf path: {spec, devices, distinct_windows, shard_shape}} for a
    rank's shards: ``devices`` the mesh's ranks, ``distinct_windows``
    the number of different blocks the spec cuts the leaf into."""
    sizes = axis_sizes(mesh)
    full = dict(_leaf_paths(full_tree))
    out = {}
    for path, x in _leaf_paths(local_tree):
        spec = _spec_at(specs, path)
        _, tiles = _want_shape(_shape(full[path]), spec, sizes)
        out[f"{prefix}{path}"] = {
            "devices": int(np.prod(list(sizes.values()))),
            "distinct_windows": tiles,
            "shard_shape": list(x.shape),
            "spec": [None if s is None else str(s) for s in spec]}
    return out


# ------------------------------------------------------- replica groups


def replica_peers(rank, axes, axis="dp"):
    """Ranks of the (dp, mp, pp, sharding) grid holding state bitwise
    equal to ``rank``'s: same coordinates on every axis but ``axis``."""
    dims = [int(axes.get(a, 1)) for a in AXIS_ORDER]
    world = int(np.prod(dims))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world of {world}")
    coords = list(np.unravel_index(rank, dims))
    try:
        vary = AXIS_ORDER.index(axis)
    except ValueError:
        raise ValueError(f"unknown mesh axis {axis!r}") from None
    peers = []
    for i in range(dims[vary]):
        c = list(coords)
        c[vary] = i
        peers.append(int(np.ravel_multi_index(c, dims)))
    return sorted(peers)

