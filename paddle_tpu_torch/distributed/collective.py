"""Collective communication over ``torch.distributed`` process groups
(the port of ``paddle_tpu/distributed/collective.py``).

A ``Group`` is a set of global ranks with its own process group and,
where the topology made it, the name of the mesh axis (or axes) it runs
along.  The functions keep the JAX package's names, argument order and
results; where the JAX function is a collective inside ``shard_map``,
this one is the same collective across processes:

- ``all_reduce`` reduces in place and returns the tensor; ``reduce``
  gives every rank the reduction, as the SPMD ``psum`` does;
- ``broadcast(src=)``, ``scatter(src=)``, ``send(dst=)``,
  ``recv(src=)`` and ``ppermute``'s pairs name ranks by their index in
  the group (the mesh-axis index), not by global rank;
- ``all_gather`` concatenates along ``axis`` (or appends to a list),
  ``reduce_scatter`` returns this rank's block of the sum along dim 0,
  ``all_to_all`` is the tiled ``lax.all_to_all``, ``split`` this rank's
  slice, ``ppermute`` returns zeros where no pair sends to this rank;
- ``send``/``recv`` are real point-to-point messages (the JAX package
  raises there: SPMD has no one-sided send).

With ``group=None`` a call runs over the world group when
``init_parallel_env`` has set one up, and is the single participant's
identity otherwise, so code written for a world runs unchanged in one
process.

Transport.  Over NCCL every tensor goes as it is.  Over gloo a CPU
tensor goes as it is, and a CUDA tensor goes as it is for the
collectives gloo takes on CUDA (``GLOO_CUDA``); for the rest it is
copied into a pinned host buffer (reused from call to call, one per
use and dtype), sent from there and copied back: the compute stays on
the card.  Every call runs inside ``RecordEvent("collective::<op>")``
and adds to ``collective_stats()``: calls per op, and bytes, staged
bytes and host seconds per axis.

Every public op also routes through the distributed flight recorder
(:func:`~paddle_tpu_torch.observability.flight.record_collective`;
``tests/test_torch_flight.py`` lints it), as does ``AllToAll``'s
forward and backward: each call gets a monotonic sequence number,
byte/shape accounting, a ``collective::<op>`` tracer span and the
``collective_*`` registry series.  The ``collective.all_reduce`` /
``collective.barrier`` fault sites make cross-rank hangs reproducible
(``kind="stall"`` freezes a rank mid-collective with its record in
flight — what the ``HangWatchdog`` must localize).

Differentiable forms for the training step: ``AllToAll`` (Ulysses and
the expert dispatch; its backward is the inverse all-to-all) here, and
the tensor-parallel pair in ``mp_layers``.
"""
from __future__ import annotations

import time
import warnings

import torch
import torch.distributed as dist

from ..observability.flight import default_flight_recorder, \
    record_collective
from ..profiler.profiler import RecordEvent
from ..resilience.faults import fault_point

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce", "broadcast", "scatter", "reduce_scatter",
           "all_to_all", "send", "recv", "barrier", "split", "ppermute",
           "ring_shift", "AllToAll", "collective_stats",
           "reset_collective_stats",
           "world_group", "GLOO_CUDA"]

# torch 2.13 renames the tensor forms of all-gather and reduce-scatter;
# the old names are the ones every torch on hand has
warnings.filterwarnings("ignore", category=FutureWarning,
                        module=r"torch\.distributed\.c10d_logger")


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}

#: the collectives gloo runs on CUDA tensors itself (torch 2.11 on an
#: H100: ``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
#: ``reduce_scatter_tensor``, ``all_to_all_single``); a CUDA tensor goes
#: through pinned host memory for the others, the point-to-point sends
#: (gloo aborts the process on a CUDA ``isend``)
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather",
                       "reduce_scatter", "all_to_all"})


class Group:
    """A communication group: ``ranks`` (global, in group order), the
    ``torch.distributed`` process group over them (None for a group of
    one) and the mesh axis it runs along (``axis_name``; a tuple for a
    group over several axes)."""

    def __init__(self, ranks, pg=None, axis_name=None, gid=0, backend=None):
        self.ranks = list(ranks)
        self.pg = pg
        self.axis_name = axis_name
        self.id = gid
        self.backend = backend

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's index in the group (-1 outside it)."""
        me = dist.get_rank() if dist.is_initialized() else 0
        return self.ranks.index(me) if me in self.ranks else -1

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def label(self):
        """The axis name the byte counters use."""
        a = self.axis_name
        if a is None:
            return "world" if self.id == 0 else f"group{self.id}"
        return "+".join(a) if isinstance(a, (tuple, list)) else str(a)

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


_groups: dict = {}
_by_ranks: dict = {}
_next_gid = [1]


# lint-ok: collective-instrumented a group factory, as new_group: it
# moves no data
def world_group():
    """The group of every rank of the world (a group of one before
    ``init_parallel_env``)."""
    if dist.is_initialized():
        g = _groups.get(0)
        if g is None or g.nranks != dist.get_world_size():
            g = Group(range(dist.get_world_size()), dist.group.WORLD,
                      gid=0, backend=dist.get_backend())
            _groups[0] = g
        return g
    return Group([0], None, gid=0)


def new_group(ranks=None, backend=None, axis_name=None):
    """A group over ``ranks`` (global; default: the world).  As
    ``torch.distributed.new_group``, every rank of the world makes the
    same calls in the same order, members or not; a second call with the
    same ranks and backend shares the first one's process group."""
    if ranks is None:
        ranks = list(range(dist.get_world_size())) if \
            dist.is_initialized() else [0]
    ranks = [int(r) for r in ranks]
    key = (tuple(ranks), backend)
    pg = _by_ranks.get(key)
    if pg is None and len(ranks) > 1:
        if len(ranks) == dist.get_world_size() and \
                ranks == sorted(ranks) and backend is None:
            pg = dist.group.WORLD
        else:
            pg = dist.new_group(ranks, backend=backend)
        _by_ranks[key] = pg
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(ranks, pg, axis_name=axis_name, gid=gid,
              backend=backend or (dist.get_backend() if dist.is_initialized()
                                  else None))
    _groups[gid] = g
    return g


def get_group(gid=0):
    return world_group() if gid == 0 else _groups.get(gid)


# ------------------------------------------------------------ accounting

_stats = {"calls": {}, "bytes": {}, "staged_bytes": {}, "seconds": {}}


# lint-ok: collective-instrumented this rank's counters, read and reset
# locally: no data crosses the world
def reset_collective_stats():
    for v in _stats.values():
        v.clear()


# lint-ok: collective-instrumented this rank's counters, read and reset
# locally: no data crosses the world
def collective_stats():
    """``{"calls": {op: n}, "bytes": {axis: n}, "staged_bytes": {axis:
    n}, "seconds": {axis: s}}`` since the last reset: the bytes each
    call handed to the transport on this rank, those that went through
    pinned host memory, and the host time spent inside the calls."""
    return {k: dict(v) for k, v in _stats.items()}


def _add(d, k, v):
    d[k] = d.get(k, 0) + v


def _resolve(group):
    return world_group() if group is None else group


def _single(group):
    """True where the call has one participant (no process group)."""
    return group.pg is None


def _staged_needed(op, group, tensors):
    if group.backend != "gloo":
        return False
    cuda = any(t.is_cuda for t in tensors)
    return cuda and op not in GLOO_CUDA


_pinned: dict = {}


def _pin(tag, t):
    """A pinned host buffer of ``t``'s shape and dtype for use ``tag``: a
    view of one buffer a tag and dtype, reused from call to call and
    grown when a call needs more."""
    key = (tag, t.dtype)
    buf = _pinned.get(key)
    if buf is None or buf.numel() < t.numel():
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        _pinned[key] = buf
    return buf[:t.numel()].view(t.shape)


class _Call:
    """One collective call: its profiler range and its accounting; and,
    where the transport needs it, the host copies of CUDA tensors
    (``host``: a tensor → the one the transport is given; ``back``:
    copy the host results into the CUDA outputs)."""

    def __init__(self, op, group, inputs, outputs=()):
        self.op, self.group = op, group
        self.inputs, self.outputs = list(inputs), list(outputs)
        self.staged = _staged_needed(op, group, self.inputs + self.outputs)
        self._copies = []

    def __enter__(self):
        default_flight_recorder().mark_wire()
        self._ev = RecordEvent(f"collective::{self.op}")
        self._ev.begin()
        self._t0 = time.perf_counter()
        return self

    def host(self, t, tag, read=True):
        if not (self.staged and t.is_cuda):
            return t
        buf = _pin((self.op, tag), t)
        if read:
            buf.copy_(t)
        self._copies.append((t, buf))
        return buf

    def back(self, *pairs):
        for dst, src in pairs:
            if dst is not src:
                dst.copy_(src)

    def __exit__(self, *exc):
        label = self.group.label
        nbytes = sum(t.numel() * t.element_size() for t in self.inputs)
        _add(_stats["calls"], self.op, 1)
        _add(_stats["bytes"], label, nbytes)
        if self.staged:
            _add(_stats["staged_bytes"], label, nbytes)
        _add(_stats["seconds"], label, time.perf_counter() - self._t0)
        self._ev.end()
        return False


# ----------------------------------------------------------- collectives


@record_collective("all_reduce")
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group in place and return it.  ``AVG``
    is the sum divided by the group size; ``PROD`` an exact product."""
    fault_point("collective.all_reduce")
    group = _resolve(group)
    if _single(group):
        return tensor
    with _Call("all_reduce", group, [tensor]) as c:
        h = c.host(tensor, "x")
        if op == ReduceOp.AVG:
            dist.all_reduce(h, dist.ReduceOp.SUM, group=group.pg)
            h.div_(group.nranks)
        elif op in _TORCH_OP:
            dist.all_reduce(h, _TORCH_OP[op], group=group.pg)
        else:
            raise ValueError(f"unknown reduce op {op}")
        c.back((tensor, h))
    return tensor


def _gather_blocks(x, group):
    """``[n, *x.shape]``: every member's ``x`` in group order."""
    xf = x.reshape(-1)
    out = torch.empty(group.nranks * xf.numel(), dtype=x.dtype,
                      device=x.device)
    with _Call("all_gather", group, [xf], [out]) as c:
        hx, ho = c.host(xf.contiguous(), "x"), c.host(out, "out", read=False)
        dist.all_gather_into_tensor(ho, hx, group=group.pg)
        c.back((out, ho))
    return out.view(group.nranks, *x.shape)


@record_collective("all_gather")
def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True,
               axis=0):
    """``all_gather(out_list, x)`` appends every member's ``x`` to the
    list; ``all_gather(x, axis=a)`` returns the members' tensors
    concatenated along ``a``."""
    group = _resolve(group)
    if isinstance(tensor_or_list, list) and tensor is not None:
        if _single(group):
            tensor_or_list.append(tensor)
            return tensor_or_list
        tensor_or_list.extend(_gather_blocks(tensor, group).unbind(0))
        return tensor_or_list
    x = tensor_or_list
    if _single(group):
        return x
    g = _gather_blocks(x, group)
    if x.dim() == 0:
        return g
    return torch.cat(list(g.unbind(0)), dim=axis)


@record_collective("reduce")
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Every member gets the reduction (the SPMD ``psum``, whose value is
    ``dst``'s)."""
    return all_reduce.__wrapped__(tensor, op=op, group=group)


@record_collective("broadcast")
def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` takes the value of the member at index ``src``, in
    place."""
    group = _resolve(group)
    if _single(group):
        return tensor
    with _Call("broadcast", group, [tensor]) as c:
        h = c.host(tensor, "x")
        dist.broadcast(h, group.ranks[src], group=group.pg)
        c.back((tensor, h))
    return tensor


@record_collective("scatter")
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Member i gets block i of member ``src``'s ``tensor_list`` (or of
    its ``tensor`` split into equal blocks along dim 0)."""
    group = _resolve(group)
    if _single(group):
        return tensor
    x = torch.stack(list(tensor_list)) if tensor_list is not None else \
        tensor.unflatten(0, (group.nranks, -1))
    x = broadcast.__wrapped__(x.contiguous(), src=src, group=group)
    return x[group.rank]


@record_collective("reduce_scatter")
def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This member's block (along dim 0) of the group's sum of ``tensor``
    (or of ``tensor_list`` concatenated along dim 0)."""
    group = _resolve(group)
    x = torch.cat(list(tensor_list)) if tensor_list is not None else tensor
    if _single(group):
        return x
    n = group.nranks
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter splits dim 0 ({x.shape[0]}) over "
                         f"{n} members")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _Call("reduce_scatter", group, [x], [out]) as c:
        hx, ho = c.host(x, "x"), c.host(out, "out", read=False)
        dist.reduce_scatter_tensor(ho, hx, _TORCH_OP[op]
                                   if op != ReduceOp.AVG else
                                   dist.ReduceOp.SUM, group=group.pg)
        if op == ReduceOp.AVG:
            ho.div_(n)
        c.back((out, ho))
    return out


def _a2a(x, group, split_axis, concat_axis):
    n = group.nranks
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all splits axis {split_axis} "
                         f"({x.shape[split_axis]}) over {n} members")
    xs = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    with _Call("all_to_all", group, [xs], [out]) as c:
        hx, ho = c.host(xs, "x"), c.host(out, "out", read=False)
        dist.all_to_all_single(ho, hx, group=group.pg)
        c.back((out, ho))
    # out[j] is member j's block: place it j-th along concat_axis
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


@record_collective("all_to_all")
def all_to_all(in_tensor_or_list, out_tensor_list=None, group=None,
               sync_op=True, split_axis=0, concat_axis=0):
    """Tiled all-to-all: ``x`` split along ``split_axis`` into one block
    a member, block i sent to member i, the received blocks concatenated
    along ``concat_axis`` in member order.  The list form returns the
    list whose element j is member j's element for this member."""
    group = _resolve(group)
    if isinstance(in_tensor_or_list, (list, tuple)):
        if _single(group):
            return list(in_tensor_or_list)
        x = torch.stack(list(in_tensor_or_list))
        out = list(_a2a(x, group, 0, 0).unflatten(0, (group.nranks, -1))
                   .unbind(0))
        out = [o.reshape(in_tensor_or_list[0].shape) for o in out]
        if out_tensor_list is not None:
            out_tensor_list.extend(out)
        return out
    if _single(group):
        return in_tensor_or_list
    return _a2a(in_tensor_or_list, group, split_axis, concat_axis)


def _p2p(ops, group, inputs, outputs, name):
    """Point-to-point ``ops`` ``(kind, tensor, member index, tag)`` as one
    batch; staged host buffers are kept per tag."""
    with _Call(name, group, inputs, outputs) as c:
        staged = []
        real = []
        for kind, t, peer, tag in ops:
            h = c.host(t, tag, read=kind == "send")
            real.append(dist.P2POp(dist.isend if kind == "send" else
                                   dist.irecv, h, group.ranks[peer],
                                   group=group.pg))
            if kind == "recv":
                staged.append((t, h))
        for w in dist.batch_isend_irecv(real):
            w.wait()
        c.back(*staged)


@record_collective("ring_shift")
def ring_shift(tensors, group):
    """Each member sends ``tensors`` to the next member of the group (in
    group order, the last to the first) and returns what the previous
    member sent: one ``batch_isend_irecv`` for all of them."""
    n, me = group.nranks, group.rank
    outs = [torch.empty_like(t) for t in tensors]
    ops = [("send", t.contiguous(), (me + 1) % n, f"s{i}")
           for i, t in enumerate(tensors)]
    ops += [("recv", o, (me - 1) % n, f"r{i}") for i, o in enumerate(outs)]
    _p2p(ops, group, list(tensors), outs, "ring_shift")
    return tuple(outs)


@record_collective("ppermute")
def ppermute(tensor, perm, group=None):
    """Send ``tensor`` along each ``(src, dst)`` pair of member indices;
    returns what arrived here, zeros where no pair ends here."""
    group = _resolve(group)
    if _single(group):
        return tensor
    me = group.rank
    out = torch.zeros_like(tensor)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(("send", tensor.contiguous(), d, f"s{d}"))
        if d == me:
            ops.append(("recv", out, s, f"r{s}"))
    if ops:
        _p2p(ops, group, [tensor], [out], "ppermute")
    return out


@record_collective("send")
def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to the member at index ``dst`` (which calls
    ``recv``)."""
    group = _resolve(group)
    _p2p([("send", tensor.contiguous(), dst, "s")], group, [tensor], [],
         "send")


@record_collective("recv")
def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from the member at index ``src``."""
    group = _resolve(group)
    _p2p([("recv", tensor, src, "r")], group, [], [tensor], "recv")
    return tensor


@record_collective("barrier")
def barrier(group=None):
    fault_point("collective.barrier")
    group = _resolve(group)
    if _single(group):
        return
    with _Call("barrier", group, []):
        dist.barrier(group=group.pg)


@record_collective("split")
def split(x, num_or_sections, axis=0, group=None):
    """This member's slice of ``x`` along ``axis``, in ``num_or_sections``
    equal parts."""
    group = _resolve(group)
    if _single(group):
        return x
    n = num_or_sections if isinstance(num_or_sections, int) else \
        len(num_or_sections)
    size = x.shape[axis] // n
    return x.narrow(axis, group.rank * size, size)


# ------------------------------------------------------ differentiable


class AllToAll(torch.autograd.Function):
    """``all_to_all(x, split_axis, concat_axis)`` whose backward is the
    inverse all-to-all of the gradient (split along ``concat_axis``,
    concatenated along ``split_axis``)."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        with default_flight_recorder().record("all_to_all", group, (x,)):
            return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        with default_flight_recorder().record("all_to_all", group, (g,)):
            return _a2a(g, group, concat_axis, split_axis), None, None, None
