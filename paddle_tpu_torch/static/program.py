"""Program IR — the rewritable op-list program (the port of
``paddle_tpu/static/program.py``; reference parity: framework.proto
ProgramDesc/OpDesc/VarDesc, python Program/Block (fluid/framework.py:4777,
3199) and append_op capture).

The JAX package records at its op dispatcher.  The port has none (its
ops are torch calls), so ``program_guard`` records through a
``torch.overrides.TorchFunctionMode``: while a Program is being built,
each outermost torch call (a function, a tensor method or operator, a
factory) is run as usual and appended as an ``OpDesc`` holding the
callable, its argument structure, its inputs (placeholders or earlier
outputs as variables; other tensors as live references, so weight
updates between runs are visible) and its outputs.  A call is recorded
when it returns a tensor and it reads a placeholder, an earlier output or
a ``Parameter``, or reads no tensor at all (a factory such as
``torch.ones`` or ``torch.rand``, which replays as a fresh draw); calls
on other tensors only are computed once at capture, and calls that
return no tensor (attribute reads such as ``.shape``, ``bool``) are not
recorded.  The op list is a real IR: passes rewrite it
(``static/passes.py``), ``Executor`` replays it.

``data`` makes a placeholder of zeros, with a ``None`` or negative dim
as 1 (as in the JAX package): the program replays at other sizes of that
dim as long as no recorded call baked it in (the port's
``MultiHeadAttention`` reads no batch size).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..core.dtype import convert_dtype
from ..core.place import current_device

__all__ = ["Program", "program_guard", "default_main_program",
           "current_program", "data", "OpDesc", "VarDesc"]

_counter = itertools.count()

# tensors defined inside a control-flow sub-block, so an enclosing block
# can refuse them loudly instead of baking a stale capture-time value
# (reference: scope hierarchy makes inner-block vars invisible outside).
# Keyed by id() with a weak reference to the tensor; a finalizer purges
# the entry when the tensor goes.
_block_owner: dict = {}


def _register_block_tensor(t, prog):
    tid = id(t)
    _block_owner[tid] = (weakref.ref(t), weakref.ref(prog))
    weakref.finalize(t, _block_owner.pop, tid, None)


def _owner_of(t):
    entry = _block_owner.get(id(t))
    if entry is not None and entry[0]() is t:
        return entry[1]()
    return None


def _root(p):
    while p.parent is not None:
        p = p.parent
    return p


def _op_name(func):
    name = getattr(func, "__name__", None) or repr(func)
    if name == "__get__":             # a tensor attribute (x.T, x.mT)
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    return name


class VarDesc:
    __slots__ = ("vid", "name", "shape", "dtype", "is_feed")

    def __init__(self, vid, name, shape, dtype, is_feed=False):
        self.vid = vid
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.is_feed = is_feed

    def __repr__(self):
        kind = "feed" if self.is_feed else "var"
        dtype = str(self.dtype).replace("torch.", "")
        return f"{kind} {self.name}: {dtype}{list(self.shape)}"


class _VarRef:
    """Marker replacing a tensor leaf in an OpDesc's arg structure."""

    __slots__ = ("vid",)

    def __init__(self, vid):
        self.vid = vid


class _ParamRef:
    """A leaf bound to a LIVE tensor (a layer parameter, a constant): its
    value is read at run time, so training updates flow into later
    runs."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


class OpDesc:
    """One recorded call: ``fn(*args, **kwargs)`` rebuilt from ``leaves``
    by ``treedef``; ``out_vids`` name the tensors among its outputs'
    leaves, in order."""

    __slots__ = ("name", "fn", "treedef", "leaves", "out_vids")

    def __init__(self, name, fn, treedef, leaves, out_vids):
        self.name = name
        self.fn = fn
        self.treedef = treedef
        self.leaves = leaves          # list of _VarRef/_ParamRef/literal
        self.out_vids = out_vids

    def input_vids(self):
        return [leaf.vid for leaf in self.leaves
                if isinstance(leaf, _VarRef)]

    def __repr__(self):
        ins = ",".join(f"v{v}" for v in self.input_vids())
        outs = ",".join(f"v{v}" for v in self.out_vids)
        return f"{self.name}({ins}) -> {outs}"


class _State(threading.local):
    def __init__(self):
        self.stack = []       # programs being built, innermost last
        self.paused = 0       # >0 while a Program's own code runs


_state = _State()


@contextlib.contextmanager
def _paused():
    """Run the IR's own torch calls (placeholders, copies) unrecorded."""
    _state.paused += 1
    try:
        yield
    finally:
        _state.paused -= 1


class _Recorder(TorchFunctionMode):
    """Appends every outermost torch call to the current program (the
    mode is off while the call runs, so the calls inside it are not
    seen)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        prog = current_program()
        if prog is not None and not _state.paused:
            prog.record(func, args, kwargs, out)
        return out


class Program:
    """An ordered op list over named variables (ProgramDesc analog).

    ``parent`` links a control-flow sub-block to its enclosing program
    (the reference's BlockDesc.parent_idx): vids are globally unique, so
    a sub-block op may reference an outer variable directly — such free
    variables are tracked in ``free_vars`` and become inputs of the
    enclosing cond/while op (conditional_block_op's input list)."""

    def __init__(self, parent=None):
        self.parent = parent
        self.vars: dict[int, VarDesc] = {}
        self.ops: list[OpDesc] = []
        self._tensor_vids: dict[int, int] = {}   # id(tensor) -> vid
        self._feed_names: dict[str, int] = {}
        self.free_vars: dict[int, torch.Tensor] = {}   # outer vid -> tensor
        # strong refs to every tensor keyed by id(): CPython reuses
        # addresses after GC, which would miswire lookup()
        self._keepalive: list = []
        # bumped on every mutation (record / pass application) so the
        # Executor's cache can detect in-place rewrites
        self.version = 0
        self.device = None    # where the first feed was declared

    # ---------------------------------------------------------- building
    def _new_var(self, t, name=None, is_feed=False):
        vid = next(_counter)
        self.vars[vid] = VarDesc(vid, name or f"tmp_{vid}", t.shape,
                                 t.dtype, is_feed)
        self._tensor_vids[id(t)] = vid
        self._keepalive.append(t)
        if self.parent is not None:
            _register_block_tensor(t, self)
        return vid

    def add_feed(self, name, shape, dtype):
        concrete = [1 if (d is None or d < 0) else d for d in shape]
        with _paused():
            t = torch.zeros(concrete, dtype=convert_dtype(dtype),
                            device=current_device())
        vid = self._new_var(t, name, is_feed=True)
        self.vars[vid].shape = tuple(shape)
        self._feed_names[name] = vid
        self.device = self.device or t.device
        return t

    def add_local_like(self, tensor, name="ph"):
        """A block-local placeholder (while-loop carry var)."""
        with _paused():
            t = torch.zeros_like(tensor)
        vid = self._new_var(t)
        self.vars[vid].name = f"{name}_{vid}"
        return t, vid

    def lookup(self, tensor):
        return self._tensor_vids.get(id(tensor))

    def lookup_chain(self, tensor):
        """Resolve through enclosing blocks; marks outer hits as free."""
        vid = self.lookup(tensor)
        if vid is not None:
            return vid
        outer = self.parent
        while outer is not None:
            vid = outer.lookup(tensor)
            if vid is not None:
                self.free_vars[vid] = tensor
                return vid
            outer = outer.parent
        return None

    def record(self, func, args, kwargs, out, always=False):
        """Append the call ``func(*args, **kwargs) -> out`` if it is one
        the module docstring says is recorded (``always``: in any case;
        a cond or while op)."""
        out_leaves = pytree.tree_leaves(out)
        outs = [o for o in out_leaves if isinstance(o, torch.Tensor)]
        if not outs:
            return
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        enc, reads_var, reads_tensor, reads_param = [], False, False, False
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                enc.append(leaf)
                continue
            reads_tensor = True
            vid = self.lookup_chain(leaf)
            if vid is None:
                owner = _owner_of(leaf)
                if owner is not None and _root(owner) is _root(self):
                    raise RuntimeError(
                        "a tensor defined inside a control-flow "
                        "sub-block (cond/while) was used outside it; "
                        "inner-block variables are invisible to the "
                        "enclosing block — return the value from the "
                        "branch/body instead")
                reads_param |= isinstance(leaf, torch.nn.Parameter)
                enc.append(_ParamRef(leaf))
            else:
                reads_var = True
                enc.append(_VarRef(vid))
        if not (always or reads_var or reads_param or not reads_tensor):
            return
        out_vids = [self._new_var(o) for o in outs]
        self.ops.append(OpDesc(_op_name(func), func, treedef, enc,
                               out_vids))
        self.version += 1

    def has_control_flow(self):
        return any(op.name in ("cond", "while") for op in self.ops)

    # ----------------------------------------------------------- replay
    def param_refs(self):
        """The live tensors this program reads, in first-use order (what
        a captured graph of it reads besides its feeds)."""
        refs, seen = [], set()
        for op in self.ops:
            for leaf in op.leaves:
                if isinstance(leaf, _ParamRef) and id(leaf.tensor) not in seen:
                    seen.add(id(leaf.tensor))
                    refs.append(leaf.tensor)
        return refs

    def replay(self, feed_tensors, fetch_vids):
        """Execute the op list: feed name → tensor, return the fetched
        tensors."""
        values = {self._feed_names[k]: v for k, v in feed_tensors.items()}
        return self.replay_env(values, fetch_vids)

    def replay_env(self, values, fetch_vids):
        """Replay over a prepopulated {vid: tensor} environment — also the
        entry control-flow blocks use, seeded with their free/carry vars
        (the reference's scope-hierarchy lookup in conditional_block)."""

        def resolve(leaf):
            if isinstance(leaf, _VarRef):
                return values[leaf.vid]
            if isinstance(leaf, _ParamRef):
                return leaf.tensor
            return leaf

        for op in self.ops:
            args, kwargs = pytree.tree_unflatten(
                [resolve(leaf) for leaf in op.leaves], op.treedef)
            out = op.fn(*args, **kwargs)
            outs = [o for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            for vid, o in zip(op.out_vids, outs):
                values[vid] = o
        return [values[v] for v in fetch_vids]

    # ------------------------------------------------------------- intro
    def to_string(self):
        lines = [f"program ({len(self.ops)} ops, {len(self.vars)} vars)"]
        for v in self.vars.values():
            if v.is_feed:
                lines.append(f"  {v!r}")
        for op in self.ops:
            lines.append(f"  {op!r}")
        return "\n".join(lines)

    __str__ = to_string

    def clone(self, for_test=False):
        p = Program(parent=self.parent)
        p.free_vars = dict(self.free_vars)
        p.vars = dict(self.vars)
        # new OpDescs: passes rewrite them in place and must not leak
        # their rewrites into the original program
        p.ops = [OpDesc(o.name, o.fn, o.treedef, list(o.leaves),
                        list(o.out_vids)) for o in self.ops]
        p._tensor_vids = dict(self._tensor_vids)
        p._feed_names = dict(self._feed_names)
        p._keepalive = list(self._keepalive)
        p.device = self.device
        return p


_default_main = Program()


def default_main_program():
    return _default_main


def current_program():
    return _state.stack[-1] if _state.stack else None


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Record subsequent torch calls into ``main_program``.  One recorder
    serves nested guards (a control-flow block records into the
    innermost program)."""
    outer = not _state.stack
    _state.stack.append(main_program)
    try:
        if outer:
            with _Recorder():
                yield
        else:
            yield
    finally:
        _state.stack.pop()


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed variable (reference: paddle.static.data)."""
    prog = current_program() or _default_main
    return prog.add_feed(name, shape, dtype)
