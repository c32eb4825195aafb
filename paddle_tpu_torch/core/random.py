"""Random state (the port of ``paddle_tpu/core/random.py``).

Named streams, each one explicit ``torch.Generator`` per device, made on
first use.  The initializers, dropout, the random ops and
``distribution`` draw from ``generator(device)``: the active stream's
generator of that device.  ``seed(n, stream)`` seeds one stream (every
device's generator with ``n``; ``paddle.seed(n)`` is the default
stream's); until then a stream is seeded from numpy's global state, as
the JAX package seeds its streams.  A generator keeps its identity for
the life of the process (``seed`` and ``set_rng_state`` write its state
in place), so a CUDA graph that registered it (``_captured.CapturedStep``
registers ``generators(device)``, every stream's, with each graph) keeps
advancing the one every eager call draws from.

Each stream also holds a host generator, its key: ``split_key()`` draws
one int64 seed from it (``current_key`` is its state).  ``key_stream(
seed)`` makes every generator request inside it a fresh generator seeded
from ``(seed, n)`` for the n-th request on a device (the JAX package's
``fold_in(key, counter)``), and no stream advances inside it: this is
how ``distributed.recompute`` replays a segment's dropout masks.  Such a
generator cannot be registered with a CUDA graph being captured, so a
request there raises.

A captured step cannot make fresh generators, and a seed drawn on the
host while it is captured would be frozen into every replay.  So a step
body runs inside ``step_scope()`` (``_captured.CapturedStep`` enters it
around every body it runs, hapi's step bodies enter it themselves), and
there the k-th ``key_stream`` of the body draws from pair k of the
active stream instead: generators seeded equally from one
``split_key()`` of the stream, drawn once, when the pair is made (as a
JAX trace draws its key once).  A pair holds one generator a device for
each run of a ``recompute`` segment in a step: the forward draws from
the first member, the backward's recompute from the second (``segment_
streams``).  Every step starts (``begin_step``: the scope's entry, and
``CapturedStep`` before each replay) by setting every member to its
first member's state, so the recompute draws the forward's masks while
each step draws fresh ones.  ``split_key()`` in a scope draws nothing
on the host once the pair the next ``key_stream`` takes exists: the
n-th call before that ``key_stream`` (in the step, or in the run of the
enclosing segment) returns seed n derived from that pair's seed, so the
calls of a step differ, a recompute gets its forward's values, and
every step gets the same ones (the values a captured graph holds, as a
JAX trace holds its keys; a ``key_stream`` ignores its argument there);
a ``key_stream`` nested in a pair's draws from a child pair.  The
members are made in the step's eager run, before a capture, and
``generators(device)`` lists them, so each graph registers them and a
replay advances them as an eager step does; a member first asked for
during a capture raises.  A scope entered inside another one is that
one, and ``begin_step`` there does nothing: a step replayed inside
another step's body leaves the enclosing step's pairs as they are (a
segment's recompute, which autograd may run on another thread, runs in
its forward's scope).  ``seed`` and ``set_rng_state`` (a pair absent
from the snapshot) make a stream's pairs stale: the next step draws
their seeds again from the stream's key, in order, as new pairs would.

``RNGStatesTracker`` (Megatron's, as in the JAX package) names the
streams of tensor parallelism: ``add("global_seed", s)`` on every rank
of an mp group draws equal masks there, ``add("local_seed", s + rank)``
distinct ones; ``with tracker.rng_state(name):`` makes the stream
active.  The active stream and ``key_stream`` are the calling thread's;
the streams are the process's.

Masks drawn here differ from the JAX package's for the same seed: a JAX
key and a torch generator are different functions of it."""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["seed", "split_key", "current_key", "key_stream", "generator",
           "generators", "get_rng_state", "set_rng_state",
           "RNGStatesTracker", "get_rng_state_tracker", "step_scope",
           "begin_step", "segment_streams"]

_M64 = (1 << 64) - 1


def _mix(base: int, n: int) -> int:
    """splitmix64 of ``(base, n)``: a seed in [0, 2**63)."""
    z = (int(base) + (n + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def _fresh_seed() -> int:
    return int(np.random.randint(0, 2 ** 31 - 1))


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _capturing(key: str) -> bool:
    return key.startswith("cuda") and torch.cuda.is_current_stream_capturing()


class _Pair:
    """The generators one ``key_stream`` of a step scope draws from: for
    each device, one member a run of its segment in a step, all seeded
    with ``seed``; ``start`` is the first member's state where the step
    began, ``children`` the pairs of the ``key_stream``s nested in it."""

    def __init__(self, seed):
        self.seed = seed
        self.stale = seed is None     # its seed is drawn again when used
        self.runs = 0                 # runs this step: the next member
        self.members: dict[str, list[torch.Generator]] = {}
        self.start: dict[str, torch.Tensor] = {}
        self.children: list[_Pair] = []

    def reseed(self, seed):
        self.seed, self.stale = seed, False
        self.start.clear()
        for gens in self.members.values():
            for gen in gens:
                gen.manual_seed(seed)
        for n, child in enumerate(self.children):
            child.reseed(_mix(seed, n))

    def child(self, n: int) -> "_Pair":
        while len(self.children) <= n:
            self.children.append(_Pair(_mix(self.seed,
                                            len(self.children))))
        return self.children[n]

    def member(self, key: str, i: int) -> torch.Generator:
        gens = self.members.setdefault(key, [])
        while len(gens) <= i:
            if _capturing(key):
                raise RuntimeError(
                    "key_stream in a step scope asked for a generator it "
                    "has not made yet while a CUDA graph is being "
                    "captured, which cannot register it: run the step "
                    "once eagerly before capturing it (CapturedStep "
                    "does)")
            gen = torch.Generator(device=key)
            if key in self.start:       # made mid-step: where the step began
                gen.set_state(self.start[key])
            else:
                gen.manual_seed(self.seed)
            gens.append(gen)
        return gens[i]

    def next_run(self) -> int:
        """The member the next run of a segment on this pair draws from:
        the runs of a step in the order they start (a recompute's
        forward, the recompute of an enclosing segment, its own)."""
        self.runs += 1
        return self.runs - 1

    def sync(self, states=True):
        """A step's start: no run yet, and (``states``) every member at
        its first member's state."""
        self.runs = 0
        for key, gens in self.members.items() if states else ():
            self.start[key] = state = gens[0].get_state()
            for gen in gens[1:]:
                gen.set_state(state)
        for child in self.children:
            child.sync(states)

    def generators(self, key: str):
        out = list(self.members.get(key, ()))
        for child in self.children:
            out += child.generators(key)
        return out

    def state(self):
        st = {"seed": torch.tensor(self.seed, dtype=torch.int64)}
        st.update((key, gens[0].get_state())
                  for key, gens in self.members.items())
        if self.children:
            st["children"] = {str(n): c.state()
                              for n, c in enumerate(self.children)}
        return st

    def load(self, st):
        self.reseed(int(st["seed"]))
        for key, v in st.items():
            if key not in ("seed", "children"):
                self.member(key, 0)
                self.start[key] = v
                for gen in self.members[key]:
                    gen.set_state(v)
        for n, cst in st.get("children", {}).items():
            self.child(int(n)).load(cst)


class _Stream:
    """One named stream: its seed (None: each generator from numpy), its
    host key generator, its generator of each device and the pairs of
    the step scopes' ``key_stream``s."""

    def __init__(self, value=None):
        self.seed = value
        self._key = None
        self.gens: dict[str, torch.Generator] = {}
        self.pairs: list[_Pair] = []

    def reseed(self, value):
        self.seed, self._key = value, None
        for gen in self.gens.values():
            gen.manual_seed(value)
        for pair in self.pairs:
            pair.stale = True

    def draw(self) -> int:
        """One int64 seed from the key (``split_key``)."""
        return int(torch.randint(2 ** 63 - 1, (), generator=self.key))

    def pair(self, k: int) -> _Pair:
        """Pair ``k``, made (and the ones before it) with a seed drawn
        from the key each, or drawn again if stale."""
        while len(self.pairs) <= k:
            self.pairs.append(_Pair(None))
        for pair in self.pairs[:k + 1]:
            if pair.stale:
                pair.reseed(self.draw())
        return self.pairs[k]

    @property
    def key(self) -> torch.Generator:
        if self._key is None:
            base = _fresh_seed() if self.seed is None else self.seed
            self._key = torch.Generator().manual_seed(_mix(base, -1))
        return self._key

    def generator(self, key: str) -> torch.Generator:
        gen = self.gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key).manual_seed(
                _fresh_seed() if self.seed is None else self.seed)
            self.gens[key] = gen
        return gen


class _Override:
    """A ``key_stream``: the n-th generator request on a device and the
    n-th ``split_key`` get seeds mixed from ``base`` and n."""

    def __init__(self, base):
        self.base = int(base)
        self.counts: dict[str, int] = {}

    def next_seed(self, slot: str, odd: int) -> int:
        n = self.counts.get(slot, 0)
        self.counts[slot] = n + 1
        return _mix(self.base, 2 * n + odd)


class _PairOverride:
    """A run on ``pair`` (a ``key_stream`` of a step scope): draws from
    the member of this run; the n-th ``key_stream`` nested in it takes
    child n."""

    def __init__(self, pair):
        self.pair, self.member, self.nested = pair, pair.next_run(), 0
        self.splits = {}          # split_key calls of this run, by pair


class _RandomState(threading.local):
    # thread-local by design (each thread has its active stream, its
    # key_stream and its step scope: the key_streams taken so far by
    # stream, and the split_key calls by pair); the streams themselves
    # are the process's
    def __init__(self):
        self.active = "default"
        self.override = None
        self.scope = None
        self.splits = {}


_streams: dict[str, _Stream] = {}
_state = _RandomState()


def _stream(name: str) -> _Stream:
    s = _streams.get(name)
    if s is None:
        s = _streams[name] = _Stream()
    return s


def seed(value: int, stream: str = "default"):
    """Seed one named stream (parity: ``paddle.seed`` for the default
    one): each of its device generators with ``value``, its key from
    it."""
    value = int(value)
    if stream in _streams:
        _streams[stream].reseed(value)
    else:
        _streams[stream] = _Stream(value)
    return value


def _next_pair(take: bool, stream: str | None = None):
    """The pair the next ``key_stream`` here draws from (taken when
    ``take``): a child of the enclosing pair, or in a step scope the
    active (or named) stream's next pair; None elsewhere."""
    o = _state.override
    if isinstance(o, _PairOverride):
        pair = o.pair.child(o.nested)
        o.nested += take
        return pair
    if o is None and _state.scope is not None:
        name = stream or _state.active
        k = _state.scope.get(name, 0)
        if take:
            _state.scope[name] = k + 1
        return _stream(name).pair(k)
    return None


@contextlib.contextmanager
def _overridden(override):
    prev = _state.override
    _state.override = override
    try:
        yield
    finally:
        _state.override = prev


def key_stream(base):
    """Draw everything inside from generators derived from ``base`` (an
    int, e.g. a ``split_key()``), leaving every stream as it is; the
    previous ``key_stream`` comes back on exit.  In a step scope, from
    the next pair instead (module docstring; ``base`` is not read)."""
    pair = _next_pair(take=True)
    return _overridden(_Override(base) if pair is None
                       else _PairOverride(pair))


def segment_streams():
    """For a segment run once in the forward and again in the backward's
    recompute (``distributed.recompute``): ``run()`` is the context each
    run draws under.  Outside a step scope, ``key_stream`` of one
    ``split_key()`` for every run; in one, the next pair, each run on
    its own member and in the caller's step scope."""
    pair = _next_pair(take=True)
    if pair is None:
        base = split_key()
        return lambda: _overridden(_Override(base))
    scope = _state.scope, _state.splits
    return lambda: _segment_run(scope, _PairOverride(pair))


@contextlib.contextmanager
def _segment_run(scope, override):
    """One run of a segment in a step: on whichever thread runs it
    (autograd runs a CUDA recompute on its device thread, where this
    module's thread-local state is empty) the step's scope is the
    caller's, so a step replayed inside the run is part of that step."""
    prev = _state.scope, _state.splits, _state.override
    (_state.scope, _state.splits), _state.override = scope, override
    try:
        yield
    finally:
        _state.scope, _state.splits, _state.override = prev


@contextlib.contextmanager
def step_scope():
    """Run a step body: its ``key_stream``s draw from the streams' pairs
    (module docstring).  The step starts with ``begin_step()``; a scope
    entered inside another one is that one."""
    if _state.scope is not None:
        yield
        return
    begin_step()
    _state.scope, _state.splits = {}, {}
    try:
        yield
    finally:
        _state.scope = None


def begin_step():
    """A step's start: stale pairs draw their seeds again (stream by
    stream, in order), every member goes to its first member's state and
    no run has started.  While a CUDA graph is being captured only the
    runs start again (a replay starts with this call, and the states
    the graph reads are set then).  Inside a step scope it does nothing,
    as a scope entered there is that one: a step run inside another
    step's body (a ``CapturedStep`` replayed there) is part of it."""
    streams = [s for s in _streams.values() if s.pairs]
    if not streams or _state.scope is not None:
        return
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    for s in streams:
        if not capturing:
            s.pair(len(s.pairs) - 1)
        for pair in s.pairs:
            pair.sync(states=not capturing)


def split_key(stream: str | None = None) -> int:
    """One int64 seed drawn from the active (or the named) stream's key,
    which advances by that one draw; inside ``key_stream``, the next
    seed derived from its base instead.  In a step scope, the n-th call
    before the next ``key_stream`` (in the step, or in this run of the
    enclosing segment) returns seed n derived from the seed of the pair
    that ``key_stream`` takes (drawn once, when the pair is made): the
    same values at every step, which is what a captured graph would
    hold of a host value anyway (module docstring)."""
    o = _state.override
    if isinstance(o, _Override):
        return o.next_seed("key", 1)
    pair = _next_pair(take=False, stream=stream)
    if pair is not None:
        calls = o.splits if isinstance(o, _PairOverride) else _state.splits
        n = calls.get(id(pair), 0)
        calls[id(pair)] = n + 1
        return _mix(pair.seed, n)
    return _stream(stream or _state.active).draw()


def current_key(stream: str = "default") -> torch.Tensor:
    """The state of ``stream``'s key (what ``split_key`` draws from);
    ``KeyError`` for a name never seeded or drawn from."""
    if stream != "default" and stream not in _streams:
        raise KeyError(f"rng stream {stream!r} not registered")
    return _stream(stream).key.get_state()


def generator(device) -> torch.Generator:
    """The active stream's generator of ``device``, made on first use;
    inside ``key_stream``, a fresh generator derived from its base."""
    key = _key(device)
    override = _state.override
    if override is None:
        return _stream(_state.active).generator(key)
    if isinstance(override, _PairOverride):
        return override.pair.member(key, override.member)
    if _capturing(key):
        raise RuntimeError(
            "key_stream (recompute) outside a step scope draws from a "
            "fresh generator, which a CUDA graph being captured cannot "
            "register: capture the step inside step_scope() (hapi's "
            "train_batch and CapturedStep do), or run recompute eagerly")
    return torch.Generator(device=key).manual_seed(
        override.next_seed(key, 0))


def generators(device):
    """Every stream's generator and every pair's members made so far on
    ``device``."""
    key = _key(device)
    out = [s.gens[key] for s in _streams.values() if key in s.gens]
    for s in _streams.values():
        for pair in s.pairs:
            out += pair.generators(key)
    return out


def get_rng_state():
    """``{stream: {"key": state, "seed": seed, device: state, ...}}`` of
    every stream (the default one made if it was not); a stream with
    step-scope pairs adds ``"pairs": {k: {"seed": seed, device: the
    first member's state, "children": {...}}}`` (stale ones left out)."""
    _stream("default")
    out = {}
    for name, s in _streams.items():
        st = {"key": s.key.get_state()}
        if s.seed is not None:
            st["seed"] = torch.tensor(s.seed, dtype=torch.int64)
        st.update((dev, gen.get_state()) for dev, gen in s.gens.items())
        pairs = {str(k): p.state() for k, p in enumerate(s.pairs)
                 if not p.stale}
        if pairs:
            st["pairs"] = pairs
        out[name] = st
    return out


def set_rng_state(snapshot):
    """Restore a :func:`get_rng_state` snapshot, in place (a device
    generator made since starts again from its stream's seed; a pair
    absent from the snapshot is stale).  A snapshot without pairs, and
    one of the form ``{device: state}`` (the default stream's generators
    alone), still load."""
    if snapshot and all(isinstance(v, torch.Tensor)
                        for v in snapshot.values()):
        snapshot = {"default": snapshot}
    for name, st in snapshot.items():
        s = _stream(name)
        if "seed" in st:
            s.seed = int(st["seed"])
        for k, v in st.items():
            if k == "key":
                s.key.set_state(v)
            elif k not in ("seed", "pairs"):
                s.generator(k).set_state(v)
        for k, gen in s.gens.items():       # made after the snapshot: fresh
            if k not in st:
                gen.manual_seed(_fresh_seed() if s.seed is None else s.seed)
        pairs = st.get("pairs", {})
        while len(s.pairs) < max(map(int, pairs), default=-1) + 1:
            s.pairs.append(_Pair(None))
        for k, pair in enumerate(s.pairs):
            if str(k) in pairs:
                pair.load(pairs[str(k)])
            else:
                pair.stale = True


class RNGStatesTracker:
    """Named RNG streams for tensor-parallel determinism.

    ``add('local_seed', base + tp_rank)`` / ``add('global_seed', base)``;
    ``with tracker.rng_state('local_seed'): dropout(...)`` draws from that
    stream so TP ranks agree (global) or differ (local) deterministically.
    """

    def __init__(self):
        self.seeds = set()

    def add(self, name: str, seed_val: int):
        if seed_val in self.seeds:
            raise ValueError(f"seed {seed_val} already added to tracker")
        self.seeds.add(seed_val)
        seed(seed_val, stream=name)

    def reset(self):
        self.seeds = set()

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name != "default" and name not in _streams:
            raise KeyError(f"rng stream '{name}' not registered in tracker")
        prev = _state.active
        _state.active = name
        try:
            yield
        finally:
            _state.active = prev


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
