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
           "RNGStatesTracker", "get_rng_state_tracker"]

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


class _Stream:
    """One named stream: its seed (None: each generator from numpy), its
    host key generator and its generator of each device."""

    def __init__(self, value=None):
        self.seed = value
        self._key = None
        self.gens: dict[str, torch.Generator] = {}

    def reseed(self, value):
        self.seed, self._key = value, None
        for gen in self.gens.values():
            gen.manual_seed(value)

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


class _RandomState(threading.local):
    # thread-local by design (each thread has its active stream and its
    # key_stream); the streams themselves are the process's
    def __init__(self):
        self.active = "default"
        self.override = None


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


@contextlib.contextmanager
def key_stream(base):
    """Draw everything inside from generators derived from ``base`` (an
    int, e.g. a ``split_key()``), leaving every stream as it is; the
    previous ``key_stream`` comes back on exit."""
    prev = _state.override
    _state.override = _Override(base)
    try:
        yield
    finally:
        _state.override = prev


def split_key(stream: str | None = None) -> int:
    """One int64 seed drawn from the active (or the named) stream's key,
    which advances by that one draw; inside ``key_stream``, the next
    seed derived from its base instead."""
    if _state.override is not None:
        return _state.override.next_seed("key", 1)
    s = _stream(stream or _state.active)
    return int(torch.randint(2 ** 63 - 1, (), generator=s.key))


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
    if key.startswith("cuda") and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "key_stream (recompute) draws from a fresh generator, which a "
            "CUDA graph being captured cannot register: run recompute "
            "eagerly, outside a captured step")
    return torch.Generator(device=key).manual_seed(
        override.next_seed(key, 0))


def generators(device):
    """Every stream's generator made so far on ``device``."""
    key = _key(device)
    return [s.gens[key] for s in _streams.values() if key in s.gens]


def get_rng_state():
    """``{stream: {"key": state, "seed": seed, device: state, ...}}`` of
    every stream (the default one made if it was not)."""
    _stream("default")
    out = {}
    for name, s in _streams.items():
        st = {"key": s.key.get_state()}
        if s.seed is not None:
            st["seed"] = torch.tensor(s.seed, dtype=torch.int64)
        st.update((dev, gen.get_state()) for dev, gen in s.gens.items())
        out[name] = st
    return out


def set_rng_state(snapshot):
    """Restore a :func:`get_rng_state` snapshot, in place (a device
    generator made since starts again from its stream's seed).  A
    snapshot of the form ``{device: state}`` (the default stream's
    generators alone) still loads."""
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
            elif k != "seed":
                s.generator(k).set_state(v)
        for k, gen in s.gens.items():       # made after the snapshot: fresh
            if k not in st:
                gen.manual_seed(_fresh_seed() if s.seed is None else s.seed)


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
