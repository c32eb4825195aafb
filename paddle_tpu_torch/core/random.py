"""Random state (the port of ``paddle_tpu/core/random.py``).

One explicit ``torch.Generator`` per device, which the initializers and
dropout draw from.  ``seed(n)`` re-seeds every device's generator with
``n``; until then each is seeded from numpy's global state, as the JAX
package seeds its streams.  A generator keeps its identity for the life
of the process (``seed`` and ``set_rng_state`` write its state in
place), so a CUDA graph that registered it (``_captured.CapturedStep``
registers ``generators(device)`` with every graph) keeps advancing the
one every eager call draws from.
The JAX package's named streams and ``RNGStatesTracker`` serve tensor
parallelism, which this slice does not port."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "generator", "generators", "get_rng_state",
           "set_rng_state"]

_generators: dict[str, torch.Generator] = {}
_seed = [None]


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def seed(value: int):
    """Seed every device's generator (parity: ``paddle.seed``)."""
    _seed[0] = int(value)
    for gen in _generators.values():
        gen.manual_seed(_seed[0])
    return value


def generator(device) -> torch.Generator:
    """The generator of ``device``, made on first use."""
    key = _key(device)
    gen = _generators.get(key)
    if gen is None:
        value = _seed[0]
        if value is None:
            value = int(np.random.randint(0, 2 ** 31 - 1))
        gen = torch.Generator(device=key).manual_seed(value)
        _generators[key] = gen
    return gen


def generators(device):
    """The generators made so far on ``device`` (none, or its one)."""
    gen = _generators.get(_key(device))
    return [] if gen is None else [gen]


def get_rng_state():
    """``{device: generator state}`` of every generator made so far."""
    return {key: gen.get_state() for key, gen in _generators.items()}


def set_rng_state(snapshot):
    for key, state in snapshot.items():
        generator(key).set_state(state)
