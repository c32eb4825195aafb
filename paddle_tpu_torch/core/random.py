"""Random state (the port of ``paddle_tpu/core/random.py``).

One explicit ``torch.Generator`` per device, which the initializers and
dropout draw from.  ``seed(n)`` re-seeds every device's generator with
``n``; until then each is seeded from numpy's global state, as the JAX
package seeds its streams.  The JAX package's named streams and
``RNGStatesTracker`` serve tensor parallelism, which this slice does not
port."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "generator", "get_rng_state", "set_rng_state"]

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
    _generators.clear()
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


def get_rng_state():
    """``{device: generator state}`` of every generator made so far."""
    return {key: gen.get_state() for key, gen in _generators.items()}


def set_rng_state(snapshot):
    for key, state in snapshot.items():
        generator(key).set_state(state)
