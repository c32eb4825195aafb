"""The one general generator of the benchmark's inputs.  A cell's
``traffic`` group (in ``workloads/<cell>.json``) holds only parameters;
everything a run feeds the program is drawn here from ``--seed``.

Training (``kind`` "lm" or "mlm"): each call of ``TrainFeed.next`` draws
a new batch on the device: token ids uniform over ``id_range``; "lm"
labels are the next token (-100 after the last), "mlm" replaces a
``mask_rate`` share of positions by ``mask_id`` and labels only those.
The same seed gives the same sequence of batches, so the reference
draws the program's first batches again.

Serving (``kind`` "chat"): requests come from a fixed table of
``pool`` sizes, the same for every seed.  Each length is a quantile of
its lognormal (``median``, ``sigma``, clipped to ``min``..``max``) at
evenly spaced probabilities, and each system prompt is drawn in the
share its weight gives.  The table is put in one fixed shuffled order;
a seed only starts the cycle through it at another place and draws the
token ids.  So two seeds ask for the same work in nearly the same
sequence (the bursts of long and short requests that set a tail come
alike), and two runs of one seed ask for the same requests.  Request
``k`` (in order of submission) is prompt = system prompt ++ user part,
with ``max_new_tokens`` its output length and greedy decoding with no
stop token.  With ``shared_system_prompt`` false each request's first
``system_len`` tokens are its own.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

_DATA = 0x9E3779B97F4A7C15
#: the seed of the serving tables' one fixed order
_ORDER = 20260419


def data_seed(seed):
    """The seed of the inputs, apart from the weights' ``seed``."""
    return (int(seed) + _DATA) % (1 << 63)


class TrainFeed:
    def __init__(self, traffic, seed, device):
        self.t = traffic
        self.device = device
        self.g = torch.Generator(device=device).manual_seed(data_seed(seed))

    def next(self):
        t = self.t
        lo, hi = t["id_range"]
        shape = (t["batch"], t["seq_len"])
        tokens = torch.randint(lo, hi, shape, generator=self.g,
                               device=self.device)
        if t["kind"] == "lm":
            labels = torch.full_like(tokens, -100)
            labels[:, :-1] = tokens[:, 1:]
            return tokens, labels
        masked = torch.rand(shape, generator=self.g,
                            device=self.device) < t["mask_rate"]
        labels = torch.where(masked, tokens, -100)
        return torch.where(masked, t["mask_id"], tokens), labels

    def take(self, n):
        return [self.next() for _ in range(n)]


def lognormal_table(spec, n):
    """``n`` lengths: the lognormal's quantiles at (i + 1/2) / n, clipped
    and rounded."""
    mu, sd = math.log(spec["median"]), spec["sigma"]
    z = NormalDist()
    return np.array([min(spec["max"], max(spec["min"], round(math.exp(
        mu + sd * z.inv_cdf((i + 0.5) / n))))) for i in range(n)], np.int64)


def share_table(weights, n):
    """``n`` indices, index ``j`` in ``weights[j]``'s share (largest
    remainders)."""
    w = np.asarray(weights, np.float64) / sum(weights)
    counts = np.floor(w * n).astype(np.int64)
    for j in np.argsort(-(w * n - counts))[:n - counts.sum()]:
        counts[j] += 1
    return np.repeat(np.arange(len(w)), counts)


class Requests:
    """Request ``k`` of a serving run: ``(prompt, max_new_tokens)``."""

    def __init__(self, traffic, seed):
        t = self.t = traffic
        n = t["pool"]
        order = np.random.default_rng(_ORDER)
        self.user = order.permutation(lognormal_table(t["user_len"], n))
        self.out = order.permutation(lognormal_table(t["output_len"], n))
        self.system = order.permutation(share_table(t["system_weights"], n))
        rng = np.random.default_rng(data_seed(seed))
        self.start = int(rng.integers(n))
        lo, hi = t["id_range"]
        self.prompts = rng.integers(lo, hi, (len(t["system_weights"]),
                                             t["system_len"]))
        self.seed = data_seed(seed)

    def __call__(self, k):
        t = self.t
        i = (self.start + k) % t["pool"]
        rng = np.random.default_rng((self.seed, k))
        lo, hi = t["id_range"]
        user = rng.integers(lo, hi, int(self.user[i]))
        if t["shared_system_prompt"]:
            head = self.prompts[self.system[i]]
        else:
            head = rng.integers(lo, hi, t["system_len"])
        return np.concatenate([head, user]).tolist(), int(self.out[i])

