"""The host-actor pipeline runtime (the port of
``paddle_tpu/distributed/fleet_executor.py``, the reference's
``FleetExecutor`` / ``Carrier`` / ``MessageBus``): each process runs one
pipeline stage on its device, and activations and cotangents stream
process to process through the ``TCPStore`` (the message bus).

Where ``HybridEngine``'s pipeline sends activations over the pp process
group, this runtime needs nothing but the store's endpoint: it is the
path for stages that cannot share a process group (the JAX module's
"across slices").  ``PipelineStageExecutor.train_batch`` is fill-drain:
every microbatch forward (each stage's input kept), then every
microbatch backward, the stage run again at its saved input with the
arrived cotangent (``torch.autograd.grad``), and each process applies
its own plain SGD step.

Trust boundary: ``MessageBus`` payloads are pickled and unpickled
verbatim, and ``pickle.loads`` executes arbitrary code from the wire, so
every process that can reach the store's endpoint is fully trusted.  This
is the cluster-trust model of the reference's message bus: the bus is
for rank-to-rank traffic of one job inside a private network, never for
user-facing or cross-tenant transport, and a deployment must fence the
store's port to the job's ranks.  Anything user-facing belongs in the
serving layer, which never unpickles client bytes.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["MessageBus", "PipelineStageExecutor"]


def _flatten(tree):
    """(leaves, structure) of a nested dict / list / tuple of tensors or
    arrays."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for p in parts for l in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([l for p in parts for l in p[0]],
                (type(tree).__name__, None, [p[1] for p in parts]))
    return [tree], None


def _unflatten(leaves, structure):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, kids = s
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        return tuple(vals) if kind == "tuple" else vals

    return build(structure)


class MessageBus:
    """Tagged tensor point-to-point over a ``TCPStore``: ``send(src, dst,
    tag, tree)`` / ``recv(src, dst, tag)`` move trees of tensors (or
    numpy arrays), each message consumed once (the receiver deletes its
    key).  A tensor travels as its bytes, dtype name and shape, bf16 as
    its uint16 bits, and comes back a CPU tensor of its dtype."""

    def __init__(self, store, prefix="mb"):
        self.store = store
        self.prefix = prefix

    def _key(self, src, dst, tag):
        return f"{self.prefix}/{src}->{dst}/{tag}"

    def send(self, src, dst, tag, tree):
        leaves, structure = _flatten(tree)
        packed = []
        for l in leaves:
            t = l.detach().cpu() if isinstance(l, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(l))
            name = str(t.dtype).replace("torch.", "")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.uint16)
            packed.append((t.contiguous().numpy().tobytes(), name,
                           tuple(t.shape)))
        self.store.set(self._key(src, dst, tag), pickle.dumps(
            {"structure": structure, "leaves": packed}, protocol=4))

    def recv(self, src, dst, tag, timeout=60.0):
        key = self._key(src, dst, tag)
        blob = pickle.loads(self.store.get(key, blocking=True,
                                           timeout=timeout))
        leaves = []
        for data, name, shape in blob["leaves"]:
            raw = np.uint16 if name == "bfloat16" else np.dtype(name)
            t = torch.from_numpy(np.frombuffer(data, raw).reshape(shape)
                                 .copy())
            leaves.append(t.view(torch.bfloat16) if name == "bfloat16"
                          else t)
        self.store.delete_key(key)
        return _unflatten(leaves, blob["structure"])


class PipelineStageExecutor:
    """One pipeline stage in this process.  ``stage_fn(params, x) -> y``
    for a stage before the last; the last stage's ``loss_fn(params, x,
    labels) -> scalar`` closes the pipeline.  ``params``: a list of
    tensors on this process's device (made to require grad)."""

    def __init__(self, stage_fn, params, rank, world, bus, *, loss_fn=None,
                 lr=1e-2):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.params = [p.detach().requires_grad_(True) for p in params]
        self.device = self.params[0].device if self.params else \
            torch.device("cpu")
        self.rank, self.world, self.bus = rank, world, bus
        self.lr = lr
        self.is_first = rank == 0
        self.is_last = rank == world - 1
        self._step = 0

    def _run(self, x, label):
        if self.is_last:
            return self.loss_fn(self.params, x, label)
        return self.stage_fn(self.params, x)

    def train_batch(self, microbatches, labels=None, num_microbatches=None):
        """Fill-drain over the microbatches.  The first stage feeds
        ``microbatches``; the last consumes ``labels`` (one a microbatch)
        and returns the mean loss (other ranks return None).  A middle
        stage of three or more passes ``num_microbatches`` (the schedule
        is static config, not wire traffic)."""
        if microbatches is not None:
            M = len(microbatches)
        elif labels is not None:
            M = len(labels)
        elif num_microbatches:
            M = int(num_microbatches)
        else:
            raise ValueError("a middle stage needs num_microbatches= (it "
                             "receives neither microbatches nor labels)")
        t = self._step
        self._step += 1
        saved = []
        # ---- forward: each microbatch run and shipped, its input kept
        for m in range(M):
            if self.is_first:
                x = torch.as_tensor(np.asarray(microbatches[m])) if not \
                    isinstance(microbatches[m], torch.Tensor) else \
                    microbatches[m]
            else:
                x = self.bus.recv(self.rank - 1, self.rank, f"fwd/{t}/{m}")
            x = x.to(self.device)
            saved.append(x)
            if not self.is_last:
                with torch.no_grad():
                    y = self.stage_fn(self.params, x)
                self.bus.send(self.rank, self.rank + 1, f"fwd/{t}/{m}", y)

        # ---- backward: the stage again at its saved input
        grads = [torch.zeros_like(p) for p in self.params]
        losses = []
        for m in range(M):
            x = saved[m].detach().requires_grad_(
                not self.is_first and saved[m].is_floating_point())
            label = None
            if self.is_last:
                label = labels[m]
                label = (label if isinstance(label, torch.Tensor) else
                         torch.as_tensor(np.asarray(label))).to(self.device)
                out = self._run(x, label)
                losses.append(float(out))
                ct = torch.full_like(out, 1.0 / M)
            else:
                out = self._run(x, None)
                ct = self.bus.recv(self.rank + 1, self.rank,
                                   f"bwd/{t}/{m}").to(self.device)
            ins = self.params + ([x] if x.requires_grad else [])
            gs = torch.autograd.grad([out], ins, [ct], allow_unused=True)
            for acc, g in zip(grads, gs[:len(self.params)]):
                if g is not None:
                    acc.add_(g)
            if not self.is_first:
                self.bus.send(self.rank, self.rank - 1, f"bwd/{t}/{m}",
                              gs[-1])
        # ---- this stage's own SGD step
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.sub_(self.lr * g)
        return float(np.mean(losses)) if self.is_last else None
