"""Pipeline-parallel user API (the port of
``paddle_tpu/distributed/pp_layers.py``): ``LayerDesc`` /
``SharedLayerDesc`` / ``SegmentLayers`` / ``PipelineLayer`` and a
``PipelineEngine`` that trains a layer list in stages, one process a
stage.

Where the JAX engine packs every stage's parameters into one flat
``[pp, Pmax]`` buffer and dispatches with ``lax.switch`` (one SPMD
program must run everywhere), each rank here builds and runs ONLY its own
stage's layers, as the reference's ``PipelineLayer`` does
(``pp_layers.py:159`` there):

- ``PipelineLayer(..., stage=i)`` (or a ``topology`` naming the stage)
  builds the descs of stage i alone; without a stage it builds them all
  and is a plain sequential layer on one device.  ``seg_method
  ="parameter"`` builds each desc once (one at a time) to count its
  parameters before the stage's own are built.
- A ``SharedLayerDesc`` layer (tied weights) is built on every stage and
  kept equal: the engine broadcasts it from stage 0 at start, and sums
  its gradient over the stages (the reference's
  ``allreduce_shared_weight_gradients``).
- Activation shapes at stage boundaries are sent ahead once per input
  shape (the reference's ``SendRecvMeta``): stage i receives its input's
  shape and dtype, runs its layers once on zeros of that shape without a
  graph, and sends its output's on.
- ``train_batch`` is fill-drain (GPipe, ``engine.gpipe``, the loop
  ``HybridEngine`` runs too): ``num_microbatches + pp - 1`` forward
  ticks, each stage's graph kept, then the reverse ticks with each
  stage's input gradient sent back; the loss is the mean of the
  microbatches' losses; each rank takes its own plain SGD step.

Activations go over the pp group through ``collective``'s
point-to-point messages (one ``batch_isend_irecv`` a tick), so each hop
is counted under the pp axis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layer.layers import Layer
from . import collective
from .engine import gpipe

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineEngine"]


class LayerDesc:
    """A layer's constructor and arguments, built on the stage that runs
    it (reference ``pp_layers.py:58``)."""

    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, torch.nn.Module)):
            raise TypeError(f"{layer_cls} must be a paddle_tpu_torch.nn."
                            f"Layer (a torch.nn.Module)")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A ``LayerDesc`` whose layer is shared with every other desc of the
    same ``key`` (tied weights); ``forward_func(layer, x)`` replaces the
    call where it is reused in another role."""

    def __init__(self, key, layer_cls, *args, forward_func=None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func


def _param_count(layer):
    return sum(int(np.prod(p.shape)) for _, p in layer.named_parameters())


class SegmentLayers:
    """Contiguous stage bounds for N layers (reference
    ``pp_layers.py:90``): ``"uniform"`` balances the layer count,
    ``"parameter"`` the parameter count (a desc is built to count it)."""

    def __init__(self, layers, num_parts, method="uniform"):
        if num_parts < 1:
            raise ValueError("num_parts must be >= 1")
        if len(layers) < num_parts:
            raise ValueError("need at least one layer per stage")
        self.layers = layers
        self.num_parts = num_parts
        self.method = method

    def _weights(self):
        if self.method == "uniform":
            return [1] * len(self.layers)
        if self.method not in ("parameter", "param"):
            raise ValueError(f"unknown seg_method {self.method}")
        out = []
        for l in self.layers:
            if isinstance(l, LayerDesc):
                l = l.build_layer()
            out.append(_param_count(l) or 1)
        return out

    def do_segment(self):
        n = len(self.layers)
        weights = self._weights()
        # greedy prefix split minimizing the max-stage weight
        total = sum(weights)
        bounds = [0]
        acc = 0
        target = total / self.num_parts
        for i, w in enumerate(weights):
            acc += w
            if (acc >= target * len(bounds)
                    and len(bounds) < self.num_parts
                    and n - (i + 1) >= self.num_parts - len(bounds)):
                bounds.append(i + 1)
        while len(bounds) < self.num_parts:
            bounds.append(n - (self.num_parts - len(bounds)))
        bounds.append(n)
        return bounds


class PipelineLayer(Layer):
    """The user-facing container (reference ``pp_layers.py:159``).

    ``layers``: ``Layer`` / ``LayerDesc`` / ``SharedLayerDesc`` items.
    ``stage``: the stage this rank builds (None: every stage, a plain
    sequential layer); a ``topology`` (``HybridCommunicateGroup``) gives
    both the stage count and this rank's stage.  ``run_funcs`` holds the
    built layers, None where another stage's layer was not built."""

    def __init__(self, layers, num_stages=2, loss_fn=None,
                 seg_method="uniform", topology=None, stage=None):
        super().__init__()
        if topology is not None:
            if hasattr(topology, "get_stage_id"):
                num_stages = topology.get_pipe_parallel_world_size()
                stage = topology.get_stage_id()
            else:
                num_stages = topology.get_dim("pipe")
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.stage = stage
        descs = list(layers)
        self._bounds = SegmentLayers(descs, num_stages,
                                     seg_method).do_segment()
        lo, hi = (0, len(descs)) if stage is None else \
            (self._bounds[stage], self._bounds[stage + 1])
        self._shared = {}          # key -> built Layer
        self._forward_funcs = []
        built = []
        for pos, d in enumerate(descs):
            if isinstance(d, SharedLayerDesc):
                # built on every stage (kept equal by the engine)
                if d.key not in self._shared:
                    self._shared[d.key] = d.build_layer()
                built.append(self._shared[d.key])
                self._forward_funcs.append(d.forward_func)
                continue
            self._forward_funcs.append(None)
            if not lo <= pos < hi:
                built.append(None)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, torch.nn.Module):
                built.append(d)
            else:
                raise TypeError(f"cannot stage {type(d)}")
        self.run_funcs = built
        for i, l in enumerate(built):
            if l is not None:
                setattr(self, f"_seg{i}", l)   # register as sublayer

        # one index per unique layer (shared layers appear once), the
        # logical per-layer list's order
        seen, self._index = {}, []
        for pos, layer in enumerate(built):
            key = id(layer) if layer is not None else ("absent", pos)
            if key not in seen:
                seen[key] = len(seen)
            self._index.append(seen[key])

    def _unique(self):
        """(unique index, layer) of every layer this rank holds."""
        out, seen = [], set()
        for layer, idx in zip(self.run_funcs, self._index):
            if layer is None or idx in seen:
                continue
            seen.add(idx)
            out.append((idx, layer))
        return out

    def state(self):
        """The logical per-layer list: ``{name: tensor}`` (a detached
        copy) for each unique layer this rank holds, ``{}`` for the
        others; a shared layer appears once, so tied weights stay
        tied."""
        out = [{} for _ in range(max(self._index) + 1)]
        for idx, layer in self._unique():
            out[idx] = {k: v.detach().clone()
                        for k, v in layer.named_parameters()}
        return out

    @torch.no_grad()
    def load_state(self, state):
        """Load the entries of a logical per-layer list (this rank's or a
        whole one, e.g. a one-device run's ``state()``, tensors or numpy
        arrays) into the layers this rank holds."""
        for idx, layer in self._unique():
            named = dict(layer.named_parameters())
            for name, arr in state[idx].items():
                named[name].copy_(_as_tensor(arr, named[name].device))

    def segment_bounds(self):
        return list(self._bounds)

    def stage_layers(self, stage):
        lo, hi = self._bounds[stage], self._bounds[stage + 1]
        return list(zip(self.run_funcs[lo:hi], self._forward_funcs[lo:hi]))

    def run_stage(self, stage, x):
        for layer, ff in self.stage_layers(stage):
            x = ff(layer, x) if ff is not None else layer(x)
        return x

    def forward(self, x):
        if self.stage is not None:
            raise RuntimeError(
                f"this PipelineLayer holds stage {self.stage} only: train "
                f"it through PipelineEngine")
        for layer, ff in zip(self.run_funcs, self._forward_funcs):
            x = ff(layer, x) if ff is not None else layer(x)
        return x


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


class PipelineEngine:
    """Trains a ``PipelineLayer`` over the pp group, one stage a rank.

    ``group``: the pp group (``collective.Group``; default: the world, or
    one stage without one); the layer must have been built for this
    rank's stage (``stage=`` or ``topology=``), or hold every stage when
    ``num_stages == 1``.  ``optimizer``: ``"sgd"`` only, as in JAX.  Runs
    on the device of the stage's parameters (a stage without any: the
    place of ``set_device``)."""

    def __init__(self, pipeline: PipelineLayer, num_microbatches=2,
                 lr=1e-3, optimizer="sgd", group=None, device=None,
                 sample_input=None):
        if optimizer != "sgd":
            raise NotImplementedError(
                f"PipelineEngine supports optimizer='sgd' only (got "
                f"{optimizer!r}); for Adam-class training use HybridEngine")
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        self.pl = pipeline
        self.pp = pipeline.num_stages
        self.num_micro = num_microbatches
        self.lr = lr
        self.optimizer = optimizer
        self.group = group if group is not None else \
            collective.world_group()
        if self.pp > 1 and self.group.nranks != self.pp:
            raise ValueError(
                f"a {self.pp}-stage pipeline needs a pp group of {self.pp} "
                f"ranks, got {self.group.nranks} (launch one process a "
                f"stage and call init_parallel_env)")
        self.stage = self.group.rank if self.pp > 1 else 0
        if self.pp > 1 and pipeline.stage != self.stage:
            raise ValueError(
                f"rank {self.stage} of the pp group holds a PipelineLayer "
                f"built for stage {pipeline.stage}")
        params = [p for l in pipeline.run_funcs if l is not None
                  for p in l.parameters()]
        if device is None:
            from ..core.place import current_device

            device = params[0].device if params else current_device()
        self.device = torch.device(device)
        self._shared_keys = sorted(pipeline._shared)
        self._shapes = {}
        self._sync_shared()
        if sample_input is not None:
            x = _as_tensor(sample_input, self.device)
            self._boundary_meta(tuple(x.shape), x.dtype)

    # --------------------------------------------------------- parameters
    def _shared_params(self):
        return [p for k in self._shared_keys
                for p in self.pl._shared[k].parameters()]

    @torch.no_grad()
    def _sync_shared(self):
        """Every stage's copy of each shared layer set to stage 0's."""
        if self.pp == 1:
            return
        for p in self._shared_params():
            collective.broadcast(p.data, src=0, group=self.group)

    def state(self):
        """This rank's logical per-layer list (``PipelineLayer.state``)."""
        return self.pl.state()

    def load_state(self, state):
        self.pl.load_state(state)

    # ------------------------------------------------------------ shapes
    def _boundary_meta(self, in_shape, in_dtype):
        """``((shape, dtype) entering this stage, (shape, dtype) leaving
        it)`` for a batch of ``in_shape`` (its first dim the batch, cut
        into microbatches): sent ahead once a shape, stage to stage
        (SendRecvMeta)."""
        key = (in_shape, in_dtype)
        if key in self._shapes:
            return self._shapes[key]
        mb = in_shape[0] // self.num_micro
        meta = torch.zeros(8, dtype=torch.int64, device=self.device)
        if self.stage == 0:
            shape, dtype = (mb,) + tuple(in_shape[1:]), in_dtype
        else:
            collective.recv(meta, src=self.stage - 1, group=self.group)
            shape = tuple(int(n) for n in meta[1:1 + int(meta[0])])
            dtype = _DTYPES[int(meta[7])]
        out = None
        if self.stage < self.pp - 1:
            with torch.no_grad():
                y = self.pl.run_stage(self.stage, torch.zeros(
                    shape, dtype=dtype, device=self.device))
            out = (tuple(y.shape), y.dtype)
            meta.zero_()
            meta[0] = y.dim()
            meta[1:1 + y.dim()] = torch.tensor(y.shape, device=self.device)
            meta[7] = _DTYPES.index(y.dtype)
            collective.send(meta, dst=self.stage + 1, group=self.group)
        self._shapes[key] = ((shape, dtype), out)
        return self._shapes[key]

    # -------------------------------------------------------------- step
    def train_batch(self, data, labels, state=None, lr=None):
        """One pipeline-parallel SGD step; returns ``(state, loss)``
        (``state()``'s list; the loss the mean of the microbatches',
        on every rank).  ``state``: a logical per-layer list to load
        first (None: the live layers)."""
        if self.pl.loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn to train")
        if state is not None:
            self.load_state(state)
        lr = self.lr if lr is None else lr
        pp, M, i = self.pp, self.num_micro, self.stage
        first, last = i == 0, i == pp - 1
        x_all = _as_tensor(data, self.device)
        y_all = _as_tensor(labels, self.device)
        if x_all.shape[0] % M:
            raise ValueError(f"batch {x_all.shape[0]} must divide "
                             f"num_microbatches {M}")
        mb = x_all.shape[0] // M
        in_meta, out_meta = self._boundary_meta(tuple(x_all.shape),
                                                x_all.dtype)
        own = [p for _, l in self.pl._unique() for p in l.parameters()]
        grads = [torch.zeros_like(p) for p in own]
        loss = torch.zeros((), dtype=torch.float32, device=self.device)

        def forward(m, inbox):
            nonlocal loss
            x = x_all[m * mb:(m + 1) * mb] if first else inbox
            x = x.detach().requires_grad_(
                not first and x.is_floating_point())
            y = self.pl.run_stage(i, x)
            if last:
                y = self.pl.loss_fn(y, y_all[m * mb:(m + 1) * mb]) / M
                loss = loss + y.detach().float()
            return (x, y), y

        def backward(m, saved, ct):
            x, y = saved
            gs = torch.autograd.grad(
                [y], own + ([x] if not first else []),
                [torch.ones_like(y) if last else ct], allow_unused=True)
            for acc, g in zip(grads, gs[:len(own)]):
                if g is not None:
                    acc.add_(g)
            return None if first else gs[-1]

        gpipe(self.group, i, pp, M, forward, backward, in_meta, out_meta,
              self.device)
        with torch.no_grad():
            if pp > 1:
                shared = {id(p) for p in self._shared_params()}
                for p, g in zip(own, grads):
                    if id(p) in shared:
                        collective.all_reduce(g, group=self.group)
                collective.all_reduce(loss, group=self.group)
            for p, g in zip(own, grads):
                p.sub_(lr * g)
        return self.state(), loss


_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
