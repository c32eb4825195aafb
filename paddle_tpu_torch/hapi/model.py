"""hapi ``Model`` (the port of ``paddle_tpu/hapi/model.py``): ``prepare``,
``train_batch``/``eval_batch``/``predict_batch``, ``fit``/``evaluate``/
``predict``, ``save``/``load`` and ``summary``.

``train_batch`` is the JAX package's jitted step: forward, loss,
``torch.autograd.grad`` over every named parameter, then the optimizer's
update with the same math (clip, coupled decay, the rule; no
per-parameter learning rate, as in JAX's jitted path); batch norm
updates its running statistics in place during the forward.
``eval_batch`` and ``predict_batch`` run the network in whatever mode it
is in and, as JAX's pure eval step does, keep no buffer update.

``train_batch`` and ``eval_batch`` are the port's ``watch(jax.jit(...),
name="hapi::train_step" / "hapi::eval_step")``, each under
``RecordEvent`` of its name: on CUDA each runs its body eagerly on the
first call, captures it then as a CUDA graph (``_captured.CapturedStep``)
and replays it on later calls.  The batch goes through static device
buffers (pinned host copies); the learning rate (``opt.get_lr()``, so a
scheduler keeps working) and the step are written into 0-d device
scalars before each call (``self._lr``, ``self._step``); the
port's generators of the device are registered with each graph, the
pairs that ``recompute`` and ``key_stream`` draw from in the step
scope ``CapturedStep`` runs the bodies in among them (``core.random``;
a caller that runs a body directly enters ``step_scope()`` itself, as
``chip_smoke.py``'s eager route does), so a network that recomputes
its blocks with dropout trains inside the graph with fresh masks each
step, as on the eager route; the grad norm is computed in the graph
and read after it; metrics and the loss's host read run after the
replay, as in JAX.  A batch of
another shape (``fit``'s tail batch), replaced parameters, slots or
buffers, another train/eval mode, autocast setting or TF32 flag capture
again (the old graph's pool freed first); the watchdog reports a new
batch shape as a rebuild naming the argument.  ``prepare`` drops both
steps and builds them anew, as JAX drops its jitted steps there, so a new
loss or optimizer is captured on the next call.  On the CPU the same
bodies run eagerly through the same watched calls.

``save``/``load`` use the JAX package's format, so a checkpoint saved by
either package loads in the other: ``path.pdparams`` is a pickled
``{"params": {name: array}, "buffers": {name: array}}`` of numpy arrays
(bf16 tensors as fp32), ``path.pdopt`` the ``{"step", "slots": {name:
{slot: array}}}`` tree of ``train_batch``'s optimizer state.  Both writes
are atomic.

``fit(resume_from=dir)`` restores the newest intact checkpoint a
``CheckpointCallback`` wrote (in place, so the captured step keeps
replaying) and fast-forwards to its (epoch, step).  A ``HealthMonitor``
with ``action="rollback"`` makes ``fit`` restore the last good checkpoint
and skip the poisoned data window (``_execute_rollback``), or, for the
integrity sentinel's ``param_divergence``, rewind and replay the same
batches (``_finish_rewind_rollback``).  ``replay_train_batch`` re-runs a
step from a snapshot through the same captured graph and puts the live
state back, so nothing on the model changes.  Fault sites:
``hapi.step_params`` (the post-step parameters, bit-flipped in place)
and ``hapi.train_step`` (after each step's callbacks).

``prepare(device_mesh=, sharding_rules=)`` trains over a world of
ranks, one process a rank (the JAX package's GSPMD ``prepare``):
``"auto"`` is dp over the whole world; a ``distributed.mesh.Mesh`` may
hold dp, mp and sharding axes.  Each rank trains on its dp rows of the
batch (trimmed to a dp multiple, or padded with its last row when
smaller, as JAX does); the gradients are averaged over dp
(``parallel.reduce_grads``).  A parameter's spec comes from the rule
table (``mesh.param_specs``, ``sharding_rules`` first).

A step holds every parameter in that layout, as the JAX step's
``in_shardings`` do: a weight the specs split over mp stays this rank's
mp window for the whole step, is multiplied as it is and gets its
window's gradient; a parameter no spec splits is whole.  Only the
``nn.Linear`` weights may be split over mp, as Megatron's pairs
(``mp_layers``): a column split (``P(None, "mp")``) multiplies the input
copied to the mp group by its columns and all-gathers the output, a row
split (``P("mp", None)``) multiplies this rank's slice of the input by
its rows and all-reduces; the bias is replicated and added to the whole
output; any other parameter split over mp is refused.  Autograd then
gives each window its complete gradient: nothing is all-reduced over
mp but the pairs' activations and the norms below, and no gradient is
whole-sized.

What a rank owns between steps is a window of each parameter: its spec
plus the ZeRO split of ``mesh.zero_opt_specs`` (the sharding axis on one
free dim).  Each parameter's ``.data`` is that window, the same storage
from one step to the next (``param_bytes()`` is what a rank holds), and
its optimizer slots are the same window.  A step all-gathers the
sharding split only, up to the spec's layout (as GSPMD, where the
sharding axis divides the slots alone).  The update runs on the
windows: the gradients averaged over dp, then the clip
(``clip_windows``: a norm counts each window's squared sum once over its
mp group), coupled decay and the rule on this rank's window, written
into the held storage (Lamb's trust ratio takes the whole parameter's
and update's norms, ``Optimizer._apply_windows``).  The parameters stay
bitwise equal across their replicas and equal to one device's on the
whole batch (batch norm normalizes over each rank's rows).

``eval_batch`` runs each rank's dp rows in the same layout, averages the
loss over dp and gathers the outputs and labels over dp for the metrics,
as ``train_batch`` does; ``predict_batch`` runs the whole batch on every
rank (the JAX ``predict_batch`` does not split its input), in the same
layout.  Both are collectives: every rank calls them.
``whole_parameters()`` gathers every parameter whole for a reader (a
``state_dict``, a comparison); ``save``, ``load``, the fit checkpoints
and the integrity sentinel's unsharded fingerprint read and write the
whole parameters and optimizer slots, gathered (a collective: every
rank of the world calls them, as ``fit``'s callbacks do, and every rank
writes the same bytes).  The world's steps run eagerly (a host-side
transport cannot sit inside a CUDA graph).  ``shard_views`` names each
rank's window (``integrity.shard_fingerprint``, checkpoints)."""
from __future__ import annotations

import contextlib
import os
import pickle
import weakref

import numpy as np
import torch

from .._captured import CapturedStep, StaticInputs, storage_tag
from ..amp.auto_cast import amp_state
from ..core.place import current_device
from ..io.dataloader import DataLoader
from ..models.convert import _to_numpy, opt_state_from_jax
from ..observability.compile_watchdog import watch
from ..optimizer.optimizer import device_scalar
from ..profiler.profiler import RecordEvent
from ..resilience.atomic import atomic_write
from ..resilience.faults import current_injector, fault_point
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _copy_all(dst, src):
    """``d.copy_(s)`` for each pair, as multi-tensor launches."""
    if dst:
        torch._foreach_copy_(dst, src)


class Model:
    """High-level facade over a ``Layer``.  Batches go to the device of
    ``set_device`` (CUDA unless the caller chose the CPU)."""

    def __init__(self, network, inputs=None, labels=None):
        self.device = current_device()
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._opt_state = None        # train_batch's optimizer state
        self._watch_grad_norm = False
        self._rollback_request = None   # set by HealthMonitor(rollback)
        self._stash_batch = False       # IntegrityCallback replay feed
        self._last_batch = None
        self._resume_info = None
        self._mesh, self._extra_rules, self._plan = None, (), None
        self._held, self._shapes = False, {}
        self._tp = {}
        # the static inputs of the watched steps; the learning rate and
        # the step as device scalars
        dev = self.device
        self._train_in, self._eval_in = StaticInputs(dev), StaticInputs(dev)
        self._lr = device_scalar(0.0, dev)
        self._step = device_scalar(0, dev)
        self._train_fn = self._eval_fn = None
        self._build_steps()

    def _build_steps(self):
        """The watched steps (one capture per input signature, CUDA),
        new ones: JAX's ``_jit_step``/``_jit_eval`` set to None.  The old
        graphs are released first, so their pools are freed."""
        for fn in (self._train_fn, self._eval_fn):
            if fn is not None:
                fn.release()
        dev = self.device
        train = weakref.WeakMethod(self._train_body)
        ev = weakref.WeakMethod(self._eval_body)
        self._train_fn = watch(
            CapturedStep(lambda *a: train()(*a), dev, empty_cache=True),
            name="hapi::train_step")
        self._eval_fn = watch(
            CapturedStep(lambda *a: ev()(*a), dev, empty_cache=True),
            name="hapi::eval_step")

    @property
    def captures(self):
        """CUDA graphs captured so far: ``{"train": n, "eval": n}``."""
        return {"train": self._train_fn.captures,
                "eval": self._eval_fn.captures}

    def enable_grad_norm_logging(self):
        """Make ``train_batch`` report the global gradient norm
        (``logs["grad_norm"]``); one extra reduction and host read."""
        self._watch_grad_norm = True
        return self

    def prepare(self, optimizer=None, loss=None, metrics=None,
                device_mesh=None, sharding_rules=()):
        """``device_mesh``: None (this device), ``"auto"`` (dp over the
        world) or a ``distributed.mesh.Mesh`` with dp / mp / sharding
        axes; ``sharding_rules``: ``(regex, PartitionSpec)`` pairs
        consulted before the GPT rule table (see the module
        docstring)."""
        self._unhold()      # whole again before a new plan
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        if device_mesh == "auto":
            from ..distributed import mesh as mesh_mod
            from ..distributed.env import get_world_size

            device_mesh = mesh_mod.build_mesh(dp=get_world_size())
        self._mesh = device_mesh
        self._extra_rules = tuple(sharding_rules)
        self._plan = None
        self._build_steps()
        return self

    def _tensor(self, x):
        x = _to_list(x)[0]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        return x.to(self.device, non_blocking=True)

    # ------------------------------------------------- train / eval batch
    def _static(self):
        """What a captured step depends on beside its tensors' storage:
        each module's train/eval mode, autocast and the TF32 flags."""
        return (tuple(m.training for m in self.network.modules()),
                amp_state(), torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    def _train_state(self):
        """The optimizer state of ``train_batch``, made on first use."""
        if self._opt_state is None:
            self._opt_state = self._optimizer.init_state(
                dict(self.network.named_parameters()))
        return self._opt_state

    def _train_call(self, inputs, labels, lr):
        """The watched train step on one batch at ``lr``: ``(loss,
        output, grad norm or None, labels)``; the step count advances."""
        if self._mesh is not None:
            return self._mesh_train(inputs, labels, lr)
        params = dict(self.network.named_parameters())
        st = self._train_state()
        x, y = self._train_in(_to_list(inputs)[0], _to_list(labels)[0])
        self._step.fill_(st["step"] + 1)
        self._lr.fill_(lr)
        args = (x, y, params, st["slots"], self._lr, self._step,
                self._watch_grad_norm)
        with RecordEvent("hapi::train_step"):
            loss, out, gnorm = self._run_train(args)
        st["step"] += 1
        return loss, out, gnorm, y

    def train_batch(self, inputs, labels):
        """One optimization step; returns ``(loss, metric results)``."""
        loss, out, gnorm, y = self._train_call(inputs, labels,
                                               self._optimizer.get_lr())
        if current_injector() is not None:
            self._expose_params_fault_site()
        results = self._update_metrics(out, y)
        if gnorm is not None:
            results["grad_norm"] = float(gnorm)
        return float(loss), results

    def _expose_params_fault_site(self):
        """The silent-data-corruption injection point: with a fault
        injector installed, the post-step parameters pass through the
        ``hapi.step_params`` site as a ``{name: tensor}`` dict, whose
        ``bitflip`` flips one bit of a live parameter in place."""
        fault_point("hapi.step_params", tree={
            k: p.detach() for k, p in self.network.named_parameters()})

    def _state(self):
        """``(names, live)``: (parameter names, buffer names, (slot, name)
        pairs), and the live tensors a train step reads and writes in
        that order (one module walk)."""
        net, st = self.network, self._train_state()
        params, buffers = list(net.named_parameters()), list(
            net.named_buffers())
        slots = [((k, n), t) for k, s in st["slots"].items()
                 for n, t in s.items()]
        names = ([k for k, _ in params], [k for k, _ in buffers],
                 [kn for kn, _ in slots])
        return names, ([p for _, p in params] + [b for _, b in buffers]
                       + [t for _, t in slots])

    @staticmethod
    def _snapshot_list(snap, names):
        """A snapshot's tensors in the order of :meth:`_state`."""
        pn, bn, sn = names
        return ([snap["params"][k] for k in pn]
                + [snap["buffers"][k] for k in bn]
                + [snap["opt_state"]["slots"][k][n] for k, n in sn])

    def train_state_snapshot(self, into=None, _state=None):
        """A deep copy of what a train step reads and writes: params,
        buffers, the optimizer state, every random stream's state and
        the learning rate (the integrity sentinel's pre-step snapshot).
        ``into`` (an earlier snapshot of this model) is overwritten and
        returned instead of allocating a new one.  The copies are a few
        multi-tensor launches (``torch._foreach_copy_``), not one a
        tensor."""
        from ..core.random import get_rng_state

        names, live = _state or self._state()
        if into is None:
            pn, bn, sn = names
            it = iter(torch.empty_like(t) for t in live)
            into = {"params": {k: next(it) for k in pn},
                    "buffers": {k: next(it) for k in bn},
                    "opt_state": {"slots": {}}}
            for k, n in sn:
                into["opt_state"]["slots"].setdefault(k, {})[n] = next(it)
        with torch.no_grad():
            _copy_all(self._snapshot_list(into, names), live)
        into["opt_state"]["step"] = self._train_state()["step"]
        into["rng"] = get_rng_state()         # fresh state tensors
        into["lr"] = float(self._optimizer.get_lr())
        return into

    @torch.no_grad()
    def _load_train_state(self, snap, _state=None):
        """Copy a :meth:`train_state_snapshot` into the live tensors."""
        from ..core.random import set_rng_state

        names, live = _state or self._state()
        _copy_all(live, self._snapshot_list(snap, names))
        self._train_state()["step"] = snap["opt_state"]["step"]
        set_rng_state(snap["rng"])

    def replay_train_batch(self, snapshot, batch):
        """Re-execute one train step from a pre-step ``snapshot`` (see
        :meth:`train_state_snapshot`) on ``batch``; returns ``(loss,
        {name: parameter after the step})`` for a bitwise comparison with
        the live step.  The step writes in place, so the replay keeps a
        copy of the live state, loads the snapshot into the tensors the
        captured graph reads, replays the graph, and loads the live state
        back: nothing on the model changes (the JAX step is pure and
        mutates nothing).  Metrics are not updated.  The live copy and
        the returned parameters are buffers the model reuses from one
        replay to the next: the returned dict holds until the next
        replay.  The state is walked once a call (a module walk costs
        more than the copies of a small model)."""
        state = self._state()
        names, live = state
        self._replay_live = self.train_state_snapshot(
            into=getattr(self, "_replay_live", None), _state=state)
        self._load_train_state(snapshot, state)
        try:
            loss, _, _, _ = self._train_call(*batch, snapshot["lr"])
            loss = float(loss)
            params = live[:len(names[0])]
            after = getattr(self, "_replay_params", None)
            if after is None or list(after) != names[0]:
                after = {k: torch.empty_like(p)
                         for k, p in zip(names[0], params)}
                self._replay_params = after
            with torch.no_grad():
                _copy_all(list(after.values()), params)
        finally:
            self._load_train_state(self._replay_live, state)
        return loss, after

    def _run_train(self, args):
        """The watched train step (the graph's replay on CUDA)."""
        x, y, params, slots, lr, step, _ = args
        tensors = [x, y, lr, step, *params.values(),
                   *self.network.buffers()]
        tensors += [t for s in slots.values() for t in s.values()]
        tag = storage_tag(tensors, self._static(), tuple(
            p.requires_grad for p in params.values()), args[-1])
        return self._train_fn(*args, storage=tag)

    def _train_body(self, x, y, params, slots, lr, step, log_gnorm):
        """Forward, grads and the update (``apply_gradients_``, in
        place): the captured train step.  Returns the loss, the output
        and (with ``log_gnorm``) the global gradient norm, all on the
        device.  ``CapturedStep`` runs it in a step scope:
        ``recompute`` and ``key_stream`` inside draw from the streams'
        generator pairs."""
        out = self.network(x)
        loss = self._loss(out, y)
        live = [k for k, p in params.items() if p.requires_grad]
        got = torch.autograd.grad(loss, [params[k] for k in live],
                                  allow_unused=True)
        # a parameter the loss does not reach has a zero gradient (JAX's
        # value_and_grad), so decay still applies to it; a frozen one
        # (trainable=False) is left as it is
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(live, got)}
        gnorm = None
        if log_gnorm:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
        self._optimizer.apply_gradients_(params, grads, slots, lr, step)
        return loss.detach(), out.detach(), gnorm

    @contextlib.contextmanager
    def _buffers_kept(self):
        """Run the network without keeping its buffer updates."""
        net = self.network
        if not any(m.training for m in net.modules()):
            yield
            return
        saved = {k: b.clone() for k, b in net.named_buffers()}
        try:
            yield
        finally:
            with torch.no_grad():
                for k, b in net.named_buffers():
                    b.copy_(saved[k])

    # ------------------------------------------------ a world of ranks
    def _mesh_plan(self):
        """``{name: (param spec, window spec)}`` for the network's
        parameters under the mesh: the rule table's spec, and that spec
        plus the ZeRO split of the optimizer slots (the window this rank
        updates).  Also finds the ``nn.Linear`` layers the mp axis splits
        (``self._tp``).  Built at the first step, once."""
        if self._plan is None:
            from ..distributed import mesh as mesh_mod

            params = dict(self.network.named_parameters())
            pspecs = mesh_mod.param_specs(params, self._mesh,
                                          extra_rules=self._extra_rules)
            wspecs = mesh_mod.zero_opt_specs(pspecs, params, self._mesh)
            self._tp = self._tp_linears(pspecs)
            self._plan = {k: (pspecs[k], wspecs[k]) for k in params}
        return self._plan

    def _tp_linears(self, pspecs):
        """``{layer: (kind, lo, hi)}`` for each ``nn.Linear`` whose weight
        ``pspecs`` split over mp: ``"column"`` (``P(None, "mp")``) or
        ``"row"`` (``P("mp", None)``), and this rank's ``[lo, hi)`` of
        the split dim.  Any other parameter split over mp raises."""
        from ..distributed.mesh import _names, mesh_axis
        from ..nn.layer.common import Linear

        mp = mesh_axis(self._mesh, "mp")
        kinds = {(None, "mp"): "column", ("mp", None): "row"}
        linears = {f"{n}.weight" if n else "weight": m
                   for n, m in self.network.named_modules()
                   if isinstance(m, Linear)}
        tp = {}
        for k, spec in pspecs.items():
            names = [_names(e) for e in spec]
            if not any("mp" in n for n in names):
                continue
            entries = tuple(n[0] if n else None for n in names)
            layer = linears.get(k)
            if layer is None or entries not in kinds or \
                    any(len(n) > 1 for n in names):
                raise ValueError(
                    f"prepare(device_mesh=): {k} is split over mp by "
                    f"{spec}; the mp axis splits only an nn.Linear's "
                    f"weight, by columns P(None, 'mp') or rows "
                    f"P('mp', None)")
            kind = kinds[entries]
            n = layer.weight.shape[1 if kind == "column" else 0] // mp
            lo = self._mesh.coords["mp"] * n
            tp[layer] = (kind, lo, lo + n)
        return tp

    @contextlib.contextmanager
    def _tp_forward(self):
        """The split ``nn.Linear`` layers multiply by their weight as it
        is held in the step's layout, this rank's mp window, for the
        duration: the column split's input copied to the mp group and
        its output gathered, the row split's input scattered and its
        output reduced (each pair's gradients as ``mp_layers`` gives
        them, so the window's gradient is complete on its rank).  The
        bias is replicated, as the rule table leaves it, and added to
        the whole output."""
        from ..distributed.mp_layers import (copy_to_group,
                                             gather_from_group,
                                             reduce_from_group,
                                             scatter_to_group)

        if not self._tp:
            yield
            return
        group = self._mesh.group("mp")

        def split_forward(layer, kind):
            def forward(x):
                if kind == "column":
                    y = gather_from_group(
                        copy_to_group(x, group) @ layer.weight, group)
                else:
                    y = reduce_from_group(
                        scatter_to_group(x, group) @ layer.weight, group)
                return y if layer.bias is None else y + layer.bias
            return forward

        for layer, (kind, _, _) in self._tp.items():
            layer.forward = split_forward(layer, kind)
        try:
            yield
        finally:
            for layer in self._tp:
                del layer.forward

    def _window(self, t, spec):
        from ..distributed.mesh import axis_sizes, local_shard

        return local_shard(t, spec, axis_sizes(self._mesh),
                           self._mesh.coords)

    def shard_views(self):
        """``{"params": {name: mesh.Shard}}``: each parameter's window
        this rank owns under the rule table, with its place in the whole
        parameter (``owner`` on dp rank 0)."""
        from ..distributed.mesh import Shard, axis_sizes, window_of

        sizes = axis_sizes(self._mesh)
        out = {}
        for k, p in self.network.named_parameters():
            spec, held = self._mesh_plan()[k][0], self._held_spec(k)
            shape = self._whole_shape(k, p)
            if held == tuple(spec) + (None,) * (len(shape) - len(spec)):
                data = p.detach()       # held as this window: a live view
            else:
                data = self._window(self._whole(k, p), spec)
            out[k] = Shard(data, shape,
                           window_of(spec, shape, sizes, self._mesh.coords),
                           owner=self._mesh.coords.get("dp", 0) == 0)
        return {"params": out}

    # ---- parameters held as windows --------------------------------------
    def _held_spec(self, k):
        """The layout parameter ``k`` is held in: its window spec once a
        world's step has run, whole before."""
        spec = self._plan[k][1] if self._held else ()
        n = len(self._shapes[k]) if self._held else len(spec)
        return tuple(spec) + (None,) * (n - len(spec))

    def _whole_shape(self, k, p):
        return self._shapes[k] if self._held else tuple(p.shape)

    def _whole(self, k, p):
        from ..distributed.mesh import gather_leaf

        if not self._held:
            return p.detach()
        return gather_leaf(p.detach(), self._plan[k][1], self._mesh)

    def _unhold(self):
        """Every parameter whole again (gathered in a world whose steps
        hold windows); the next step cuts the windows anew."""
        if self._held:
            with torch.no_grad():
                for k, p in self.network.named_parameters():
                    p.data = self._whole(k, p)
            self._held = False

    def _whole_state(self):
        """``(params, optimizer state)`` whole, for a writer or a
        fingerprint: in a world the parameters' and the optimizer slots'
        windows are all-gathered (every rank then holds the same bytes);
        the live tensors otherwise."""
        from ..distributed.mesh import gather_leaf

        params = {k: self._whole(k, p)
                  for k, p in self.network.named_parameters()}
        st = self._opt_state
        if st is not None and self._mesh is not None:
            plan = self._mesh_plan()
            st = {"step": st["step"], "slots": {
                k: {n: gather_leaf(t, plan[k][1], self._mesh)
                    for n, t in s.items()}
                for k, s in st["slots"].items()}}
        return params, st

    def _window_state(self, st):
        """A whole optimizer state cut to this rank's slot windows (the
        inverse of :meth:`_whole_state`'s gather)."""
        plan = self._mesh_plan()
        return {"step": st["step"], "slots": {
            k: {n: self._window(t, plan[k][1]).contiguous().clone()
                for n, t in s.items()}
            for k, s in st["slots"].items()}}

    def param_bytes(self):
        """Bytes of parameter this rank holds (its windows in a world,
        the whole parameters otherwise)."""
        return sum(p.numel() * p.element_size()
                   for p in self.network.parameters())

    @contextlib.contextmanager
    def whole_parameters(self):
        """Every parameter whole for the block (gathered from the ranks'
        windows in a world whose steps hold windows), the windows put
        back after; a no-op otherwise."""
        if self._mesh is None or not self._held:
            yield
            return
        params = dict(self.network.named_parameters())
        windows = {k: p.data for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.data = self._whole(k, p)
        try:
            yield
        finally:
            for k, p in params.items():
                p.data = windows[k]

    def _mesh_state(self):
        """The optimizer state of the world's step: each slot the
        window of this rank.  Every rule's slots are a function of the
        parameter's shape and dtype, so made on the held windows they
        are the windows of the whole ones."""
        if self._opt_state is None:
            self._hold()
            self._opt_state = self._optimizer.init_state(
                dict(self.network.named_parameters()))
        return self._opt_state

    def _hold(self):
        """Cut every parameter to its window (the storage it keeps from
        one step to the next) unless it is held so already."""
        if self._held:
            return
        plan = self._mesh_plan()
        with torch.no_grad():
            params = dict(self.network.named_parameters())
            self._shapes = {k: tuple(p.shape) for k, p in params.items()}
            for k, p in params.items():
                p.data = self._window(p.detach(), plan[k][1]).contiguous(
                ).clone()
        self._held = True

    def _zero_split(self, k):
        """The split that the ZeRO window of parameter ``k`` adds to its
        ``param_specs`` spec (the sharding axis on one free dim), as a
        spec of its own, or None where it adds none."""
        from ..distributed.mesh import P, axis_sizes

        pspec, wspec = self._plan[k]
        sizes = axis_sizes(self._mesh)
        n = len(wspec)
        ps = tuple(pspec) + (None,) * (n - len(pspec))
        extra = tuple(None if p is not None else w
                      for p, w in zip(ps, wspec))
        if all(e is None or sizes.get(e, 1) <= 1 for e in extra):
            return None
        return P(*extra)

    @contextlib.contextmanager
    def _step_layout(self):
        """Every parameter in the JAX layout, its ``param_specs`` spec,
        for the block: the held window all-gathered over the sharding
        group only (an mp window stays the mp window; the sharding axis
        divides the optimizer state, as in GSPMD), the held storage
        itself where the ZeRO split adds nothing.  Yields ``{name: held
        window}``; the windows are put back after."""
        from ..distributed.mesh import gather_leaf

        self._hold()
        params = dict(self.network.named_parameters())
        held = {k: p.data for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                extra = self._zero_split(k)
                if extra is not None:
                    p.data = gather_leaf(held[k], extra, self._mesh)
        try:
            yield held
        finally:
            for k, p in params.items():
                p.data = held[k]

    def _whole_sums(self, sums, specs):
        """``sums``: a tensor a parameter, each a sum over this rank's
        window of it under ``specs`` (the same shape for all); returns
        each one summed over the window's whole parameter: one
        all-reduce an axis that splits any of them, of the rows that it
        splits (a replicated parameter's sum is counted once)."""
        from ..distributed import collective
        from ..distributed.mesh import _names, axis_sizes

        if not sums:
            return []
        t = torch.stack([s.float() for s in sums])
        for a, n in axis_sizes(self._mesh).items():
            rows = [i for i, spec in enumerate(specs)
                    if any(a in _names(e) for e in spec)]
            if n > 1 and rows:
                part = t[rows].contiguous()
                collective.all_reduce(part, group=self._mesh.group(a))
                t[rows] = part
        return list(t.unbind(0))

    def _dp_rows(self, x, y):
        """This rank's dp rows of the batch: trimmed to a dp multiple, or
        padded by repeating the last row when smaller than dp (the JAX
        ``_shard_batch``)."""
        from ..distributed import mesh as mesh_mod

        x, y = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
                for t in (x, y))
        dp = mesh_mod.mesh_axis(self._mesh, "dp")
        n = x.shape[0]
        if n % dp:
            keep = (n // dp) * dp
            if keep:
                x, y = x[:keep], y[:keep]
            else:
                x = np.concatenate([x] + [x[-1:]] * (dp - n))
                y = np.concatenate([y] + [y[-1:]] * (dp - n))
        xs, ys = mesh_mod.shard_batch(self._mesh, x, y)
        return self._tensor(xs), self._tensor(ys)

    def _dp_outputs(self, out, y):
        """The outputs and labels of every dp rank, for the metrics."""
        from ..distributed import collective
        from ..distributed.mesh import mesh_axis

        if mesh_axis(self._mesh, "dp") > 1:
            group = self._mesh.group("dp")
            out = collective.all_gather(out.detach().contiguous(),
                                        group=group, axis=0)
            y = collective.all_gather(y.contiguous(), group=group, axis=0)
        return out.detach(), y

    def _mesh_train(self, inputs, labels, lr):
        """The world's train step (eager) in the JAX layout: the dp
        rows' forward and backward with every parameter as its
        ``param_specs`` spec holds it (the split linears on their mp
        window, whose gradient autograd gives complete), the gradients
        averaged over dp, clip on the split-aware norms, then decay and
        the rule on this rank's windows, written into the storage held
        between steps."""
        from ..distributed.mesh import mesh_axis
        from ..distributed.parallel import reduce_grads

        opt, plan = self._optimizer, self._mesh_plan()
        dp = mesh_axis(self._mesh, "dp")
        st = self._mesh_state()
        x, y = self._dp_rows(_to_list(inputs)[0], _to_list(labels)[0])
        params = dict(self.network.named_parameters())
        live = [k for k, p in params.items() if p.requires_grad]
        pspecs = [plan[k][0] for k in live]
        wspecs = [plan[k][1] for k in live]
        with RecordEvent("hapi::train_step"), self._step_layout() as held:
            with self._tp_forward():
                out = self.network(x)
            loss = self._loss(out, y)
            got = torch.autograd.grad(loss, [params[k] for k in live],
                                      allow_unused=True)
            with torch.no_grad():
                grads = [torch.zeros_like(params[k]) if g is None else g
                         for k, g in zip(live, got)]
                loss = loss.detach().reshape(1).clone()
                if dp > 1:
                    reduce_grads(grads + [loss], self._mesh.group("dp"))
                loss = loss[0]
                gnorm = None
                if self._watch_grad_norm:
                    gnorm = torch.sqrt(sum(self._whole_sums(
                        [torch.sum(torch.square(g.float())) for g in grads],
                        pspecs)))
                if opt._grad_clip is not None:
                    grads = self._clip(opt._grad_clip, grads, pspecs)
                wins, gwins = [], []
                for k, g in zip(live, grads):
                    w = held[k]
                    extra = self._zero_split(k)
                    if extra is not None:
                        g = self._window(g, extra)
                    wins.append(w)
                    gwins.append(opt._apply_decay(w, g.to(w.dtype)))
                step = self._step.fill_(st["step"] + 1)
                self._lr.fill_(lr)
                opt._apply_windows(
                    wins, gwins, [st["slots"][k] for k in live], self._lr,
                    step, lambda sums: self._whole_sums(sums, wspecs))
        st["step"] += 1
        out, y = self._dp_outputs(out, y)
        return loss, out, gnorm, y

    def _clip(self, clip, grads, specs):
        """``clip`` on gradients held as their ``specs`` windows: its
        norms are those of the whole gradients (``clip_windows``)."""
        windows = getattr(clip, "clip_windows", None)
        if windows is not None:
            return windows(grads, lambda sums: self._whole_sums(sums, specs))
        if any(any(e is not None for e in s) for s in specs):
            raise ValueError(f"{type(clip).__name__} cannot clip gradients "
                             f"split over the mesh (no clip_windows)")
        return clip(grads)

    def _mesh_forward(self, x):
        """The network on ``x`` in the world's layout, without grad and
        keeping no buffer update."""
        with torch.no_grad(), self._buffers_kept(), self._step_layout(), \
                self._tp_forward():
            return self.network(x)

    def eval_batch(self, inputs, labels):
        if self._mesh is not None:
            # each rank its dp rows, as the train step (JAX's P("dp")
            # in_shardings); the loss averaged and the outputs gathered
            from ..distributed import collective
            from ..distributed.mesh import mesh_axis

            x, y = self._dp_rows(_to_list(inputs)[0], _to_list(labels)[0])
            with RecordEvent("hapi::eval_step"):
                out = self._mesh_forward(x)
                loss = None
                if self._loss:
                    with torch.no_grad():
                        loss = self._loss(out, y).detach().reshape(1)
                    if mesh_axis(self._mesh, "dp") > 1:
                        collective.all_reduce(
                            loss, op=collective.ReduceOp.AVG,
                            group=self._mesh.group("dp"))
            out, y = self._dp_outputs(out, y)
            results = self._update_metrics(out, y)
            return (float(loss) if loss is not None else 0.0), results
        x, y = self._eval_in(_to_list(inputs)[0], _to_list(labels)[0])
        with RecordEvent("hapi::eval_step"):
            loss, out = self._run_eval(x, y)
        results = self._update_metrics(out, y)
        return (float(loss) if loss is not None else 0.0), results

    def _run_eval(self, x, y):
        """The watched eval step (the graph's replay on CUDA)."""
        net = self.network
        tag = storage_tag([x, y, *net.parameters(), *net.buffers()],
                          self._static(), self._loss is not None)
        return self._eval_fn(x, y, storage=tag)

    def _eval_body(self, x, y):
        """The captured eval step: ``(loss or None, output)``, buffers
        left as they were."""
        with torch.no_grad(), self._buffers_kept():
            out = self.network(x)
            loss = self._loss(out, y) if self._loss else None
        return loss, out

    def predict_batch(self, inputs):
        """The network's output on ``inputs``.  In a world every rank
        runs the whole batch (as the JAX ``predict_batch``, whose input
        is not split), with the parameters in the step's layout: a
        collective, every rank calls it."""
        x = self._tensor(inputs)
        if self._mesh is not None:
            return _numpy(self._mesh_forward(x))
        with torch.no_grad(), self._buffers_kept():
            out = self.network(x)
        return _numpy(out)

    def _update_metrics(self, out, y):
        """Each metric's compute → update; list-named results (Accuracy
        with several k) are reported one key each."""
        results = {}
        for m in self._metrics:
            res = m.compute(out, y)
            val = m.update(*res) if isinstance(res, tuple) else m.update(res)
            names = m.name()
            if isinstance(names, list):
                vals = val if isinstance(val, (list, tuple)) else [val]
                results.update(dict(zip(names, vals)))
            else:
                results[names] = val
        return results

    # ------------------------------------------------------------- the fit
    @staticmethod
    def _loader(data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, shuffle=True, callbacks=None, resume_from=None,
            **kw):
        """``resume_from``: a directory a ``CheckpointCallback`` wrote (or
        its ``CheckpointManager``).  The newest intact checkpoint restores
        params, buffers, optimizer state, generator states and the LR
        scheduler, and the loop fast-forwards to the saved (epoch, step);
        an empty directory is a fresh start."""
        resume_epoch, resume_step = 0, 0
        self._resume_info = None   # don't let a previous fit's resume leak
        if resume_from is not None:
            from .callbacks import restore_fit_state

            info = restore_fit_state(self, resume_from)
            if info is not None:
                self._resume_info = info
                resume_epoch = int(info.get("epoch", 0))
                resume_step = int(info.get("next_step", 0))
        train_loader = self._loader(train_data, batch_size, shuffle)
        eval_loader = self._loader(eval_data, batch_size, False)
        cbs = _to_list(callbacks)
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs = [ProgBarLogger(log_freq, verbose)] + cbs
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cblist = CallbackList(cbs, model=self,
                              params={"epochs": epochs, "steps": steps,
                                      "verbose": verbose,
                                      "metrics": self._metric_names()})
        self.stop_training = False
        self._rollback_request = None
        cblist.on_train_begin()
        from ..observability.flight import default_flight_recorder
        from ..observability.tracing import default_tracer

        tracer = default_tracer()
        # step-progress heartbeat for the hang watchdog: stamping the
        # flight recorder each batch lets cross-rank heartbeats and
        # debug bundles say WHERE in training every rank was
        flight = default_flight_recorder()
        history, logs = [], {}
        for epoch in range(resume_epoch, epochs):
            cblist.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            start_step = resume_step if epoch == resume_epoch else 0
            while True:     # re-entered only on an integrity rewind
                rewound = False
                for step, batch in enumerate(train_loader):
                    if step < start_step:
                        continue   # trained before the crash / rewind
                    cblist.on_train_batch_begin(step)
                    flight.note_step(step, epoch=epoch)
                    x, y = batch[0], batch[1]
                    if self._stash_batch:
                        self._last_batch = (x, y)
                    with tracer.start_trace("hapi::step", {
                            "epoch": epoch, "step": step}) as sp:
                        loss, res = self.train_batch(x, y)
                        sp.set_attribute("loss", float(loss))
                    logs = {"loss": loss, **res}
                    cblist.on_train_batch_end(step, logs)
                    if self._rollback_request is not None:
                        # restore the last good checkpoint, then skip the
                        # poisoned window or rewind and replay it
                        req, self._rollback_request = \
                            self._rollback_request, None
                        rewind_to = self._execute_rollback(
                            req, cblist, epoch, step)
                        if rewind_to is not None:
                            start_step = int(rewind_to)
                            rewound = True
                            break
                    # simulated preemption: after this step's callbacks
                    fault_point("hapi.train_step")
                    if self.stop_training:
                        break
                if not rewound:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, callbacks=[],
                                          verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cblist.on_epoch_end(epoch, logs)
            history.append(logs)
            if self.stop_training:
                break
        cblist.on_train_end(logs)
        return history

    def _execute_rollback(self, req, cblist, epoch, step):
        """Health-triggered rollback: restore the newest intact checkpoint
        older than the anomalous step.  Default (a poisoned batch): the
        loop goes on with the next batch on the restored state, and the
        skipped window is committed at once.  ``req["rewind"]`` (the
        integrity repair: corrupted state, healthy data): restore the
        newest checkpoint before ``req["restore_before"]``, discard the
        newer saves and return the loop step to replay from."""
        from ..observability.health import TrainingHealthError
        from .callbacks import CheckpointCallback, restore_fit_state

        reason = req.get("reason", "anomaly")
        cb = next((c for c in cblist.callbacks
                   if isinstance(c, CheckpointCallback)), None)
        if cb is None:
            raise TrainingHealthError(
                reason, f"rollback requested at step {step} but no "
                        f"CheckpointCallback is attached — there is "
                        f"nothing to roll back to")
        cb.manager.wait()          # join an in-flight poisoned save
        bad_global_step = cb._global_step
        before = int(req.get("restore_before", bad_global_step))
        info = restore_fit_state(self, cb.manager, before_step=before)
        if info is None:
            raise TrainingHealthError(
                reason, f"rollback requested at step {step} but no "
                        f"intact checkpoint precedes global step "
                        f"{before}")
        if req.get("rewind"):
            return self._finish_rewind_rollback(req, cblist, cb, info,
                                                epoch, step)
        window = {
            "reason": reason,
            "epoch": int(epoch),
            # batches first_step..last_step of this epoch were trained
            # then discarded: a resume never sees them again
            "first_step": int(info.get("next_step", 0)),
            "last_step": int(step),
            "global_step": int(bad_global_step),
            "restored_global_step": int(info.get("global_step", 0)),
        }
        cb.record_rollback(window, next_step=step + 1)
        self._note_rollback(window, reason, epoch, step)

    def _finish_rewind_rollback(self, req, cblist, cb, info, epoch,
                                step):
        """The integrity repair's tail: discard the poisoned newer saves,
        rewind the step-counting callbacks, and return the loop step to
        replay from."""
        reason = req.get("reason", "param_divergence")
        restored_gs = int(info.get("global_step", 0))
        rewind_step = int(info.get("next_step", 0))
        cb.manager.discard_after(restored_gs)
        for c in cblist.callbacks:
            rewind = getattr(c, "rewind_to", None)
            if callable(rewind):
                rewind(restored_gs)
        repair = {
            "reason": reason,
            "epoch": int(epoch),
            "detected_step": int(step),
            "replay_from_step": rewind_step,
            "global_step": int(req.get("step", step)),
            "restored_global_step": restored_gs,
            "rewind": True,
        }
        cb.record_repair(repair)
        self._note_rollback(repair, reason, epoch, step)
        return rewind_step

    @staticmethod
    def _note_rollback(window, reason, epoch, step):
        import logging

        from ..observability.metrics import default_registry
        from ..observability.tracing import default_tracer

        default_registry().counter(
            "training_rollbacks_total",
            "health-triggered restores of the last good checkpoint",
            labelnames=("reason",)).labels(reason=reason).inc()
        default_tracer().start_trace("supervisor::rollback",
                                     attributes=dict(window)).end()
        log = logging.getLogger("paddle_tpu_torch.hapi")
        if window.get("rewind"):
            log.warning("rolled back to checkpoint step %s after %s at "
                        "epoch %d step %d; replaying from step %d (no data "
                        "skipped)", window["restored_global_step"], reason,
                        epoch, step, window["replay_from_step"])
        else:
            log.warning("rolled back to checkpoint step %s after %s at "
                        "epoch %d step %d; skipping data window [%d, %d]",
                        window["restored_global_step"], reason, epoch, step,
                        window["first_step"], window["last_step"])

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 callbacks=None, **kw):
        loader = self._loader(eval_data, batch_size, False)
        cblist = CallbackList(_to_list(callbacks), model=self, params={})
        for m in self._metrics:
            m.reset()
        cblist.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            cblist.on_eval_batch_begin(step)
            loss, res = self.eval_batch(batch[0], batch[1])
            logs = {"loss": loss, **res}
            cblist.on_eval_batch_end(step, logs)
        cblist.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, **kw):
        loader = self._loader(test_data, batch_size, False)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(x))
        return [np.concatenate(outs, axis=0)]

    # ---------------------------------------------------------- save/load
    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def save(self, path):
        """``path.pdparams`` (+ ``path.pdopt`` when prepared), each
        written atomically."""
        net = self.network
        params, st = self._whole_state()
        blob = {"params": {k: _numpy(p) for k, p in params.items()},
                "buffers": {k: _numpy(b) for k, b in net.named_buffers()}}
        with atomic_write(path + ".pdparams", site="hapi.model_save") as f:
            pickle.dump(blob, f, protocol=4)
        if st is not None:
            opt_blob = {"step": np.asarray(st["step"], np.int32),
                        "slots": {k: {n: _numpy(t) for n, t in s.items()}
                                  for k, s in st["slots"].items()}}
        elif self._optimizer is not None:
            opt_blob = {k: _numpy(v) if isinstance(v, torch.Tensor) else v
                        for k, v in self._optimizer.state_dict().items()}
        else:
            return
        with atomic_write(path + ".pdopt", site="hapi.model_save") as f:
            pickle.dump(opt_blob, f, protocol=4)

    def load(self, path):
        """Load what ``save`` wrote, or what the JAX package's
        ``Model.save`` wrote: values are copied into the network's
        tensors (their dtype and device kept)."""
        with open(path + ".pdparams", "rb") as f:
            blob = pickle.load(f)
        net = self.network
        self._unhold()      # a world's step cuts the windows anew
        own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
        with torch.no_grad():
            for k, v in {**blob["params"], **blob.get("buffers", {})}.items():
                if k in own:
                    own[k].copy_(torch.from_numpy(np.array(_to_numpy(v))))
        opt_path = path + ".pdopt"
        if os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                blob_opt = pickle.load(f)
            if isinstance(blob_opt, dict) and "slots" in blob_opt:
                templates = None
                if self._optimizer is not None:
                    templates = self._optimizer.init_state(dict(
                        net.named_parameters()))["slots"]
                self._opt_state = opt_state_from_jax(blob_opt, self.device,
                                                     templates)
                if self._mesh is not None and self._optimizer is not None:
                    self._opt_state = self._window_state(self._opt_state)
            elif self._optimizer is not None:
                self._optimizer.set_state_dict(blob_opt)
        return self

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None):
        total = sum(int(np.prod(self._whole_shape(k, p)))
                    for k, p in self.network.named_parameters())
        return f"{type(self.network).__name__}: {total:,} parameters"
