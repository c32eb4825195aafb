"""jit — trace-and-run ("static graph") path (the port of
``paddle_tpu/jit``).

The JAX package traces a Layer or function once per input signature
into an XLA executable (``jax.jit``).  Here the trace is
``torch.export.export(..., strict=False)``, once per input signature,
under ``no_grad`` (the JAX ``pure`` runs without a tape).  The exported
program is what runs:

- on CUDA it is captured as one CUDA graph per signature and replayed
  (``_captured.SignatureGraphs``: the signatures share one graph pool,
  and each call returns copies of the graph's outputs);
- a program that holds ``torch.cond`` or ``while_loop``
  (``static.nn.cond`` / ``while_loop`` under ``to_static``) runs its
  exported module eagerly on the card instead: those operators read
  their predicate on the host when run eagerly, and PyTorch 2.11 does
  not capture them (a stream capture of ``torch.cond`` is invalidated).
  The choice is made from the program's content and reported in
  ``TracedLayer.routes``;
- on the CPU the exported module runs eagerly.

Each build (an export, and on CUDA a capture) is counted by the compile
watchdog under ``jit::<Layer class>``, one per signature.  The exported
module reads the layer's own parameters and buffers (``ExportedProgram.
module()`` aliases them), so an update in place is seen by the next
call, and a replaced tensor (``p.data = ...``) makes the graph capture
again (its storage tag changes): the JAX package passes ``raw_state()``
on every call.

Python control flow on a tensor's value cannot be traced: it raises,
naming ``static.nn.cond`` / ``while_loop``, as the JAX trace raises on a
tracer's ``bool``.

``save`` writes the JAX package's files: ``.pdiparams.npz`` and
``.pdibuffers.npz`` under the same structured names (weights cross
between the packages both ways), ``.pdmodel`` (here a
``torch.export.save`` archive of a program exported on the CPU, written
when ``example_inputs`` are given), ``.program.txt`` (its text) and
``.pdmodel.json`` last, as the commit marker, with ``"format":
"torch.export"``.  ``load(path)`` runs the program without the model's
class, moved to the device it is asked for (the CPU-saved program runs
the flash kernel on the card: the attention in it is the operator
``paddle_tpu_torch::flash_fwd``, which picks its route by device).  A
``.pdmodel`` written by the JAX package holds a ``jax.export`` program,
which the port cannot run: its weights load with ``layer=``.
"""
from __future__ import annotations

import copy
import functools
import json
import os

import numpy as np
import torch
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

from .._captured import SignatureGraphs
from .._device import resolve_device
from ..amp.auto_cast import amp_state
from ..core.place import current_device
from ..kernels import flash_attention  # noqa: F401  (registers flash_fwd)
from ..observability.compile_watchdog import watch
from ..resilience.atomic import atomic_write

__all__ = ["to_static", "TracedLayer", "save", "load", "not_to_static",
           "Predictor"]

FORMAT = "torch.export"


class _Function(torch.nn.Module):
    """A plain function as a module, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _has_control_flow(gm):
    """Whether an exported graph holds ``torch.cond`` or ``while_loop``."""
    return any(isinstance(n.target, torch._ops.HigherOrderOperator)
               and n.target.name() in ("cond", "while_loop")
               for n in gm.graph.nodes)


def _is_array(a):
    return isinstance(a, (torch.Tensor, np.ndarray, np.generic))


def _to_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(a), device=device)
    return a


def _signature(a):
    """An argument's part of a program's key: a tensor's or an array's
    shape and torch dtype, else the value's repr."""
    if not _is_array(a):
        return ("value", repr(a))
    dtype = (a.dtype if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.zeros(0, a.dtype)).dtype)
    return tuple(a.shape), dtype


def _export(module, args):
    """``torch.export`` of ``module`` at ``args``, under ``no_grad``."""
    try:
        with torch.no_grad():
            return torch.export.export(module, tuple(args), strict=False)
    except GuardOnDataDependentSymNode as e:
        raise RuntimeError(
            "to_static: Python control flow on a tensor's value cannot be "
            "traced; write it with paddle_tpu_torch.static.nn.cond or "
            "static.nn.while_loop") from e


class TracedLayer:
    """A Layer (or function) run as an exported program per input
    signature (see the module docstring).

    ``device``: where the program runs; by default the device of the
    layer's parameters, or for a function (or a layer without any) the
    current place (``set_device``; CUDA unless asked otherwise).
    ``name``: the compile watchdog's name (``jit::<class>`` by default).
    ``trace_context``: a context manager factory entered around each
    export (the int8 predictor's forward patch)."""

    def __init__(self, layer_or_fn, device=None, name=None,
                 trace_context=None):
        self.target = layer_or_fn
        self.is_layer = isinstance(layer_or_fn, torch.nn.Module)
        self._module = (layer_or_fn if self.is_layer
                        else _Function(layer_or_fn))
        if device is None:
            first = next(iter([*self._module.parameters(),
                               *self._module.buffers()]), None)
            device = current_device() if first is None else first.device
        self.device = resolve_device(device)
        self._trace_context = trace_context
        self._programs = {}      # key -> (ExportedProgram, module, route)
        self._graphs = (SignatureGraphs(self.device)
                        if self.device.type == "cuda" else None)
        if name is None:
            name = (type(layer_or_fn).__name__ if self.is_layer
                    else getattr(layer_or_fn, "__name__", "fn"))
            name = f"jit::{name}"
        self._compiled = watch(self._run, name=name)

    # ------------------------------------------------------------ building
    def _key(self, args):
        modes = tuple(m.training for m in self._module.modules())
        return tuple(_signature(a) for a in args), modes, amp_state()

    def _build(self, args):
        """``(exported program, its module, route)`` for ``args``."""
        if self._trace_context is None:
            ep = _export(self._module, args)
        else:
            with self._trace_context():
                ep = _export(self._module, args)
        return ep, ep.module()

    def _program(self, args):
        """``(key, (exported program, its module, route))`` for ``args``,
        exported at the first call with their signature."""
        key = self._key(args)
        prog = self._programs.get(key)
        if prog is None:
            ep, mod = self._build(tuple(_to_tensor(a, self.device)
                                        for a in args))
            route = ("cpu" if self.device.type != "cuda" else
                     "eager" if _has_control_flow(ep.graph_module) else
                     "graph")
            prog = self._programs[key] = (ep, mod, route)
        return key, prog

    @property
    def routes(self):
        """``{input signature: "graph" | "eager" | "cpu"}``."""
        return {key[0]: prog[2] for key, prog in self._programs.items()}

    @property
    def captures(self):
        return 0 if self._graphs is None else self._graphs.captures

    @property
    def pool_bytes(self):
        return 0 if self._graphs is None else self._graphs.pool_bytes

    # ------------------------------------------------------------- running
    def _run(self, *args):
        key, (_, mod, route) = self._program(args)
        if route != "graph":
            with torch.no_grad():
                return mod(*[_to_tensor(a, self.device) for a in args])
        # arrays go in through the signature's static buffers (host data
        # through pinned copies); other arguments are part of the key
        at = [i for i, a in enumerate(args) if _is_array(a)]
        values = [None if i in at else a for i, a in enumerate(args)]

        def body(*xs):
            full = list(values)
            for i, x in zip(at, xs):
                full[i] = x
            with torch.no_grad():
                return mod(*full)

        state = [*mod.parameters(), *mod.buffers()]
        return self._graphs.run(key, body, [args[i] for i in at], state)

    def __call__(self, *args):
        return self._compiled(*args)

    def forward(self, *args):
        return self(*args)

    # ------------------------------------------------------- introspection
    def exported_program(self, *args):
        """The ``torch.export.ExportedProgram`` run for ``args``."""
        return self._program(args)[1][0]

    def program_text(self, *args):
        """The program run for ``args``, as text (the counterpart of the
        JAX package's ``stablehlo``)."""
        return str(self.exported_program(*args))

    def release(self):
        """Drop the captured graphs (and their pool)."""
        if self._graphs is not None:
            self._graphs.release()


def to_static(layer_or_fn=None, input_spec=None, device=None, **kwargs):
    """Decorator/wrapper parity: paddle.jit.to_static (the reference's
    other options, e.g. ``build_strategy``, are accepted and unused)."""
    if layer_or_fn is None:
        return functools.partial(to_static, input_spec=input_spec,
                                 device=device, **kwargs)
    traced = TracedLayer(layer_or_fn, device=device)
    if not traced.is_layer:
        functools.update_wrapper(traced, layer_or_fn)
    return traced


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def _numpy(t):
    """A tensor as numpy for the ``.npz`` files; bf16 (which numpy lacks)
    is written as fp32, and loads back into the tensor's own dtype."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cpu_program(module, example_inputs):
    """``module`` exported on the CPU at ``example_inputs`` (moved
    there; a module whose tensors live elsewhere is exported from a CPU
    copy), so the artifact runs on any device it is moved to."""
    args = tuple(_to_tensor(a, "cpu") for a in example_inputs)
    on_cpu = all(t.device.type == "cpu"
                 for t in [*module.parameters(), *module.buffers()])
    return _export(module if on_cpu else copy.deepcopy(module).cpu(), args)


def save(layer, path, input_spec=None, example_inputs=None):
    """paddle.jit.save: the weights, and with ``example_inputs`` a program
    that runs without the model's class (see the module docstring for the
    files)."""
    target = layer.target if isinstance(layer, TracedLayer) else layer
    is_layer = isinstance(target, torch.nn.Module)
    module = target if is_layer else _Function(target)
    params = {k: _numpy(v) for k, v in module.named_parameters()}
    buffers = {k: _numpy(v) for k, v in module.named_buffers()}
    with atomic_write(path + ".pdiparams.npz") as f:
        np.savez(f, **params)
    with atomic_write(path + ".pdibuffers.npz") as f:
        np.savez(f, **buffers)
    meta = {"class": type(target).__name__, "format": FORMAT,
            "keys": list(params)}
    if example_inputs is not None:
        ep = _cpu_program(module, example_inputs)
        with atomic_write(path + ".pdmodel") as f:
            torch.export.save(ep, f)
        with atomic_write(path + ".program.txt", "w") as f:
            f.write(str(ep))
        meta["has_program"] = True
        # the exported module holds its weights; the JAX program takes
        # them as arguments
        meta["program_takes_state"] = False
    # metadata last: it is the artifact's commit marker
    with atomic_write(path + ".pdmodel.json", "w") as f:
        json.dump(meta, f)


def _load_npz(module, path, strict):
    """Copy the ``.npz`` weights into ``module``'s tensors of the same
    names (in their dtype, on their device)."""
    named = dict(module.named_parameters())
    named_b = dict(module.named_buffers())
    data = np.load(path + ".pdiparams.npz")
    if strict and set(data.files) != set(named):
        raise ValueError(f"{path}.pdiparams.npz holds {sorted(data.files)}, "
                         f"the program {sorted(named)}")
    with torch.no_grad():
        for k in data.files:
            if k in named:
                named[k].copy_(torch.from_numpy(data[k]))
        if os.path.exists(path + ".pdibuffers.npz"):
            bdata = np.load(path + ".pdibuffers.npz")
            for k in bdata.files:
                if k in named_b:
                    named_b[k].copy_(torch.from_numpy(bdata[k]))


class Predictor(TracedLayer):
    """Runs a ``jit.save`` artifact without the model's class (the
    serving-side predictor; reference role:
    inference/api/analysis_predictor.cc).  The program is the saved
    ``torch.export`` archive, moved to ``device`` (CUDA unless asked
    otherwise); its weights load from the ``.npz`` files.  It runs the
    one input signature it was exported at, captured on CUDA as
    ``TracedLayer`` captures; it is never exported again."""

    def __init__(self, path, device=None, name=None):
        with open(path + ".pdmodel.json") as f:
            self.meta = json.load(f)
        if not self.meta.get("has_program"):
            raise ValueError(
                f"{path} was saved without example_inputs — no executable "
                "program; re-save with example_inputs or pass layer= to "
                "jit.load")
        if self.meta.get("format") != FORMAT:
            raise ValueError(
                f"{path}.pdmodel was written by the JAX package (a "
                "jax.export program), which this package cannot run; load "
                "its weights into the model with jit.load(path, layer=...)")
        device = resolve_device(device)
        with open(path + ".pdmodel", "rb") as f:
            ep = torch.export.load(f)
        if device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
        self._ep = ep
        module = ep.module()
        _load_npz(module, path, strict=True)
        super().__init__(module, device=device,
                         name=name or f"jit::{self.meta['class']}")

    def _build(self, args):
        return self._ep, self.target

    run = TracedLayer.__call__


def load(path, layer=None, device=None):
    """paddle.jit.load.  With ``layer``: restore the weights into it (from
    an artifact of either package) and return a ``TracedLayer``.  Without:
    a ``Predictor`` that runs the saved program on ``device``."""
    if layer is not None:
        _load_npz(layer, path, strict=False)
        return TracedLayer(layer, device=device)
    return Predictor(path, device=device)
