"""Inference API — Config / create_predictor (the port of
``paddle_tpu/inference``; reference: the AnalysisPredictor tail).

Reference parity: paddle/fluid/inference/api/analysis_predictor.cc
(load program and params, optimise, run), paddle_infer::Config
(device, precision and optimisation knobs) and the int8 path of
inference/api/mkldnn_quantizer.cc (calibration scales → quantized
kernels).

The port's split of those jobs:

- the saved ``torch.export`` program (``jit.save``) runs as it is, on the
  card unless the config asks for the CPU (``disable_gpu``), one captured
  CUDA graph per input signature (``jit.Predictor``);
- a precision other than the saved fp32 rebuilds the program from the
  model Layer (``set_model``) and its weights, as the JAX package does
  (the saved program's dtypes are fixed): bf16 runs a bf16 copy of the
  layer on bf16 inputs (its buffers too, so a batch norm's statistics
  stay bf16 with its activations; the JAX package casts the parameters
  only, and promotes what meets an fp32 buffer back to fp32); int8
  exports the user's layer with each calibrated Linear's forward patched, for the trace only, to an int8
  twin (per-output-channel int8 weights, activations quantized by the
  calibrated scale with ``torch.round``, half to even like
  ``jnp.round``, an int8 × int8 → int32 product and the dequant and bias
  fused after it), so the user's model keeps its fp32 behaviour;
- every route runs under the compile watchdog as
  ``inference::predictor[<precision>]``, one build per input signature,
  and on CUDA as captured graphs that share one graph pool
  (``_captured.SignatureGraphs``; ``Predictor.pool_bytes``).
"""
from __future__ import annotations

import contextlib
import copy
import json
import os

import torch

from .._device import resolve_device
from ..nn.layer.common import Linear

__all__ = ["Config", "PrecisionType", "create_predictor", "Predictor",
           "GenerationPredictor"]


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "bfloat16"          # fp16 requests map to bf16, as in JAX
    Int8 = "int8"


class Config:
    """paddle_infer.Config parity.  The device is the card unless
    ``disable_gpu()`` / ``enable_use_cpu()`` ask for the CPU."""

    def __init__(self, prog_file=None, params_file=None):
        # jit.save artifact prefix (…pdmodel/.pdiparams.npz beside it)
        self.prog_file = prog_file
        self.params_file = params_file
        self.device = "cuda"
        self.precision = PrecisionType.Float32
        self.model_layer = None
        self.quant_scales = None
        self.generation = None
        self._ir_optim = True

    # ---- device selection ----
    def enable_use_gpu(self, memory_pool_init_size_mb=None, device_id=0):
        """Run on CUDA device ``device_id`` (the JAX ``enable_tpu``); the
        pool size is PyTorch's caching allocator's to manage."""
        self.device = f"cuda:{device_id}"
        return self

    def disable_gpu(self):
        self.device = "cpu"
        return self

    enable_use_cpu = disable_gpu

    # ---- precision ----
    def set_precision(self, precision):
        if precision not in (PrecisionType.Float32, PrecisionType.Bfloat16,
                             PrecisionType.Int8):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        return self

    def enable_int8(self, scales=None):
        """Int8 inference using PTQ/QAT calibration scales — a dict
        {layer_name: {"weight": s, "activation": s}} (contrib.quant
        quant_scales/PTQ.scales) or a path to a JSON of the same."""
        self.precision = PrecisionType.Int8
        if isinstance(scales, (str, os.PathLike)):
            with open(scales) as f:
                scales = json.load(f)
        self.quant_scales = scales
        return self

    # ---- autoregressive generation (serving engine) ----
    def enable_generation(self, model_config, params=None, *, page_size=16,
                          num_pages=256, max_batch_size=4, chunk_len=None,
                          prefill_len=None, prefix_cache=True):
        """Switch create_predictor to a GenerationPredictor: the
        continuous-batching, paged-KV-cache engine (``serving.Engine``)
        over the given GPTConfig, on this config's device.  ``params``
        default to the engine's ``gpt_init`` weights."""
        self.generation = {
            "config": model_config, "params": params,
            "knobs": {"page_size": page_size, "num_pages": num_pages,
                      "max_batch_size": max_batch_size,
                      "chunk_len": chunk_len, "prefill_len": prefill_len,
                      "prefix_cache": prefix_cache},
        }
        return self

    # ---- model source for rebuild-precision paths ----
    def set_model(self, layer, params_path=None):
        """A Layer to rebuild the program from (required for a precision
        other than the saved fp32)."""
        self.model_layer = layer
        if params_path:
            self.prog_file = params_path
        return self

    # ---- accepted no-ops, each with the mechanism that owns the job ----
    def switch_ir_optim(self, flag=True):
        # the exported program runs as traced; its launches are fused by
        # the CUDA graph replay, not by IR passes
        self._ir_optim = flag
        return self

    def enable_memory_optim(self):
        return self        # the graph pool and the caching allocator

    def set_cpu_math_library_num_threads(self, n):
        return self        # torch.set_num_threads owns CPU parallelism


class _Int8Linear:
    """Inference-only int8 Linear: per-output-channel int8 weights, the
    activation quantized by the calibrated scale, int8 × int8 → int32
    product, fused dequant (+ bias)."""

    def __init__(self, linear, act_scale, device):
        w = linear.weight.detach().to(device, torch.float32)   # [in, out]
        w_absmax = torch.clamp_min(w.abs().amax(dim=0), 1e-8)  # per out
        step = w_absmax / 127.0
        self.w_scale = step
        self.w_q = torch.clamp(torch.round(w / step), -127, 127).to(
            torch.int8)
        # a device tensor, so the division below is one (the CUDA kernel
        # multiplies by the reciprocal of a host scalar)
        self.a_scale = torch.tensor(float(act_scale) / 127.0,
                                    dtype=torch.float32, device=device)
        self.bias = (None if linear.bias is None else
                     linear.bias.detach().to(device, torch.float32))

    def accumulate(self, x):
        """The int32 accumulators of ``x``'s quantized rows."""
        xq = torch.clamp(torch.round(x / self.a_scale), -127, 127).to(
            torch.int8)
        return _int8_matmul(xq.reshape(-1, xq.shape[-1]), self.w_q).reshape(
            *xq.shape[:-1], self.w_q.shape[1])

    def __call__(self, x):
        out = self.accumulate(x).float() * (self.a_scale * self.w_scale)
        if self.bias is not None:
            out = out + self.bias
        return out


def _int8_matmul(a, b):
    """int8 [M, K] × int8 [K, N] → int32 [M, N] by ``torch._int_mm``
    (exact).  On CUDA it takes M > 16 and K, N multiples of 8: smaller M
    and other K, N are zero-padded (zero rows and columns add nothing)
    and the result sliced back."""
    M, K = a.shape
    N = b.shape[1]
    pm = max(17 - M, 0)
    pk, pn = -K % 8, -N % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a, b)
    return out[:M, :N] if (pm or pn) else out


class _Cast(torch.nn.Module):
    """A layer run on inputs cast to ``dtype``."""

    def __init__(self, inner, dtype):
        super().__init__()
        self.inner, self.dtype = inner, dtype

    def forward(self, *inputs):
        return self.inner(*[x.to(self.dtype) if x.is_floating_point()
                            else x for x in inputs])


class Predictor:
    """create_predictor result: ``run``/``__call__`` on numpy arrays or
    tensors; returns tensors on the config's device.

    fp32 without ``set_model`` runs the saved program
    (``jit.Predictor``); a precision override runs the model Layer
    rebuilt at that precision (``jit.TracedLayer``), as the JAX
    ``_build`` does."""

    def __init__(self, config: Config):
        self.config = config
        self._impl = None
        self._mode = None
        self._build()

    def _build(self):
        from ..jit import Predictor as _SavedPredictor
        from ..jit import load as jit_load

        cfg = self.config
        device = resolve_device(cfg.device)
        name = f"inference::predictor[{cfg.precision}]"
        if cfg.precision == PrecisionType.Float32 and cfg.model_layer is None:
            self._impl = _SavedPredictor(cfg.prog_file, device, name=name)
            self._mode = "saved-program"
            return
        if cfg.model_layer is None:
            raise ValueError(
                f"precision={cfg.precision!r} rebuilds the program and "
                "needs the model Layer: call config.set_model(layer) "
                "(the saved program's dtypes are fixed)")
        layer = cfg.model_layer
        if cfg.prog_file:
            jit_load(cfg.prog_file, layer=layer, device=device)
        if cfg.precision == PrecisionType.Int8:
            self._impl = self._build_int8(layer, device, name)
            self._mode = "int8"
        else:
            self._impl = self._build_cast(layer, cfg.precision, device, name)
            self._mode = cfg.precision

    # ---- precision rebuilds ------------------------------------------
    @staticmethod
    def _build_cast(layer, precision, device, name):
        from ..jit import TracedLayer

        dt = (torch.bfloat16 if precision == PrecisionType.Bfloat16
              else torch.float32)
        with torch.no_grad():
            model = copy.deepcopy(layer).to(device=device, dtype=dt)
        return TracedLayer(_Cast(model, dt), device=device, name=name)

    def _build_int8(self, layer, device, name):
        from ..jit import TracedLayer

        want = (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" and device.index is None
                else device)
        if any(t.device != want for t in [*layer.parameters(),
                                          *layer.buffers()]):
            raise ValueError(f"int8 predictor: the model must live on "
                             f"{device}, where the predictor runs")
        scales = self.config.quant_scales or {}
        quantized = {}
        # include_self: the model may itself BE a Linear — the root is
        # keyed by its empty-prefix name, matching PTQ scales
        for sub_name, sub in layer.named_sublayers(include_self=True):
            if isinstance(sub, Linear):
                act = (scales.get(sub_name) or {}).get("activation")
                if act is None:
                    raise ValueError(
                        f"int8 predictor: no activation scale for layer "
                        f"{sub_name!r} — calibrate with contrib.quant.PTQ "
                        f"and pass its scales to enable_int8()")
                quantized[sub] = _Int8Linear(sub, act, device)
        if not quantized:
            raise ValueError("int8 predictor: model has no Linear layers")
        self.int8_layers = quantized

        @contextlib.contextmanager
        def patched():
            """Each quantized Linear runs its int8 twin for the duration
            of the trace only: the user's model keeps its fp32 forward."""
            try:
                for sub, q in quantized.items():
                    sub.forward = q
                yield
            finally:
                for sub in quantized:
                    sub.__dict__.pop("forward", None)

        return TracedLayer(_Cast(layer, torch.float32), device=device,
                           name=name, trace_context=patched)

    # ---- serving entry ------------------------------------------------
    @property
    def captures(self):
        return self._impl.captures

    @property
    def pool_bytes(self):
        return self._impl.pool_bytes

    def run(self, *inputs):
        return self._impl(*inputs)

    __call__ = run


class GenerationPredictor:
    """create_predictor result when Config.enable_generation was called:
    autoregressive serving over the continuous-batching engine
    (``serving.Engine``, its step a captured CUDA graph on the card).

    ``generate(prompts, sampling)`` is the batch entry (token-id lists
    in, generated token-id lists out); ``add_request``/``step`` expose
    the engine's scheduler for streaming callers; ``metrics()`` snapshots
    the serving counters and histograms."""

    def __init__(self, config: Config):
        from ..serving import Engine

        gen = config.generation
        self.config = config
        self.engine = Engine(gen["config"], gen["params"], **gen["knobs"],
                             device=config.device)

    def generate(self, prompts, sampling=None):
        return self.engine.generate(prompts, sampling)

    def add_request(self, prompt, sampling=None):
        return self.engine.add_request(prompt, sampling)

    def step(self):
        return self.engine.step()

    def metrics(self):
        return self.engine.metrics.snapshot()


def create_predictor(config: Config):
    """paddle_infer.create_predictor parity; generation-enabled configs
    build the serving-engine predictor instead."""
    if config.generation is not None:
        return GenerationPredictor(config)
    return Predictor(config)
