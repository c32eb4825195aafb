#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build every CUDA kernel of
     the port from the sources in this checkout (one nvcc per source,
     started together);
  2. kernel vs plain version on the card: edge cases (idle rows,
     qlen == ctx, contexts straddling pages and the kv splits, Q == 1
     decode, head dims 16 to 1024) in fp32 and bf16, then the serving
     shape (a 64-token chunk and seven decode rows) and an all-decode
     shape (eight rows at context 2048), with each
     kernel's time, bound, plain-version time and the time of one
     library call computing the same function;
  3. one full-width ``gpt_ragged_step`` of GPT-3 1.3B (bf16, 24 layers)
     on a mixed chunk + decode + idle batch, kernel against the plain
     attention on the same inputs;
  4. the serving engine at GPT-3 1.3B serving 8 seeded requests (one
     pair sharing a 256-token prefix) to completion from its captured
     CUDA graph, with the kernel's launch count held to 24 per step and
     the compile watchdog to one capture;
  5. the flash-attention kernels (forward; the bf16 backward, dQ, dK
     and dV in one kernel; the fp32 dK/dV and dQ) vs their plain
     versions: edge cases (causal and not, ragged S, head dims 32 to 512,
     fp32 and bf16), flash and the ring at head dim 640 through their
     public entries with gradients, then the 1.3B training shapes with
     each kernel's time, bound, plain-version time and the time of
     PyTorch's SDPA (the backward kernel alone and the whole call),
     forward and backward at head dim 256 beside SDPA's, and the
     forward's host time per call with the TMA maps cached and encoded;
  6. one full-width GPT-3 1.3B training step (bf16, 24 layers, batch
     1 x 2048): loss and every gradient with the kernels against the
     same step on the plain attention;
  7. training throughput: ``HybridEngine`` on GPT-3 1.3B, batch 8 x
     2048, remat "dots", fp32 Adam slots with a master, its step
     captured as one CUDA graph (step 1 eager, then replays): ms/step,
     tokens/s, MFU, peak memory (the capture's included), the graph's
     pool; the loss falls over 10 steps, the engine captures once (the
     compile watchdog: one build of ``hybrid_engine::step``) and the
     flash launch counts, counted through the replays, are held to 48
     forward / 24 backward per step; device time by kind from a traced
     replay, by range (``engine::optimizer``) and aten op from one more
     step on the eager route (a replay records no ranges);
  8. ring attention's per-pair backward (bf16: one kernel that adds dQ,
     dK and dV into the ring's fp32 sums; fp32: the scalar kernels, then
     the adds; ring-global lse and delta) vs its plain version from
     non-zero starting sums: edge cases (diagonal and full pairs, shard
     lengths 128/256/512, head dims 32, 64, 128, 256 and a zero-padded
     80, fp32 and bf16; dQ, dK and dV bit-equal over two runs), then the
     per-rank shapes of the sep=4 training path with the kernel's time,
     bound, plain-version time, the time of PyTorch's flash attention
     backward on the same pair and of the three fp32 adds the route
     before this kernel ran after its two kernels;
  9. ``ring_attention`` with sep=4 vs ``flash_attention`` on the 1.3B
     training shapes: output and grads, and both times;
 10. ring sequence-parallel training: ``HybridEngine(sep=4)`` with
     ``seq_parallel="ring"`` on GPT-3 1.3B, every rank's shard on this
     card, as in phase 7 (graph route): ms/step, tokens/s, MFU, peak
     memory, busy share; the loss falls, its first step equals phase
     7's, one capture, and the launches per step are held to the ring's
     schedule (10 live pairs a layer: 480 forward, 240 pair backward);
 11. the serving fleet: ``FleetRouter`` over three GPT-3 1.3B engines
     (phase 4's pool and batch, one set of params, warmed before
     rotation) with an ``Autoscaler`` (2 to 4 replicas), 28 seeded
     arrivals (prompts 64-1024, three cohorts sharing 256-token
     prefixes, a burst) replayed in wall time, and chaos: an io_error at
     ``serving.step`` on a replica mid-decode, a hard kill of another, a
     rolling restart of a third; the burst scales up to a fourth engine,
     the quiet tail scales down.  Every request finishes with 32 tokens,
     none is lost, each failed-over request re-dispatched once per event
     it was aboard and its output begins with the tokens harvested
     before it; kernel launches equal 24 x the engines' steps; each
     engine captured its step once; device memory follows the engines
     held (one pool each) after the kill, the restart and the
     scale-down, and each engine's graph pool stays within its bound;
     tok/s, TTFT, scale events, peak memory and token identity against
     one engine are reported;
 12. MoE serving: GPT-3 1.3B's widths with every FFN an 8-expert top-2
     MoE (capacity factor 2.0), all 24 layers: (a) one fp32
     ``gpt_ragged_step`` on phase 3's batch, kernel vs plain attention,
     logits and pages at the fp32 tolerance and every layer routed
     identically; (b) the bf16 ``Engine`` serving phase 4's requests
     from its captured step, launches held to 24 per step and one
     capture, tok/s, ms/step untraced and on the device by kind
     (attention, matrix products, other; phase 16 splits expert
     products and routing/dispatch/combine out on the eager route) and
     the share of (token, choice) assignments capacity drops, padding
     slots apart;
 13. MoE training at those widths on 8 of the 24 layers: one fp32 step
     at batch 1 x 2048 (loss and every gradient, gate_w included, kernels
     vs plain attention, identical routing), then ``HybridEngine`` bf16
     at batch 8 x 2048 as in phase 7 (graph route, one capture) with
     flash launches held to 16 forward / 8 backward per step, MFU on the
     FLOPs the step does and on ``gpt_flops_per_token``'s 6N, and the
     MoE split from the eager route's traced step;
 14. BERT-base MLM training (``BertAdapter``, bf16, batch 32 x 512,
     masking rate 0.15) as in phase 7 (graph route, one capture) with
     flash launches held to 24 forward / 12 backward per step, then the
     non-causal flash forward
     and backward at q/k/v [32, 12, 512, 64] with times, bounds, plain
     and SDPA times;
 15. the eager Paddle API (``import paddle_tpu_torch as paddle``) under
     PyTorch's default TF32 flags, so that the port, not this script,
     decides the precision of a convolution: (a) one fp32
     ``hapi.Model.train_batch`` of ResNet-50 (1000 classes, Momentum
     0.1/0.9, weight decay 1e-4) at 4 x 3 x 224 x 224 on the card and,
     from the same weights, on the CPU: loss, logits, every parameter
     after the step and every batch-norm buffer; (b) the
     ``bench_resnet`` protocol (bf16 O1 ``auto_cast``, train-mode batch
     norm, Momentum 0.1/0.9) at batch 32 and 128, ``train_batch`` on
     its captured graph (one capture, the watchdog's
     ``hapi::train_step``): imgs/s, ms/step, device busy time and share
     (a replay), device time by kind (the eager route's step), peak
     memory, the graph's pool and MFU on the FLOPs counted from the
     convolution and linear shapes, and the loss falling over 10 steps
     on a fixed batch; (c) ``fit`` for one epoch over an in-memory
     seeded dataset, ``evaluate``, ``predict`` (one train and one eval
     capture), and ``save``/``load`` bit-equal on the card; (d)
     ``nn.TransformerEncoder`` at BERT-base widths (12 layers, batch 32 x
     512, bf16 ``auto_cast``): flash launches 12 forward in eval, 12
     forward and 12 backward a training step, none with attention
     dropout, and the eval output held to the same encoder on the plain
     attention;
 16. the captured step against the eager one (run after phase 4 on its
     params, and after phase 12 on the first ``GRAPH_MOE_LAYERS`` layers
     of the MoE model's): phase 4's engine
     and requests, one engine calling ``gpt_ragged_step`` eagerly each
     step and one replaying its CUDA graph, each with a ``defrag()``
     mid-run: greedy tokens identical, pages equal, the graph engine
     built once (compile watchdog) and launches 24 a step on both;
     ms/step on the host, device ms/step and busy share from a run
     traced by the ported ``Profiler`` (whose chrome export holds one
     ``serving::unified_step`` span a step), tok/s, beside the card's
     name and power limit; for the MoE model, the eager route's device
     time by kind with the expert products and the routing apart;
 17. the captured training steps against the eager ones (the step
     bodies called directly, ``eager_route``): (a)
     ``HybridEngine`` at GPT-3 1.3B's widths on 4 layers, fp32, batch 2
     x 2048, remat "dots", 3 steps a route from one ``init(seed=0)``:
     losses, every parameter and every Adam slot at ``TOL["float32"]``
     (the largest difference printed), then again with dropout 0.1 and
     ``accum_steps=2`` (the routes' masks equal, and different from step
     to step); (b) bf16 phase 7's cell and 15 (b)'s ResNet-50 at batch
     32, each route: ms/step, device ms/step and busy share from a run
     traced by the ported ``Profiler`` (one ``hybrid_engine::step`` or
     ``hapi::train_step`` span a step in its chrome export), peak
     memory (the 1.3B graph route's held within 10 % of the eager
     route's) and the graph's pool, beside the card's name and power
     limit; (c) ``eval_batch`` of ResNet-50 with batch norm in train
     mode: the graph's loss and logits equal the eager route's, the
     buffers unchanged; ``fit`` over two epochs with a tail batch
     captures twice an epoch;
 18. the deployment path: (a) ``nn.TransformerEncoder`` at BERT-base
     widths (12 layers, eval, seed 0) through ``jit.to_static`` at
     [32, 512, 768] and [8, 128, 768] (two builds, then replays equal
     to the eager forward to the bit), ``jit.save`` from CPU tensors and
     ``jit.load`` on the card (the CPU-exported program launches the
     flash kernel), and ``create_predictor`` at fp32 (the saved
     program), bf16 (``set_model``) and int8 (``PTQ`` scales from 4
     calibration batches): each replay equal to the same program run
     eagerly, 12 flash launches a call counted through the replays,
     fp32 equal to the eager forward and within 1e-4 of the plain
     attention, bf16 and int8 within the JAX tests' bounds of fp32; ms
     a batch on the graph and eagerly, busy share, device ms by kind,
     peak memory, graph pool and captures; (b) a ``static.Program``
     around the encoder (``src`` [None, 512, 768]) run by the
     ``Executor`` at batch 32 and 8 (equal to the eager forward, an
     in-place weight update seen, one capture a feed signature), with
     ``AmpBf16Pass``, and a program holding ``cond`` on its eager route;
     (c) ``GenerationPredictor`` over phase 4's 1.3B engine knobs and
     prompts: tokens identical to ``Engine.generate``, one capture,
     tok/s and ragged launches; (d) ResNet-50 at 224² through the bf16
     predictor at batch 32 and 128: imgs/s and busy share;
 19. fault-tolerant training: (a) hapi ResNet-50 (bf16 O1, batch 32, 24
     seeded batches, ``train_batch`` as a graph) with the async
     ``CheckpointCallback`` every 4 steps, ``GoodputMonitor``,
     ``HealthMonitor(rollback)`` and ``IntegrityCallback``: uninterrupted
     here, then in a child (``chip_smoke.py --child fit LOG``) under
     ``TrainingSupervisor`` killed at global step 10 through
     ``PADDLE_TPU_FAULTS``: one restart, the resume from step 8, losses
     and final params, buffers and slots bitwise equal, 0 divergences,
     one capture a process; (b) a NaN batch rolled back once, the
     window recorded, the losses past it those of a run without it; (c)
     the cross-rank bitflip protocol on the card: rank 1 and
     ``params/0.bias`` named, repaired bitwise; (d) ``HybridEngine`` at
     the 1.3B widths on 4 layers: 6 steps against 3 + async save + a
     new engine + 3, and an in-place rewind of the live engine, bitwise,
     one capture; the save, stall, restore and D2H figures; (e) (a)'s
     goodput and MFU; (f) the device CRC32's digests equal zlib's (fp32,
     bf16, int64, 0-d, empty, odd sizes, a strided view, one launch),
     then the sentinel's cost at the MLP checked against its 3 % bound
     and ResNet-50's printed, and the crc32 kernel's times; (g) the
     flash backward's dQ (and a ring pair's sums) bitwise over 20
     repeats at phase 5's and phase 8's shapes; first, the ops torch
     names nondeterministic in one eager step of each path;
 20. the op corpus and a Paddle program: (a) every op of the port's
     registry (``paddle.core.list_ops()``, 284) on the card against the
     port on the CPU, fp32 with TF32 off, from the CPU conformance test's
     cases (``tests/torch_op_cases.py``), outputs and gradients at 1e-4
     (linear algebra 1e-3), qr/svd/eigh by reconstruction, the random
     ops by seeded reproducibility; (b) the Paddle-style GPT of
     ``paddle_tpu_torch/models/paddle_gpt.py`` (top-level surface only)
     at GPT-3 1.3B's widths on 2 layers, batch 2 x 2048: its fp32
     forward and backward against ``gpt_loss`` on the same tree (loss
     and every gradient at ``TOL["float32"]``), then 3 AdamW steps under
     bf16 ``auto_cast``, the loss falling, flash launches held to 2
     forward and 2 backward a step;
 21. the data pipeline and the domain libraries (DataLoader workers,
     the PTB LSTM, the fused encoder, detection and domain ops, save and
     load);
 22. worlds of ranks on the one card, each launched through the port's
     launcher (``python -m paddle_tpu_torch.distributed.launch
     --nproc_per_node N --backend gloo chip_smoke.py --child hybrid
     CASES OUT``, every rank writing its results; a failing rank fails
     the phase).  (a)-(e) run in one world of 4 ranks, each case on an
     engine of its grid over the world; their oracles (the one-process
     engine on the same config and global batch, eager) run in this
     process while the ranks start, the ranks waiting for them: GPT-3
     1.3B widths, bf16, remat "dots", 2 steps (1 timed) of (a) dp 2 x mp
     2 and (b) ZeRO-2 sharding 4 on 4 layers at global batch 4 x 2048,
     (c) the ring across 4 sep ranks and (d) Ulysses sep 2 x dp 2 on 4
     layers at 8 x 2048, (e) phase 13's MoE (8 experts, top-2, capacity
     that drops nothing, drops checked) at ep 4 on 4 layers: every
     step's loss within ``HYBRID_LOSS_REL`` of the oracle's and every
     leaf's step-1 gradient norm within ``HYBRID_GRAD_REL`` ((e), at
     full width without the aux loss: its own limits, with the routes
     that differ from the oracle's counted), the losses falling, the
     replicas' params bitwise equal (CRC32 on the card), the flash (and
     ring-pair) launches of every rank held to the schedule; first each case's tiny fp32 check (TF32 off) against the
     one-rank engine: losses at 2e-4 / 1e-4 and gathered params at 1e-4
     ((e): tests/test_moe.py's 2e-3 / 5e-3, its aux statistics being
     per rank); each rank's ms/step, peak memory, the collectives' share
     of its step, MB by axis and the transport; (f) phase 13's MoE at
     sep 4 on the one-card ring in this process, each shard gated on
     its own: the bf16 loss and grads on the kernels against the plain
     pair versions with the plain run routed as the kernel run (the
     routes it would have flipped counted), then bf16 steps with the
     launches and the drops of each shard; (g) the sentinel's MLP
     through ``fleet.init(dp_degree=2)``, ``DataParallel`` and
     ``fleet.distributed_optimizer`` on 2 ranks: params bitwise equal
     across the ranks and within 1e-5 of one rank on the whole batch;
     then, in the same world, phase 26 (b)'s tracker case;
 23. the rest of the worlds, in one world of 4 ranks on the one card
     (``--child worlds``), the oracles in this process while the ranks
     start: (a) pp 4 1F1B and (b) pp 4 GPipe on all 24 layers at 8 x
     2048 (8 microbatches), (c) ZeRO-3 sharding 4 and (d) pp 2 x
     sharding 2 at ZeRO-3 on 8 layers at 4 x 2048, each against the
     one-process engine (every step's loss within ``WORLD_LOSS_REL``,
     each leaf's step-1 gradient norm within ``WORLD_GRAD_REL``, the
     flash launches of every rank held to the schedule, the replicated
     windows bitwise equal, a tiny fp32 check at 2e-4 / 1e-4 first);
     the peaks of both schedules at 4 and 8 microbatches (1F1B's flat,
     GPipe's growing) and ZeRO-3's below ZeRO-2's; (e) ``Engine(mesh=)``
     at mp 2 and mp 4 on phase 4's mix: the ragged launches of every
     rank, step-1 logits within ``WORLD_LOGITS_REL`` of the one-process
     engine's, the ranks' tokens equal, tok/s and TTFT; (f) (a)'s world
     at 4 layers saved after step 2 (each window written once, by one
     rank), resumed at dp 2 x mp 2 within (a)'s limits and at pp 4
     bitwise, a bit flipped in one rank's shard named by rank and window
     and repaired from its replica; (g) hapi ``prepare(device_mesh=
     "auto")`` on 4 ranks, a 4-stage ``PipelineLayer`` through
     ``fleet.distributed_model`` and ``PipelineStageExecutor`` on 2
     processes, each within 1e-5 of its one-process run; then a hapi
     fit of the Paddle-style GPT at GPT-3 1.3B widths on 4 layers at dp
     2 x mp 2 (``WORLD_HAPI_GPT``: each parameter in the JAX layout
     through the step, ``eval_batch`` and ``predict_batch``) against the
     one-process hapi fit: losses and eval within ``HYBRID_LOSS_REL``,
     the parameter and gradient bytes inside the step equal to the
     windows' sum from the shapes, the peaks, ms/step, the collectives'
     share and the fp32 flash launches of every rank;
 24. the rest of distributed training (``P24``; worlds of ranks on the
     one card over gloo through the launcher): (a) ``auto_parallel.
     parallelize`` of the JAX test's GPT loss from its three
     annotations at dp 2 x mp 2, ``tiny`` fp32 and GPT-3 1.3B widths on
     2 layers in bf16, 3 SGD steps: the ranks' completed specs equal to
     the one-process propagator's, the losses and step-1 gradient norms
     against one process (``P24_LOSS_REL``, ``P24_GRAD_REL``; fp32
     ``P24_TINY_REL``), parameter bytes a rank below the whole, ms/step,
     the collectives' share and 4 forward / 4 backward flash launches a
     rank a step; (e) in the same world, ``RankMetricsPublisher`` on
     every rank and rank 0's ``ClusterAggregator``: the merged
     Prometheus text parses, every series carries its rank, the skew
     gauge is there, and the chrome export holds collective spans beside
     the steps; (b) ``TrainingSupervisor(elastic=, hosts=)`` over a
     2-rank dp world (GPT-3 1.3B widths, 4 layers, 2 x 2048, a windowed
     checkpoint every 2 steps): the second host's agent killed after
     step 4, lost_node seen, the world ended, the rendezvous waits for
     the host, the relaunch resumes from step 4 and its losses equal the
     uninterrupted world's bit for bit; (c) ``TrainingSupervisor(
     hang_watchdog=)`` over phase 22 (g)'s MLP at dp 2: rank 1 stalled
     at ``collective.all_reduce`` in step 3, the watchdog names rank 1
     and the seq, the bundles hold the thread stacks and the in-flight
     record, the relaunch resumes bitwise, and the flight recorder's
     cost on the step stays under ``RECORDER_BOUND``; (d) the parameter
     server at ``bench.py``'s ``bench_ps`` configuration (rows/s, pull
     and push p50, row-lock retries) and a hogwild CTR step of 2
     trainers (every touched row within ``PS_TOL`` of init + its
     pushes; one trainer alone equal to numpy exactly).
 25. the serving half of the observability plane at GPT-3 1.3B (run
     after phase 11, on phase 11's engine knobs): (a) ``run_soak`` over
     an autoscaled fleet (2 replicas, up to 4) replaying a seeded
     diurnal + burst + shared-prefix trace in wall time
     (``SOAK_TRAFFIC``) under ``bench_soak``'s chaos timeline and a
     bitflip (``SOAK_CHAOS``), with a ``fleet_availability`` SLO, the
     stack sampler, burn feedback and the run's own telemetry server:
     nothing lost, scale-ups and a scale-down, every chaos event on the
     scraped ``/flight``, the kills on ``/fleet``, the page fired and
     cleared in the report and on ``/slo``, ``/healthz`` 200 after the
     clear, the page's ``/profilez`` capture in a ``slo::`` trace, a
     windowed ``/timeseries`` answer, the device gauge at the last
     scrape equal to the live pools and the params, and after the soak
     the params alone; TTFT p50 / p99, tok/s, the longest drive-loop
     gap (a respawn), the host's scrape and evaluation time against the
     wall, the ragged launches (24 an engine step); (b) two
     ``ReplicaServer``s over one ``TCPStore``: the cohort lands on the
     replica that gossiped its prefix, a kill's requests read as one
     trace each on ``/traces?fleet=1``, ``/slo?fleet=1`` folds both
     replicas, and the device gauge on ``/metrics`` equals
     ``torch.cuda.memory_allocated()`` at its sample.
 26. recompute in a captured step and the RNG tracker (run after phase
     24): (a) first one dropout in a step scope's ``recompute`` inside a
     ``CapturedStep`` against the body called directly (the generator
     pair's Philox offsets equal step for step, the same masks, the
     recompute's mask the forward's, fresh masks each step); then the
     Paddle-style GPT at GPT-3 1.3B widths (4 layers, 2 x 2048, residual
     dropout 0.1) built twice from one state, once with every block under
     ``distributed.recompute.recompute``: one forward and backward each
     outside any step scope (the dygraph loop around ``recompute``), fp32
     and bf16, loss and gradients bitwise equal, flash forward launches
     doubled and backward equal, the peak lower; then through hapi
     ``train_batch`` (AdamW, 3 steps a run) on the graph route and on
     the eager route (the body called directly in a step scope), fp32
     and bf16 ``auto_cast``: losses, every gradient and every parameter
     after each step bitwise equal across the four runs, the loss
     falling, a graph run at lr 0 with distinct losses (fresh masks),
     flash forward launches 8 a step with recompute and 4 without,
     backward 8 (fp32) / 4 (bf16), one capture; the graph pools, the
     eager peaks and ms a step printed; (b) in phase 22 (g)'s 2-rank
     world
     over gloo on the card, after its MLP: ColumnParallelLinear ->
     dropout under the tracker's ``local_seed`` -> RowParallelLinear ->
     dropout under ``global_seed``: the global masks' CRCs equal across
     the ranks, the local ones distinct, two runs' losses bitwise equal,
     the default stream untouched.
The line before the last is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores

# tolerances of kernel vs plain version, both computing in fp32: fp32
# differs by summation order only; bf16 by one rounding of the output
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
# flash kernels vs plain: fp32 differs by summation order over up to S
# products of unit-variance terms; bf16 by one rounding of each output
TOL_FLASH = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
# a bf16 encoder's output on the flash kernels vs on their plain
# versions: the attention's one-rounding differences pass on through the
# output projection, the residual's LayerNorm and the FFN in bf16
# (0.017 max abs measured at BERT-base widths, 12 layers, 32 x 512)
TOL_ENCODER = dict(atol=3e-2, rtol=1.6e-2)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20, reps=10):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's
    time per call (which can exceed a short kernel's) is not timed."""
    fn()                                    # warm up, build, set up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def make_case(torch, *, B, Q, H, hd, P, ps, M, qlens, ctxs, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    tables = torch.stack([torch.randperm(P, generator=g, device="cuda")[:M]
                          for _ in range(B)]).to(torch.int32)
    return (rnd(B, Q, H, hd), rnd(P, ps, H, hd), rnd(P, ps, H, hd), tables,
            torch.tensor(qlens, dtype=torch.int32, device="cuda"),
            torch.tensor(ctxs, dtype=torch.int32, device="cuda"))


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def prepare(torch):
    """fp32 products in full fp32 (the plain versions are held to 1e-4),
    then every kernel built from this checkout's sources; returns the
    build's seconds."""
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def host_us(torch, fn, iters=200):
    """Host microseconds per call of ``fn`` with the device not waited on:
    the wrapper's Python, its allocations and the kernel launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def phase_kernel_vs_plain(torch, pa):
    """Edge cases, then the serving shapes with timings."""
    span = pa.SPLIT_KEYS
    cases = [
        # mid-prefill chunk, decode, idle rows; ctx straddles ps=4 pages
        dict(B=4, Q=6, H=2, hd=128, P=12, ps=4, M=6,
             qlens=[5, 1, 3, 0], ctxs=[7, 8, 9, 0]),
        dict(B=4, Q=6, H=2, hd=128, P=12, ps=4, M=6,
             qlens=[6, 6, 1, 1], ctxs=[7, 8, 9, 24]),
        # qlen == ctx (whole prompt in one chunk), tiles past 16 queries
        dict(B=3, Q=40, H=3, hd=64, P=40, ps=16, M=8,
             qlens=[17, 40, 33], ctxs=[17, 40, 100]),
        # head dims 32 and 256 (other lane widths and key-tile sizes)
        dict(B=2, Q=20, H=2, hd=32, P=20, ps=8, M=10,
             qlens=[20, 1], ctxs=[70, 13]),
        dict(B=2, Q=20, H=2, hd=256, P=20, ps=8, M=10,
             qlens=[19, 1], ctxs=[50, 80]),
        # the kv splits at the serving widths: contexts either side of a
        # split boundary, one key, a 64-token chunk whose tiles merge 5
        # to 8 splits, decode rows at 2048
        dict(B=4, Q=64, H=2, hd=128, P=600, ps=16, M=128,
             qlens=[1, 1, 1, 0], ctxs=[span - 1, span, span + 1, 0]),
        dict(B=4, Q=64, H=2, hd=128, P=600, ps=16, M=128,
             qlens=[64, 1, 1, 40], ctxs=[2048, 1, 2048, 2 * span])
    ] + [
        # head dims off the 64/128-column chunks and past 128: zero-filled
        # tails, one element a load where a row is not a multiple of 16
        # bytes (hd 17 in both dtypes, 100 in bf16), scores summed over
        # head-dim chunks past 128 and one grid slice per output chunk
        dict(B=3, Q=20, H=2, hd=hd, P=20, ps=8, M=10, qlens=[17, 1, 0],
             ctxs=[60, 75, 0])
        for hd in (16, 17, 48, 80, 100, 320, 512, 544, 1024)
    ]
    n = 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for seed, c in enumerate(cases):
            q, kp, vp, tb, ql, cl = make_case(torch, dtype=dtype, seed=seed,
                                              **c)
            scale = 1.0 / np.sqrt(c["hd"])
            out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
            ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl, scale)
            torch.cuda.synchronize()
            check(out.dtype == q.dtype and out.shape == q.shape,
                  "kernel output dtype/shape")
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            err = max_err(torch, out, ref)
            check(torch.allclose(out.float(), ref.float(),
                                 **TOL[dtype_name]),
                  f"kernel != plain ({dtype_name}, case {seed}): max abs "
                  f"err {err:.3g}")
            n += 1
        # the Q == 1 decode entry
        q, kp, vp, tb, _, _ = make_case(torch, B=4, Q=1, H=4, hd=128, P=16,
                                        ps=16, M=4, qlens=[1, 1, 1, 0],
                                        ctxs=[9, 4, 64, 0], dtype=dtype,
                                        seed=99)
        seq = torch.tensor([9, 4, 64, 0], dtype=torch.int32, device="cuda")
        out = pa.paged_attention(q[:, 0], kp, vp, tb, seq)
        ref = pa._ragged_attention_ref(
            q, kp, vp, tb, (seq > 0).to(torch.int32), seq,
            1.0 / np.sqrt(128))[:, 0]
        torch.cuda.synchronize()
        check(torch.allclose(out.float(), ref.float(), **TOL[dtype_name]),
              f"decode entry != plain ({dtype_name}): "
              f"{max_err(torch, out, ref):.3g}")
        n += 1
    print(f"[phase 2] {n} edge cases agree (head dims 16, 17, 32, 48, 64, "
          f"80, 100, 128, 256, 320, 512, 544, 1024; kv splits of {span} "
          f"keys; fp32 atol=rtol=1e-5; bf16 atol 1e-2 rtol 1.6e-2)")

    # ---- serving shape: one chunk row of 64 + 7 decode rows, bf16; then
    # every row decoding at the longest context
    res = ragged_shape(torch, pa, "serving shape", [64] + [1] * 7,
                       [1024, 64, 2048, 1500, 700, 300, 128, 2000])
    res["decode_shape"] = ragged_shape(torch, pa, "all-decode shape",
                                       [1] * 8, [2048] * 8)
    return res


def ragged_shape(torch, pa, name, qlens, ctxs):
    """The kernel against the plain version at one batch of the serving
    engine's shapes (q [8, 64, 16, 128] bf16 over pages [2048, 16, 16,
    128]), then its time, the plain version's, SDPA's and the bound."""
    B, Q, H, hd, P, ps, M = 8, 64, 16, 128, 2048, 16, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, Q, H, hd), generator=g, device="cuda").bfloat16()
    kp = torch.randn((P, ps, H, hd), generator=g, device="cuda").bfloat16()
    vp = torch.randn((P, ps, H, hd), generator=g, device="cuda").bfloat16()
    tb = torch.randperm(P, generator=g, device="cuda")[:B * M] \
        .view(B, M).to(torch.int32)
    ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(hd)
    out = pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)
    ref = pa._ragged_attention_ref(q, kp, vp, tb, ql, cl, scale)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref)
    check(torch.allclose(out.float(), ref.float(), **TOL["bfloat16"]),
          f"kernel != plain at the {name}: max abs err {err:.3g}")

    # the kernel's device time (the call captured in a CUDA graph, as a
    # serving step would run it), and the time of calls made one by one,
    # where the wrapper's host time can set the pace
    def call():
        return pa.ragged_paged_attention(q, kp, vp, tb, ql, cl)

    ms = graph_ms(torch, call)
    eager_ms = time_ms(torch, call, 100)
    plain_ms = time_ms(torch, lambda: pa._ragged_attention_ref(
        q, kp, vp, tb, ql, cl, scale), 10)
    # library yardstick: SDPA over the gathered dense K/V with the same
    # causal-at-offset mask (the gather itself is not timed)
    S = M * ps
    kd = kp[tb.long()].reshape(B, S, H, hd).transpose(1, 2)
    vd = vp[tb.long()].reshape(B, S, H, hd).transpose(1, 2)
    qd = q.transpose(1, 2)
    t = torch.arange(S, device="cuda")
    tq = torch.arange(Q, device="cuda")
    pos = (cl - ql).long()[:, None] + tq[None, :]
    mask = (t[None, None, :] <= pos[:, :, None])[:, None]       # [B,1,Q,S]
    import torch.nn.functional as F

    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale))
    # least time: the bytes this call must move (live queries read, the
    # whole output written, each row's live K/V and page ids read once)
    kv_bytes = sum(ctxs) * H * hd * 2 * 2
    q_bytes = sum(qlens) * H * hd * 2
    out_bytes = B * Q * H * hd * 2
    meta_bytes = sum(-(-c // ps) for c in ctxs) * 4 + 2 * B * 4
    nbytes = kv_bytes + q_bytes + out_bytes + meta_bytes
    flops = sum((c - ql_ + t_ + 1) * H * hd * 4
                for ql_, c in zip(qlens, ctxs) for t_ in range(ql_))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[phase 2] {name} q{[B, Q, H, hd]} pages{[P, ps, H, hd]} "
          f"bf16, query lens {qlens}, contexts {ctxs}: kernel {ms:.4f} ms "
          f"(device, CUDA graph; {eager_ms:.4f} ms a call made from the "
          f"host), plain {plain_ms:.4f}"
          f" ms, SDPA(dense gathered, CUDA graph) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s; "
          f"{flops / 1e9:.3f} GFLOP), max abs err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "eager_ms": eager_ms}


MIXED_QLENS = [64, 1, 1, 1, 1, 1, 1, 0]
MIXED_CTXS = [256, 100, 513, 1024, 2000, 37, 700, 0]


def mixed_batch(torch, cfg, P, dtype):
    """Phase 3's batch on a pool of ``P`` pages of 16 with random older
    context: row 0 a mid-prefill chunk (positions 192..255), rows 1-6
    decode, row 7 idle, one padding token.  Returns (step arguments
    tokens/rows/slots/qlens/ctxs, k_pages, v_pages, page tables, Q); the
    pools hold the step's scratch page after the ``P`` pages, which no
    table points to."""
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    ps, B, Q = 16, 8, 64
    M = cfg.max_seq_len // ps
    g = torch.Generator(device="cuda").manual_seed(11)
    k0 = torch.randn((L, P + 1, ps, H, hd), generator=g, device="cuda",
                     dtype=dtype)
    v0 = torch.randn((L, P + 1, ps, H, hd), generator=g, device="cuda",
                     dtype=dtype)
    tables = torch.randperm(P, generator=g, device="cuda")[:B * M] \
        .view(B, M).to(torch.int32)
    T = Q + B - 1
    rows = np.full(T, B, np.int32)
    slots = np.zeros(T, np.int32)
    off = 0
    for b, n in enumerate(MIXED_QLENS):
        rows[off:off + n] = b
        slots[off:off + n] = np.arange(n)
        off += n
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, T).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    args = (dev(tokens), dev(rows), dev(slots), dev(MIXED_QLENS),
            dev(MIXED_CTXS))
    return args, k0, v0, tables, Q


def phase_full_step(torch, cfg, params, pa, gpt_ragged_step):
    """One full-width step, kernel vs plain attention on equal inputs."""
    L = cfg.num_layers
    args, k0, v0, tables, Q = mixed_batch(torch, cfg, 2048, torch.bfloat16)
    qlens = MIXED_QLENS
    k1, v1 = k0.clone(), v0.clone()
    t0 = time.perf_counter()
    lk, _, _ = gpt_ragged_step(cfg, params, *args, k1, v1, tables, max_q=Q)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    lp, _, _ = gpt_ragged_step(cfg, params, *args, k0, v0, tables, max_q=Q,
                               attention=pa._ragged_attention_ref)
    torch.cuda.synchronize()
    live = torch.tensor([n > 0 for n in qlens], device="cuda")
    lk, lp = lk[live].float(), lp[live].float()
    check(bool(torch.isfinite(lk).all()), "full-width logits not finite")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    # the pages a table can point to: the scratch page takes the padding
    # token's throwaway writes
    P = k0.shape[1] - 1
    page_err = max(float((k1[:, :P] - k0[:, :P]).abs().max()),
                   float((v1[:, :P] - v0[:, :P]).abs().max()))
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"[phase 3] gpt3-1.3b bf16 x{L} layers, batch chunk64+6 decode+"
          f"idle: logits max abs err {err:.4g} (max |logit| {scale:.3g}), "
          f"written pages max abs err {page_err:.4g}, argmax agree "
          f"{agree}/{lk.shape[0]}, first kernel step {t_kernel * 1e3:.1f} ms")
    # both sides compute attention in fp32 and round its output to bf16;
    # one-ulp differences there compound through 24 bf16 layers
    check(err <= 0.05 * max(1.0, scale),
          f"full-width step: kernel vs plain logits differ by {err:.4g}")
    del k0, v0, k1, v1
    torch.cuda.empty_cache()


def serving_prompts(vocab):
    """Phase 4's 8 seeded prompts: 512 tokens and seven of 64-1024, the
    last sharing request 0's first 256 tokens.  Returns (lens, prompts)."""
    rng = np.random.default_rng(0)
    lens = [512] + [int(n) for n in rng.integers(64, 1025, 7)]
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]
    prompts[7] = prompts[0][:256] + prompts[7][256:] \
        if lens[7] > 256 else prompts[0][:256] + prompts[7]
    return lens, prompts


def serve_requests(eng, serving, prompts):
    """Serve ``prompts`` to completion, 32 greedy tokens each; the last
    arrives once request 0's prompt is in the radix cache."""
    sp = serving.SamplingParams(max_new_tokens=32)
    reqs = [eng.add_request(p, sp) for p in prompts[:-1]]
    while reqs[0].prompt_pos < len(prompts[0]):
        eng.step()
    reqs.append(eng.add_request(prompts[-1], sp))
    while eng.has_work():
        eng.step()
    return reqs


def check_one_capture(watchdog, engines, what):
    """Each engine captured its step once, and the compile watchdog
    (reset before the engines were built) saw one build of
    ``serving::unified_step`` an engine and no rebuild.  Returns the
    line the phase prints."""
    caps = [e.captures for e in engines]
    rep = watchdog.report().get("serving::unified_step", {})
    check(all(c == 1 for c in caps),
          f"{what}: engines captured their step {caps} times")
    check(rep.get("compiles") == len(engines)
          and rep.get("recompiles") == 0,
          f"{what}: watchdog report {rep} for {len(engines)} engines")
    return (f"captures {sum(caps)} (watchdog serving::unified_step: "
            f"{rep['calls']} calls, {rep['compiles']} builds, "
            f"{rep['recompiles']} rebuilds, {rep['compile_time_s']:.2f} s "
            f"building)")


def phase_serving(torch, cfg, params, pa, serving, watchdog):
    watchdog.reset()
    eng = serving.Engine(cfg, params, page_size=16, num_pages=2048,
                         max_batch_size=8, chunk_len=64, device="cuda")
    eng.warmup()
    eng.metrics = serving.ServingMetrics()      # drop the warm-up's samples
    finite = []
    run_step = eng._run_step

    def checked(tokens, rows, slots, qlens, ctxs, tables):
        logits = run_step(tokens, rows, slots, qlens, ctxs, tables)
        finite.append(bool(np.isfinite(logits[qlens > 0]).all()))
        return logits

    eng._run_step = checked
    lens, prompts = serving_prompts(cfg.vocab_size)
    torch.cuda.synchronize()
    pa.ragged_paged_attention.launches = 0
    steps0 = eng.steps
    t0 = time.perf_counter()
    reqs = serve_requests(eng, serving, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.ragged_paged_attention.launches
    steps = eng.steps - steps0

    for r in reqs:
        check(r.state == serving.RequestState.FINISHED,
              f"request {r.id} ended {r.state}: {r.finish_reason}")
        check(len(r.output) == 32, f"request {r.id} made {len(r.output)}")
    check(all(finite), "serving logits not finite")
    check(launches == cfg.num_layers * steps,
          f"kernel launches {launches} != {cfg.num_layers} x {steps} steps")
    captures = check_one_capture(watchdog, [eng], "serving")
    snap = eng.metrics.snapshot()
    check(snap["prefix_cache"]["hits"] >= 1, "no prefix-cache hit")
    gen = sum(len(r.output) for r in reqs)
    ttft, dec = snap["ttft_s"], snap["decode_token_s"]
    print(f"[phase 4] served {len(reqs)} requests (prompts {lens}, 32 new "
          f"tokens each, greedy) in {steps} steps, {wall:.3f} s: "
          f"{gen / wall:.1f} generated tok/s, TTFT p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p95 {ttft['p95'] * 1e3:.1f} ms, "
          f"decode {dec['mean'] * 1e3:.3f} ms/token (step time / rows), "
          f"mean step {wall / steps * 1e3:.2f} ms, prefix hits "
          f"{snap['prefix_cache']['hits']} ({snap['prefix_cache']['hit_tokens']}"
          f" tokens), kernel launches {launches} = {cfg.num_layers} x "
          f"{steps}, {captures}")
    profile_serving(torch, eng, serving, cfg.vocab_size)
    return launches


def profile_serving(torch, eng, serving, vocab, tag="phase 4", experts=0):
    """Where a serving step's time goes: the same request mix is run
    untraced (step wall time) and then traced with torch.profiler
    (device time by kernel), on fresh prompts so neither run hits the
    other's prefix cache.  Runs after the launch count was read.  With
    ``experts`` (a MoE model) the expert products and the routing,
    dispatch and combine are split out of the matrix products and the
    rest (``moe_split``)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    sp = serving.SamplingParams(max_new_tokens=8)

    def fresh():
        return [[int(t) for t in rng.integers(0, vocab, n)]
                for n in (700, 300, 64, 64)]

    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(fresh(), sp)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / (eng.steps - steps0)
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(experts)) as prof:
        eng.generate(fresh(), sp)
        torch.cuda.synchronize()
    steps = eng.steps - steps0
    by_kind = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        # device-side kernel events only: the CPU ops that launched them
        # carry the same device time again, and a range's device-side
        # span is not a kernel
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith(("engine::", "moe::", "serving::")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = e.key.lower()
        kind = ("attention" if "ragged_paged_attention" in key else
                "matmul" if any(w in key for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "cublas"))
                else "other")
        by_kind[kind] += us
        top.append((us, e.key[:48]))
    busy = sum(by_kind.values()) / steps
    check(busy > 0, "profiler saw no device time")
    if experts:
        split_moe_kinds(by_kind, "matmul", moe_split(torch, prof, experts))
    print(f"[{tag}] step breakdown over {steps} steps (prompts 700, 300, "
          f"64, 64; 8 new tokens): untraced {step_us / 1e3:.3f} ms/step, "
          f"device {busy / 1e3:.3f} ms/step (busy share "
          f"{busy / step_us:.3f}); device time by kind: "
          + ", ".join(f"{k} {v / steps / 1e3:.3f} ms/step"
                      for k, v in by_kind.items()))
    print(f"[{tag}] top device kernels, ms/step: " + "; ".join(
        f"{name} {us / steps / 1e3:.3f}" for us, name in sorted(top)[::-1][:6]))


# ------------------------------------------- the captured step (16)

GRAPH_DEFRAG_AT = 40               # phase 16's defrag: after this step
#: phase 16's MoE comparison runs the first 8 of phase 12's 24 layers
#: (cut from 24 when phase 25 joined the script: the traced eager MoE
#: steps set the phase's time)
GRAPH_MOE_LAYERS = 8


def eager_engine_class(serving, gpt_ragged_step):
    """The port's Engine with the step it had before it captured one:
    ``gpt_ragged_step`` called eagerly every step on tensors copied from
    the host arrays, logits read back with ``.float().cpu().numpy()``.
    Phase 16's baseline; the Engine itself has no eager route on the
    card, as the JAX engine has none beside its jit."""
    import torch

    class EagerEngine(serving.Engine):
        def _run_step(self, tokens, rows, slots, qlens, ctxs, tables):
            dev = self.device

            def put(a):
                return torch.from_numpy(a).to(dev, non_blocking=True)

            logits, _, _ = gpt_ragged_step(
                self.cfg, self.params, put(tokens), put(rows), put(slots),
                put(qlens), put(ctxs), self.cache.k_pages,
                self.cache.v_pages, put(tables), max_q=self.chunk_len)
            self.steps += 1
            return logits.float().cpu().numpy()

    return EagerEngine


def serve_with_defrag(eng, serving, prompts):
    """``serve_requests`` with a ``defrag()`` after GRAPH_DEFRAG_AT steps
    (pages of finished requests leave holes below live ones by then).
    Returns (requests, pages moved)."""
    sp = serving.SamplingParams(max_new_tokens=32)
    steps0 = eng.steps
    moved = None
    reqs = [eng.add_request(p, sp) for p in prompts[:-1]]

    def step():
        nonlocal moved
        eng.step()
        if moved is None and eng.steps - steps0 >= GRAPH_DEFRAG_AT:
            moved = eng.cache.defrag()

    while reqs[0].prompt_pos < len(prompts[0]):
        step()
    reqs.append(eng.add_request(prompts[-1], sp))
    while eng.has_work():
        step()
    return reqs, moved


def profiled_steps(torch, eng, serving, vocab, tmp):
    """Host ms/step untraced, then device ms/step from the ported
    ``Profiler``'s device trace (``torch.profiler``) over the same
    request mix on fresh prompts, its chrome export holding one
    ``serving::unified_step`` span a step.  Returns (host ms/step,
    device ms/step, steps traced)."""
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    rng = np.random.RandomState(16)
    sp = serving.SamplingParams(max_new_tokens=8)

    def fresh():
        return [[int(t) for t in rng.randint(0, vocab, n)]
                for n in (700, 300, 64, 64)]

    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(fresh(), sp)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / (eng.steps - steps0)
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                    emit_counters=False)
    steps0 = eng.steps
    with prof:
        eng.generate(fresh(), sp)
    steps = eng.steps - steps0
    path = os.path.join(tmp, f"{type(eng).__name__}_{id(eng)}.json")
    prof.export(path)
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X" and e["name"] == "serving::unified_step"]
    check(len(spans) == steps,
          f"chrome export holds {len(spans)} serving::unified_step spans "
          f"for {steps} steps")
    us = 0.0
    for e in prof.device_profile.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith(("serving::", "moe::")):
            continue
        t = getattr(e, "self_device_time_total", None)
        us += getattr(e, "self_cuda_time_total", 0.0) if t is None else t
    check(us > 0, "the profiler saw no device time")
    return host_ms, us / steps / 1e3, steps


def phase_graph_vs_eager(torch, cfg, params, pa, serving, gpt_ragged_step,
                         watchdog, name):
    """Phase 16: phase 4's engine and requests on ``params``, one engine
    on the eager step (``eager_engine_class``) and one on the captured
    step, each with a ``defrag()`` mid-run: greedy tokens identical,
    pages equal, the graph engine built once (watchdog) and the kernel's
    launches 24 a step on both; ms/step on the host, device ms/step and
    busy share from a profiled run, tok/s."""
    import tempfile

    L = cfg.num_layers
    lens, prompts = serving_prompts(cfg.vocab_size)
    EagerEngine = eager_engine_class(serving, gpt_ragged_step)
    runs, engines = {}, {}
    for route, cls in (("eager", EagerEngine), ("graph", serving.Engine)):
        watchdog.reset()
        eng = cls(cfg, params, page_size=16, num_pages=2048,
                  max_batch_size=8, chunk_len=64, device="cuda")
        eng.warmup()
        torch.cuda.synchronize()
        pa.ragged_paged_attention.launches = 0
        steps0 = eng.steps
        t0 = time.perf_counter()
        reqs, moved = serve_with_defrag(eng, serving, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.ragged_paged_attention.launches
        steps = eng.steps - steps0
        rep = watchdog.report().get("serving::unified_step", {})
        for r in reqs:
            check(r.state == serving.RequestState.FINISHED
                  and len(r.output) == 32,
                  f"{name} {route}: request {r.id} ended {r.state} with "
                  f"{len(r.output)} tokens")
        check(moved, f"{name} {route}: the defrag moved no page")
        check(launches == L * steps,
              f"{name} {route}: kernel launches {launches} != {L} x "
              f"{steps} steps")
        if route == "graph":
            captures = check_one_capture(watchdog, [eng], f"{name} graph")
        else:
            check(eng.captures == 0 and rep.get("calls", 0) == 0,
                  f"{name} eager: the eager engine went through the "
                  f"captured step ({rep})")
            captures = "captures 0"
        gen = sum(len(r.output) for r in reqs)
        runs[route] = dict(tokens=[r.output for r in reqs], steps=steps,
                           wall=wall, gen=gen, launches=launches,
                           moved=moved, captures=captures)
        engines[route] = eng
    e, g = engines["eager"], engines["graph"]
    P = e.cache.num_pages
    same_tokens = runs["eager"]["tokens"] == runs["graph"]["tokens"]
    page_err = max(max_err(torch, e.cache.k_pages[:, :P],
                           g.cache.k_pages[:, :P]),
                   max_err(torch, e.cache.v_pages[:, :P],
                           g.cache.v_pages[:, :P]))
    check(same_tokens, f"{name}: graph and eager greedy tokens differ")
    check(runs["eager"]["steps"] == runs["graph"]["steps"]
          and runs["eager"]["moved"] == runs["graph"]["moved"],
          f"{name}: the routes ran different schedules")
    check(page_err == 0.0, f"{name}: graph and eager pages differ by "
                           f"{page_err:.3g}")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        for route, eng in engines.items():
            host_ms, dev_ms, n = profiled_steps(torch, eng, serving,
                                                cfg.vocab_size, tmp)
            r = runs[route]
            print(f"[phase 16] {name} {route}: {r['steps']} steps (defrag "
                  f"after {GRAPH_DEFRAG_AT}, {r['moved']} pages moved) in "
                  f"{r['wall']:.3f} s: {r['wall'] / r['steps'] * 1e3:.3f} "
                  f"ms/step, {r['gen'] / r['wall']:.1f} generated tok/s; "
                  f"profiled run ({n} steps, prompts 700, 300, 64, 64; 8 "
                  f"new tokens): host {host_ms:.3f} ms/step, device "
                  f"{dev_ms:.3f} ms/step, busy share "
                  f"{dev_ms / host_ms:.3f}; launches {r['launches']} = "
                  f"{L} x {r['steps']}; {r['captures']} ({card})")
    speed = runs["eager"]["wall"] / runs["graph"]["wall"]
    print(f"[phase 16] {name}: greedy tokens identical: {same_tokens}; "
          f"pages max abs diff {page_err:.3g}; graph / eager tok/s "
          f"{speed:.2f}x")
    if cfg.moe_experts:
        # the device time by kind, MoE work apart, from the eager route's
        # launching ops; the graph replays the same kernels
        profile_serving(torch, e, serving, cfg.vocab_size,
                        tag=f"phase 16 {name} eager",
                        experts=cfg.moe_experts)
    del e, g, engines
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------ flash attention (5-7)


def flash_work(B, H, S, D, causal, nbytes_el=2):
    """(bytes, FLOPs) each flash kernel must move and do for one call on
    these inputs: every input read once, every output written once, and
    the products of the live (q, k) pairs only (k <= q when causal).  The
    backward is one kernel: q, k, v, dO, lse and delta in, dq, dk, dv out,
    five products (S, dP, dV, dK, dQ: 10 * D FLOPs a pair)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    mat = B * H * S * D * nbytes_el            # one [B, H, S, D] tensor
    rows = B * H * S * 4                       # one fp32 [B, H, S] vector
    return {"fwd": (4 * mat + rows, 4 * D * pairs),
            "bwd": (7 * mat + 2 * rows, 10 * D * pairs)}


def phase_flash_kernels(torch, fa, ra):
    """Edge cases, then the training shapes with timings."""
    n = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(S, causal) for S in (1, 17, 64, 200, 256)
             for causal in (True, False) if causal or S != 200]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = TOL_FLASH[dtype_name]
        # 192 pads to 256, 320 to 512; bf16 past 256 runs in fp32
        for D in (32, 64, 128, 192, 256, 320, 512):
            for S, causal in cases:
                g = torch.Generator(device="cuda").manual_seed(n)
                q, k, v, do = (torch.randn((2, 3, S, D), generator=g,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                scale = 1.0 / np.sqrt(D)
                out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
                ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, causal)
                dq, dk, dv = fa._flash_bwd_cuda(q, k, v, ref, ref_lse, do,
                                                scale, causal)
                rq, rk, rv = fa._flash_bwd_ref(q, k, v, ref, ref_lse, do,
                                               scale, causal)
                torch.cuda.synchronize()
                pairs = (("out", out, ref), ("dq", dq, rq), ("dk", dk, rk),
                         ("dv", dv, rv))
                for name, a, b in pairs:
                    check(a.dtype == dtype and a.shape == b.shape,
                          f"flash {name} dtype/shape")
                    check(bool(torch.isfinite(a).all()),
                          f"flash {name} not finite")
                    err = max_err(torch, a, b)
                    worst[dtype_name] = max(worst[dtype_name], err)
                    check(torch.allclose(a.float(), b.float(), **tol),
                          f"flash {name} kernel != plain ({dtype_name}, "
                          f"S={S}, D={D}, causal={causal}): max abs err "
                          f"{err:.3g}")
                check(torch.allclose(lse, ref_lse, **TOL_FLASH["float32"]),
                      f"flash lse kernel != plain ({dtype_name}, S={S}, "
                      f"D={D}, causal={causal})")
                n += 1
    print(f"[phase 5] {n} flash edge cases agree on out, lse, dq, dk, dv "
          f"(head dims 32-512; fp32 atol=rtol=1e-4, worst "
          f"{worst['float32']:.3g}; bf16 atol 1e-2 rtol 1.6e-2, worst "
          f"{worst['bfloat16']:.3g})")
    # past 512: padded to 1024, two 512-column chunks (bf16 in fp32),
    # through the public entries with their gradients
    D = 640
    for dtype_name in ("float32", "bfloat16"):
        g = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn((2, 2, 256, D), generator=g,
                                   device="cuda").to(getattr(torch,
                                                             dtype_name))
                       for _ in range(4))
        for name, fn in (("flash_attention", lambda *a: fa.flash_attention(
                              *a, causal=True)),
                         ("ring_attention sep=2", lambda *a:
                          ra.ring_attention(*a, sep=2))):
            outs = []
            for f in (fn, lambda *a: fa.flash_attention_plain(*a,
                                                              causal=True)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = f(*leaves)
                out.backward(do)
                outs.append([out.detach()] + [t.grad for t in leaves])
            torch.cuda.synchronize()
            for part, a, b in zip(("out", "dq", "dk", "dv"), *outs):
                check(a.dtype == q.dtype and a.shape == q.shape,
                      f"{name} D={D} {part} dtype/shape")
                check(torch.allclose(a.float(), b.float(),
                                     **TOL_FLASH[dtype_name]),
                      f"{name} D={D} {part} != plain ({dtype_name}): max "
                      f"abs err {max_err(torch, a, b):.3g}")
    print(f"[phase 5] flash_attention and ring_attention (sep=2) at head "
          f"dim {D}, S=256, causal: out, dq, dk, dv equal the plain "
          f"version in fp32 and bf16")

    # ---- training shapes: GPT-3 1.3B, batch 8 x 2048, bf16, causal
    B, H, S, D = 8, 16, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, True)
    delta = fa._delta(ref, do)
    dq, dk, dv = fa._bwd_sm90(q, k, v, do, ref_lse, delta, scale, True)
    rk, rv = fa._bwd_dkdv_ref(q, k, v, do, ref_lse, delta, scale, True)
    rq = fa._bwd_dq_ref(q, k, v, do, ref_lse, delta, scale, True)
    torch.cuda.synchronize()
    errs = {"fwd": max(max_err(torch, out, ref),
                       max_err(torch, lse, ref_lse)),
            "bwd": max(max_err(torch, dq, rq), max_err(torch, dk, rk),
                       max_err(torch, dv, rv))}
    for name, a, b in (("out", out, ref), ("dq", dq, rq), ("dk", dk, rk),
                       ("dv", dv, rv)):
        check(torch.allclose(a.float(), b.float(), **TOL_FLASH["bfloat16"]),
              f"flash {name} kernel != plain at the training shapes: "
              f"{max_err(torch, a, b):.3g}")
    del ref, rk, rv, rq
    torch.cuda.empty_cache()

    # the backward kernel alone: one launch on fixed buffers (dQ keeps
    # adding into the same fp32 sums, which changes no time) after a
    # memset of its turn counters
    lib = fa._lib_bwd_sm90()
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device="cuda")
    gk, gv = torch.empty_like(q), torch.empty_like(q)
    turns = fa._dq_turns(q)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel_alone():
        rc = lib.flash_bwd_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), turns.zero_().data_ptr(), B * H, S, D,
            float(scale), 1, stream)
        check(rc == 0, f"flash_bwd_sm90_launch returned {rc}")

    ms = {"fwd": time_ms(torch, lambda: fa._flash_fwd_cuda(
              q, k, v, scale, True), 10),
          # the whole call: zeroing the dQ sums, the kernel, the cast
          "bwd": time_ms(torch, lambda: fa._bwd_sm90(
              q, k, v, do, lse, delta, scale, True), 10)}
    kernel_ms = time_ms(torch, kernel_alone, 10)
    del acc, gk, gv
    plain_ms = {"fwd": time_ms(torch, lambda: fa._flash_fwd_ref(
                    q, k, v, scale, True), 3, warmup=1),
                "bwd": time_ms(torch, lambda: (fa._bwd_dkdv_ref(
                    q, k, v, do, lse, delta, scale, True), fa._bwd_dq_ref(
                    q, k, v, do, lse, delta, scale, True)), 3, warmup=1)}
    torch.cuda.empty_cache()
    # library yardstick: PyTorch's SDPA (the port never calls it); its
    # forward against the forward kernel, its backward (dq, dk, dv in
    # one call) against the backward call
    import torch.nn.functional as F

    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        lq.detach(), lk.detach(), lv.detach(), is_causal=True), 10)
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do, retain_graph=True), 10)
    del lout
    library_ms = {"fwd": lib_fwd, "bwd": lib_bwd}

    result = {}
    for name, (nbytes, flops) in flash_work(B, H, S, D, True).items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        result[name] = {
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms[name]}
        print(f"[phase 5] flash {name} at q/k/v {[B, H, S, D]} bf16 "
              f"causal: {'whole call ' if name == 'bwd' else 'kernel '}"
              f"{ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({flops / 1e9:.1f} GFLOP at "
              f"989 TFLOP/s; {nbytes / 1e6:.1f} MB at 3.35 TB/s), max abs "
              f"err {errs[name]:.3g}; {flops / ms[name] / 1e9:.1f} TFLOP/s "
              f"achieved")
    bwd_flops = flash_work(B, H, S, D, True)["bwd"][1]
    print(f"[phase 5] flash bwd (flash_bwd_sm90.cu, one launch) at q/k/v "
          f"{[B, H, S, D]} bf16 causal: kernel alone {kernel_ms:.4f} ms "
          f"({bwd_flops / kernel_ms / 1e9:.1f} TFLOP/s), whole call "
          f"(zeroing, kernel, cast) {ms['bwd']:.4f} ms, SDPA backward "
          f"{lib_bwd:.4f} ms, bound at 10 D FLOPs a pair "
          f"{result['bwd']['bound_ms']:.4f} ms; the call is "
          + ("no slower than" if ms["bwd"] <= lib_bwd else "slower than")
          + " SDPA's backward")
    print(f"[phase 5] library: SDPA forward {lib_fwd:.4f} ms (vs fwd), "
          f"SDPA backward {lib_bwd:.4f} ms (dq, dk, dv in one call)")
    result["bwd"]["kernel_ms"] = kernel_ms
    del dq, dk, dv, lq, lk, lv
    # fp32 inputs take the scalar-FMA kernels (not the training path):
    # their times at the same shapes
    q, k, v, do = (t.float() for t in (q, k, v, do))
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    delta = fa._delta(out, do)
    f32 = {"fwd": time_ms(torch, lambda: fa._flash_fwd_cuda(
               q, k, v, scale, True), 3, warmup=1),
           "bwd_dkdv": time_ms(torch, lambda: fa._bwd_dkdv_cuda(
               q, k, v, do, lse, delta, scale, True), 2, warmup=1),
           "bwd_dq": time_ms(torch, lambda: fa._bwd_dq_cuda(
               q, k, v, do, lse, delta, scale, True), 2, warmup=1)}
    print("[phase 5] fp32 inputs (scalar FMA kernels) at the same shapes: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in f32.items()))
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    # the forward's host cost per launch at a ring pair's shape (480
    # launches a ring step): bf16 with its three TMA maps found in the
    # cache, bf16 with every map encoded (each call on tensors at new
    # addresses: views into one buffer at 16-byte steps, cycling through
    # more than the cache's 256 entries hold), and the fp32 entry, through
    # the same wrapper, which encodes none; three rounds in turns, the
    # least of each kept (the host's clock moves with its other load)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (B, H, 512, D)
    numel = B * H * 512 * D
    views = 300
    bufs = [torch.randn(numel + 8 * views, generator=g, device="cuda")
            .bfloat16() for _ in range(3)]
    fresh = [[b[8 * i:8 * i + numel].view(shape) for b in bufs]
             for i in range(views)]
    calls = iter(range(10 ** 9))

    def uncached():
        a, b, c = fresh[next(calls) % views]
        fa._flash_fwd_cuda(a, b, c, scale, False)

    a, b, c = fresh[0]
    a32, b32, c32 = (t.float() for t in fresh[0])
    kinds = {"bf16 cached maps": lambda: fa._flash_fwd_cuda(a, b, c, scale,
                                                           False),
             "bf16 maps encoded": uncached,
             "fp32 (no maps)": lambda: fa._flash_fwd_cuda(a32, b32, c32,
                                                         scale, False)}
    us = {n: [] for n in kinds}
    for order in (list(kinds), list(kinds)[::-1], list(kinds)):
        for n in order:
            us[n].append(host_us(torch, kinds[n]))
    print(f"[phase 5] flash fwd host time per call at q/k/v [{B}, {H}, "
          f"512, {D}] (wrapper and launch, device not waited on; least of "
          f"3 rounds): " + ", ".join(f"{n} {min(t):.2f} us"
                                     for n, t in us.items())
          + "; x 480 launches a ring step: "
          + " / ".join(f"{min(t) * 480 / 1e3:.2f}" for t in us.values())
          + " ms")
    del a32, b32, c32
    del bufs, fresh, a, b, c
    torch.cuda.empty_cache()
    # the widest head dim of the bf16 kernels: forward and backward beside
    # SDPA's
    D = 256
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, True)
    torch.cuda.synchronize()
    err = max(max_err(torch, out, ref), max_err(torch, lse, ref_lse))
    check(torch.allclose(out.float(), ref.float(), **TOL_FLASH["bfloat16"])
          and torch.allclose(lse, ref_lse, **TOL_FLASH["float32"]),
          f"flash fwd kernel != plain at head dim 256: {err:.3g}")
    del ref, ref_lse
    delta = fa._delta(out, do)
    t_fwd = time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, scale, True),
                    10)
    t_bwd = time_ms(torch, lambda: fa._bwd_sm90(q, k, v, do, lse, delta,
                                                scale, True), 5)
    t_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    t_lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do, retain_graph=True), 5)
    del lout, lq, lk, lv
    work = flash_work(B, H, S, D, True)
    # the larger of the bytes' and the operations' time
    bound = {key: max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
             for key, (nbytes, flops) in work.items()}
    print(f"[phase 5] flash at q/k/v {[B, H, S, D]} bf16 causal: forward "
          f"{t_fwd:.4f} ms ({work['fwd'][1] / t_fwd / 1e9:.1f} TFLOP/s), "
          f"SDPA {t_lib:.4f} ms, bound {bound['fwd']:.4f} ms, max abs err "
          f"{err:.3g}; backward call {t_bwd:.4f} ms "
          f"({work['bwd'][1] / t_bwd / 1e9:.1f} TFLOP/s), SDPA backward "
          f"{t_lib_bwd:.4f} ms, bound {bound['bwd']:.4f} ms")
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return result


def phase_train_step(torch, cfg, params, fa, gpt_loss):
    """One full-width training step, kernels vs plain attention."""
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 2048))).cuda()
    leaves = [params["wte"], params["wpe"], params["lnf_g"],
              params["lnf_b"]] + [params["blocks"][k]
                                  for k in sorted(params["blocks"])]
    names = ["wte", "wpe", "lnf_g", "lnf_b"] + [
        f"blocks/{k}" for k in sorted(params["blocks"])]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for label, attention in (("kernel", None),
                             ("plain", lambda q, k, v:
                              fa.flash_attention_plain(q, k, v,
                                                       causal=True))):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        loss = gpt_loss(cfg, params, tokens, attention=attention)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[label] = (float(loss.detach()), grads,
                       time.perf_counter() - t0)
        if label == "kernel":
            got = {n: fa.launches[n] - before[n] for n in before}
            L = cfg.num_layers
            check(got == {"fwd": 2 * L, "bwd": L},
                  f"training step launched {got}")
    for t in leaves:
        t.requires_grad_(False)
    (lk, gk, tk), (lp, gp, _) = runs["kernel"], runs["plain"]
    check(np.isfinite(lk) and np.isfinite(lp), "training loss not finite")
    worst = (0.0, "")
    for name, a, b in zip(names, gk, gp):
        check(bool(torch.isfinite(a).all()), f"grad {name} not finite")
        rel = float((a.float() - b.float()).norm()
                    / b.float().norm().clamp(min=1e-30))
        worst = max(worst, (rel, name))
    print(f"[phase 6] gpt3-1.3b bf16 x{cfg.num_layers} layers, batch "
          f"1 x 2048, one training step: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3g}); worst gradient "
          f"relative L2 error {worst[0]:.4g} ({worst[1]}) over "
          f"{len(names)} leaves; kernel step {tk * 1e3:.1f} ms")
    # both sides compute attention in fp32 and round its output (and
    # its input grads) to bf16; one-ulp differences there (2^-8
    # relative) compound through 24 bf16 layers forward and back
    check(abs(lk - lp) <= 2e-3 * abs(lp),
          f"training step: loss differs by {abs(lk - lp):.4g}")
    check(worst[0] <= 0.05, f"training step: gradient {worst[1]} differs "
          f"by {worst[0]:.4g} relative")
    del runs, gk, gp
    torch.cuda.empty_cache()


GEMM_WORDS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
MOE_ROUTING = ("moe::route", "moe::dispatch", "moe::combine")


def is_gemm(name):
    return any(w in name.lower() for w in GEMM_WORDS)


def moe_split(torch, prof, experts):
    """Device µs of a trace's MoE work (``record_shapes`` on), from the
    op that launched each kernel: ``expert`` the GEMMs of ``aten::bmm``
    over ``[experts, ...]`` operands (forward and backward);
    ``route_gemm`` / ``route_other`` every kernel under a ``moe::route``,
    ``moe::dispatch`` or ``moe::combine`` range, and in backward the
    GEMMs of the other ``aten::bmm`` (the combine's) and of ``aten::mm``
    with an ``experts``-wide operand (the gate's)."""
    out = {"expert": 0.0, "route_gemm": 0.0, "route_other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        rng = e
        while rng is not None and not rng.name.startswith("moe::"):
            rng = rng.cpu_parent
        routing = rng is not None and rng.name in MOE_ROUTING
        shapes = [sh for sh in (e.input_shapes or []) if sh]
        batched = e.name == "aten::bmm"
        expert = batched and bool(shapes) and shapes[0][0] == experts
        gate = e.name in ("aten::mm", "aten::addmm") and any(
            len(sh) == 2 and sh[-1] == experts for sh in shapes)
        for k in e.kernels:
            gemm = is_gemm(k.name)
            if gemm and expert:
                out["expert"] += k.duration
            elif routing or (gemm and (batched or gate)):
                out["route_gemm" if gemm else "route_other"] += k.duration
    return out


def split_moe_kinds(by_kind, matmul, split, scale=1.0):
    """Move a ``moe_split`` (times ``scale``) out of a by-kind dict whose
    GEMMs are under ``matmul``: those left are the dense products, and
    expert products and routing/dispatch/combine become kinds of their
    own."""
    split = {k: v * scale for k, v in split.items()}
    by_kind["dense products"] = by_kind.pop(matmul) - split["expert"] \
        - split["route_gemm"]
    by_kind["other"] -= split["route_other"]
    by_kind["expert products"] = split["expert"]
    by_kind["routing/dispatch/combine"] = (split["route_gemm"]
                                           + split["route_other"])


#: the device-side events of ``record_function`` ranges (the engine's,
#: hapi's and the MoE layer's), which are not kernels and stay out of the
#: kernel sums
RANGES = ("engine::", "moe::", "hybrid_engine::", "hapi::", "serving::")


def profile_step(torch, step, experts=0):
    """Device time of one training step by kind (flash kernels, matrix
    products, the rest; with ``experts`` the MoE's expert products and
    routing/dispatch/combine apart), traced with torch.profiler.  A
    replayed graph's kernels have no launching op and it records no
    ranges: its trace gives the kinds, the eager route's the ranges,
    the aten ops and the MoE split.  ``wall_ms``: the host clock over the
    same traced step, the busy share's denominator (device time traced
    over an untraced wall time can pass 1)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(experts)) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    top, spans, ops = [], {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # aten ops, by the device time of the kernels they launched
            if e.key.startswith("aten::"):
                ops.append((us / 1e3, e.key))
            continue
        if e.key.startswith(RANGES):
            # the device-side span of a record_function range, not a
            # kernel: kept apart from the sums
            spans[e.key] = us / 1e3
            continue
        if us <= 0:
            continue
        key = e.key.lower()
        kind = ("flash" if "flash_" in key and "_kernel" in key else
                "matmul" if is_gemm(key) else "other")
        by_kind[kind] += us / 1e3
        top.append((us, e.key[:48]))
    busy = sum(by_kind.values())
    check(busy > 0, "profiler saw no device time")
    if experts:
        split_moe_kinds(by_kind, "matmul", moe_split(torch, prof, experts),
                        1e-3)
    return {"busy_ms": busy, "wall_ms": wall, "by_kind": by_kind,
            "spans": spans, "top": sorted(top)[::-1][:6],
            "ops": sorted(ops)[::-1][:10]}


@contextlib.contextmanager
def eager_route(torch, obj):
    """``obj`` (a ``HybridEngine`` or a hapi ``Model``) calls its step
    bodies eagerly for the duration: the graph route's baseline (neither
    has an eager route on the card, as the JAX package's jitted steps
    have none).  Its captured graphs are freed first (so an eager step's
    activations and a graph's pool are not both held); a later step
    captures again.  Each body runs in a step scope, as ``CapturedStep``
    runs it (``core.random``: ``recompute`` and ``key_stream`` draw from
    the generator pairs there)."""
    from paddle_tpu_torch.core.random import step_scope

    def scoped(body):
        def run(*args):
            with step_scope():
                return body(*args)
        return run

    for name in ("_step_fn", "_train_fn", "_eval_fn"):
        if hasattr(obj, name):
            getattr(obj, name).release()
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(obj, "_step_body"):
        obj._run = lambda args: scoped(obj._step_body)(*args)
        names = ("_run",)
    else:
        obj._run_train = lambda args: scoped(obj._train_body)(*args)
        obj._run_eval = scoped(obj._eval_body)
        names = ("_run_train", "_run_eval")
    try:
        yield
    finally:
        for name in names:
            delattr(obj, name)


def watchdog():
    """The default compile watchdog, enabled."""
    from paddle_tpu_torch.observability import default_watchdog

    return default_watchdog().enable()


def check_captured_once(obj, name, what):
    """``obj`` captured its step once and the watchdog (reset before the
    step's first call) saw one build of ``name`` and no rebuild; returns
    the line the phase prints."""
    rep = watchdog().report().get(name, {})
    caps = obj.captures
    caps = caps["train"] if isinstance(caps, dict) else caps
    check(caps == 1 and rep.get("compiles") == 1
          and rep.get("recompiles") == 0,
          f"{what}: {caps} captures, watchdog {name}: {rep}")
    return (f"captures {caps} (watchdog {name}: {rep['calls']} calls, "
            f"{rep['compiles']} build, {rep['recompiles']} rebuilds, "
            f"{rep['compile_time_s']:.2f} s the first call with its "
            f"capture)")


RING_SEP = 4                       # phase 10's ring shards on the card


def train_launches(sep):
    """Kernel launches of one training step, per layer, by counter.
    Remat "dots" saves matmul outputs only, so every flash forward runs
    again in backward; the bf16 flash backward is one launch.  With sep >
    1 the ring runs its live pairs (j <= i: sep diagonal, the rest full)
    through the flash forward, and each pair through the ring-pair
    backward kernel once."""
    if sep == 1:
        return {"fwd": 2, "bwd": 1, "pair_bwd": 0}
    live = sep * (sep + 1) // 2
    return {"fwd": 2 * live, "bwd": 0, "pair_bwd": live}


def train_run(torch, eng, tokens, labels, counts, experts=0):
    """Ten steps of ``eng`` from ``eng.init(seed=0)`` on one batch, on the
    engine's graph route: 2 warm-up (step 1 eager, then the capture; a
    replay), 5 timed (every launch count in ``counts`` set to 0 just
    before them and read just after), 2 more and a profiled replay; peak
    memory from the first step on (the capture's included).  Then one
    more step on the eager route, profiled for the ranges, the aten ops
    and the MoE split.  Returns the numbers the training phases print."""
    watchdog().reset()
    params, opt = eng.init(seed=0)
    losses = []

    def step():
        nonlocal params, opt
        params, opt, loss = eng.step(params, opt, tokens, labels)
        losses.append(loss)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):                      # warm-up
        step()
    torch.cuda.synchronize()
    for c in counts:
        for n in c:
            c[n] = 0
    timed = 5
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c[n] for c in counts for n in c}
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        step()
    breakdown = profile_step(torch, step)
    captured = check_captured_once(eng, "hybrid_engine::step", "training")
    pool = eng.graph_pool_bytes
    with eager_route(torch, eng):
        eager = profile_step(torch, step, experts)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"timed": timed, "wall": wall, "ms_step": wall / timed * 1e3,
            "launches": launches, "peak": peak, "breakdown": breakdown,
            "eager": eager, "captured": captured, "pool": pool,
            "losses": [float(x) for x in losses]}


def print_breakdown(tag, run):
    """The profiled steps' lines of a training phase: the graph route's
    replay by kind, the eager route's step by range and aten op."""
    bd, ms_step, ea = run["breakdown"], run["ms_step"], run["eager"]
    print(f"[{tag}] one traced replay (10th step): device busy "
          f"{bd['busy_ms']:.1f} ms of its {bd['wall_ms']:.1f} ms on the "
          f"host clock (busy share {bd['busy_ms'] / bd['wall_ms']:.3f}; "
          f"untraced {ms_step:.1f} ms/step); by kind: " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in bd["by_kind"].items()))
    print(f"[{tag}] top device kernels, ms/step: " + "; ".join(
        f"{name} {us / 1e3:.2f}" for us, name in bd["top"]))
    print(f"[{tag}] one traced step on the eager route (11th): device "
          f"busy {ea['busy_ms']:.1f} ms of its {ea['wall_ms']:.1f} ms on "
          f"the host clock (busy share {ea['busy_ms'] / ea['wall_ms']:.3f}"
          f"); by kind: " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in ea["by_kind"].items()))
    print(f"[{tag}] eager route, device spans of the ranges: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in ea["spans"].items()))
    print(f"[{tag}] eager route, top aten ops by device ms: " + "; ".join(
        f"{name} {ms:.1f}" for ms, name in ea["ops"]))


def report_training(torch, tag, cfg, run, B, S, flops, per_step, name):
    """Print a training phase's numbers and hold its loss and launches;
    ``flops`` is (FLOPs the step does, the 6N count) or one count.
    Returns the launches over the timed steps."""
    losses, launches, timed = run["losses"], run["launches"], run["timed"]
    ms_step = run["ms_step"]
    tok_s = B * S * timed / run["wall"]
    if isinstance(flops, tuple):
        done, six_n = flops
        mfu = (f"MFU {done / (ms_step / 1e3) / BF16_FLOPS:.4f} on the "
               f"{done / 1e12:.1f} TFLOP the step does (E·C expert slots), "
               f"{six_n / (ms_step / 1e3) / BF16_FLOPS:.4f} on "
               f"gpt_flops_per_token's {six_n / 1e12:.1f} TFLOP (6N, all "
               f"{cfg.moe_experts} experts a token)")
    else:
        mfu = (f"MFU {flops / (ms_step / 1e3) / BF16_FLOPS:.4f} "
               f"({flops / 1e12:.2f} TFLOP a step: 6N + attention)")
    print(f"[{tag}] HybridEngine {name}, batch {B} x {S}, remat dots, "
          f"fp32 Adam slots + master: {ms_step:.1f} ms/step, {tok_s:.1f} "
          f"tokens/s, {mfu} (989 TFLOP/s peak; {card_line()}), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"[{tag}] losses over 11 steps (10 on the graph route, the "
          f"11th eager): " + " ".join(f"{x:.4f}" for x in losses))
    print(f"[{tag}] launches over {timed} timed steps (replays): "
          f"{launches}; {run['captured']}; graph pool "
          f"{run['pool'] / 2**20:.1f} MiB")
    print_breakdown(tag, run)
    check(all(np.isfinite(losses)), f"{tag}: training loss not finite")
    check(losses[-1] < losses[0], f"{tag}: training loss did not fall")
    want = {n: k * timed for n, k in per_step.items()}
    check(launches == want, f"{tag}: launches {launches} != {want}")
    return launches


def phase_train_throughput(torch, sep=1, tag="phase 7"):
    """HybridEngine at the 1.3B training rung on one card, with ``sep``
    ring shards (``seq_parallel="ring"`` when sep > 1); the launches are
    held to ``train_launches(sep)``.  Returns (launches over the timed
    steps, the first loss)."""
    import importlib

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_flops_per_token

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    cfg = GPT_CONFIGS["gpt3-1.3b"]
    if sep > 1:
        cfg = dataclasses.replace(cfg, seq_parallel="ring")
    B, S = 8, 2048
    # free what earlier phases left in reference cycles (the serving
    # engine and its KV pool) now, so the peak below is this cell's own
    gc.collect()
    torch.cuda.empty_cache()
    eng = distributed.HybridEngine(cfg, sep=sep,
                                   engine_cfg=distributed.EngineConfig(
                                       accum_steps=1), device="cuda")
    check(cfg.remat == "dots" and eng._has_master(),
          "expected remat 'dots' and an fp32 master")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)
    run = train_run(torch, eng, tokens, labels, [fa.launches, ra.launches])
    launches = report_training(
        torch, tag, cfg, run, B, S, B * S * gpt_flops_per_token(cfg, S),
        {n: k * cfg.num_layers for n, k in train_launches(sep).items()},
        f"gpt3-1.3b bf16, sep {sep} (seq_parallel {cfg.seq_parallel!r})")
    return launches, run["losses"][0]


# ------------------------------------------------ ring attention (8-10)


def ring_pair_case(torch, fa, B, H, s, D, dtype, seed):
    """Rank 1 of a 2-rank ring on the card, from a seed: its q shard, the
    two blocks it meets (rank 0's: a full pair; its own: the diagonal
    pair), dO in q's dtype (as the ring hands it to a pair), the
    ring-global lse, output and delta over both pairs, and non-zero
    fp32 starting sums for dq, dk, dv."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k0, v0, k1, v1, do = (torch.randn((B, H, s, D), generator=g,
                                         device="cuda").to(dtype)
                             for _ in range(6))
    start = [torch.randn((B, H, s, D), generator=g, device="cuda")
             for _ in range(3)]
    scale = 1.0 / np.sqrt(D)
    o_f, l_f = fa._flash_fwd_ref(q, k0, v0, scale, False)
    o_d, l_d = fa._flash_fwd_ref(q, k1, v1, scale, True)
    lse = torch.logaddexp(l_f, l_d)
    out = (o_f.float() * torch.exp(l_f - lse)[..., None]
           + o_d.float() * torch.exp(l_d - lse)[..., None]).to(dtype)
    return {"q": q, "pairs": {False: (k0, v0), True: (k1, v1)}, "do": do,
            "lse": lse, "out": out, "delta": fa._delta(out, do),
            "scale": scale, "start": start}


def ring_pair_run(torch, ra, c, causal):
    """One pair's backward as the ring runs it: q/k/v/dO at the kernels'
    width (``_pair_operands``), the starting sums padded to it with
    zeros; returns (the sums after the pair, sliced to D, the padded
    sums, the call on the padded operands)."""
    import torch.nn.functional as F

    k, v = c["pairs"][causal]
    D = k.shape[-1]
    ops = ra._pair_operands(c["q"], k, v, c["do"])
    pad = ops[0].shape[-1] - D
    sums = [F.pad(t, (0, pad)) if pad else t.clone() for t in c["start"]]

    def call(sums=sums):
        ra._pair_bwd(*ops, c["lse"], c["delta"], c["scale"], causal, *sums)

    call()
    return [t[..., :D] for t in sums], sums, call


def ring_pair_work(B, H, s, D, causal):
    """(bytes, FLOPs) the bf16 ring-pair backward must move and do: q,
    k, v and dO in bf16 and lse, delta read once; the dq, dk and dv fp32
    sums each read and written once; the five products (10 * D FLOPs) of
    the live (q, k) pairs only."""
    pairs = B * H * (s * (s + 1) // 2 if causal else s * s)
    mat, mat32, rows = B * H * s * D * 2, B * H * s * D * 4, B * H * s * 4
    return 4 * mat + 2 * rows + 3 * 2 * mat32, 10 * D * pairs


def library_pair_bwd(torch, c, causal):
    """PyTorch's flash-attention backward (dq, dk, dv in one call) on the
    same pair: the pair's q/k/v, the ring's global out and lse, dO.
    Returns (a call computing it, why there is none)."""
    op = getattr(torch.ops.aten, "_scaled_dot_product_flash_attention"
                 "_backward", None)
    if op is None:
        return None, "this PyTorch has no aten flash-attention backward"
    q, (k, v) = c["q"], c["pairs"][causal]
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal, False, scale=c["scale"])

        def call():
            return op(c["do"], q, k, v, c["out"], c["lse"], fwd[2], fwd[3],
                      fwd[4], fwd[5], 0.0, causal, fwd[6], fwd[7],
                      scale=c["scale"])

        call()
        torch.cuda.synchronize()
    except Exception as e:  # the yardstick is optional; its absence is printed
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return call, None


def phase_ring_pair_kernels(torch, fa, ra):
    """Edge cases, then the per-rank shapes of the sep=4 training path
    with timings."""
    n = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for s in (128, 256, 512):
            for D in (32, 64, 128, 80, 256):
                c = ring_pair_case(torch, fa, 2, 3, s, D, dtype, seed=n)
                for causal in (True, False):
                    k, v = c["pairs"][causal]
                    before = (ra.launches["pair_bwd"], fa.launches["bwd"])
                    got, _, _ = ring_pair_run(torch, ra, c, causal)
                    again, _, _ = ring_pair_run(torch, ra, c, causal)
                    want = ra._pair_bwd_ref(c["q"], k, v, c["do"], c["lse"],
                                            c["delta"], c["scale"], causal)
                    torch.cuda.synchronize()
                    bf16 = dtype == torch.bfloat16
                    check((ra.launches["pair_bwd"] - before[0],
                           fa.launches["bwd"] - before[1])
                          == ((2, 0) if bf16 else (0, 4)),
                          "ring pair launches not counted")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"ring pair dq/dk/dv differ between two runs "
                          f"({dtype_name}, s={s}, D={D}, causal={causal})")
                    for name, a, s0, b in zip(("dq", "dk", "dv"), got,
                                              c["start"], want):
                        check(a.dtype == torch.float32 and a.shape == b.shape,
                              f"ring pair {name} dtype/shape")
                        check(bool(torch.isfinite(a).all()),
                              f"ring pair {name} not finite")
                        err = max_err(torch, a, s0 + b)
                        worst[dtype_name] = max(worst[dtype_name], err)
                        check(torch.allclose(a, s0 + b,
                                             **TOL_FLASH[dtype_name]),
                              f"ring pair {name} != start + plain "
                              f"({dtype_name}, s={s}, D={D}, causal="
                              f"{causal}): max abs err {err:.3g}")
                    n += 1
    print(f"[phase 8] {n} ring-pair edge cases: start + pair == start + "
          f"plain on dq, dk, dv (fp32 atol=rtol=1e-4, worst "
          f"{worst['float32']:.3g}; bf16 q/k/v/dO: atol 1e-2 rtol 1.6e-2, "
          f"worst {worst['bfloat16']:.3g}); dq, dk, dv bit-equal over two "
          f"runs")

    # ---- per-rank shapes of the path: sep=4 over S=2048, bf16
    B, H, s, D = 8, 16, 512, 128
    c = ring_pair_case(torch, fa, B, H, s, D, torch.bfloat16, seed=5)
    res = {}
    for causal in (False, True):
        k, v = c["pairs"][causal]
        args = (c["q"], k, v, c["do"], c["lse"], c["delta"], c["scale"],
                causal)
        got, sums, call = ring_pair_run(torch, ra, c, causal)
        want = ra._pair_bwd_ref(*args)
        torch.cuda.synchronize()
        errs = []
        for name, a, s0, b in zip(("dq", "dk", "dv"), got, c["start"],
                                  want):
            errs.append(max_err(torch, a, s0 + b))
            check(torch.allclose(a, s0 + b, **TOL_FLASH["bfloat16"]),
                  f"ring pair {name} != start + plain at the path shapes "
                  f"(causal={causal}): {errs[-1]:.3g}")
        lib_call, why = library_pair_bwd(torch, c, causal)
        if lib_call is not None:
            lq, lk, lv = lib_call()[:3]
            torch.cuda.synchronize()
            for name, a, b in (("dq", lq, want[0]), ("dk", lk, want[1]),
                               ("dv", lv, want[2])):
                if not torch.allclose(a.float(), b, **TOL_FLASH["bfloat16"]):
                    lib_call = None
                    why = (f"its {name} disagrees with the plain version by "
                           f"{max_err(torch, a, b):.3g}")
                    break
        del got, want

        def plain(sums=sums):
            for acc, t in zip(sums, ra._pair_bwd_ref(*args)):
                acc[..., :D] += t

        # one pair's call keeps adding into the same sums (no time change)
        ms = time_ms(torch, call, 20)
        plain_ms = time_ms(torch, plain, 3, warmup=1)
        lib_ms = (time_ms(torch, lib_call, 20) if lib_call is not None
                  else None)
        # what the route before this kernel ran after its two kernels:
        # each pair's fresh dq, dk, dv added into the sums (three fp32
        # passes, each reading two tensors and writing one)
        parts = [torch.ones_like(t) for t in sums]

        def three_adds():
            for acc, t in zip(sums, parts):
                acc += t

        adds_ms = time_ms(torch, three_adds, 20)
        del parts
        torch.cuda.empty_cache()
        nbytes, flops = ring_pair_work(B, H, s, D, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        kind = "diagonal (causal)" if causal else "full"
        entry = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib_ms}
        print(f"[phase 8] ring pair backward, {kind} pair at q/k/v/dO "
              f"{[B, H, s, D]} bf16 into fp32 sums: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.1f} "
              f"GFLOP at 989 TFLOP/s), max abs err {max(errs):.3g}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        print(f"[phase 8] {kind} pair: aten flash-attention backward (dq, "
              f"dk, dv in one call, fresh bf16 outputs) "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None
                 else f"none ({why})")
              + f"; the three fp32 adds of the route before this kernel "
              f"{adds_ms:.4f} ms")
        if causal:
            res.update({f"diagonal_{key}": entry[key]
                        for key in ("ms", "plain_ms", "bound_ms",
                                    "library_ms", "max_abs_err")})
        else:
            res.update(entry)
        del sums
    del c
    torch.cuda.empty_cache()
    return res


def phase_ring_vs_flash(torch, fa, ra):
    """ring_attention (sep=4) against flash_attention on the 1.3B
    training shapes: output, grads and both times."""
    B, H, S, D = 8, 16, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    fns = {"ring": lambda *a: ra.ring_attention(*a, sep=4),
           "flash": lambda *a: fa.flash_attention(*a, causal=True)}
    res, times = {}, {}
    for name, fn in fns.items():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def run():
            out = fn(*leaves)
            return (out,) + torch.autograd.grad(out, leaves, do)

        res[name] = [t.detach() for t in run()]
        times[name] = time_ms(torch, run, 5, warmup=2)
    torch.cuda.synchronize()
    errs = {}
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        a, b = res["ring"][i], res["flash"][i]
        errs[name] = max_err(torch, a, b)
        check(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
              f"ring {name} dtype or not finite")
        check(torch.allclose(a.float(), b.float(), **TOL_FLASH["bfloat16"]),
              f"ring {name} != flash: max abs err {errs[name]:.3g}")
    print(f"[phase 9] ring_attention sep=4 vs flash_attention at q/k/v "
          f"{[B, H, S, D]} bf16 causal: max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" (atol 1e-2 rtol 1.6e-2); forward + backward: ring "
          f"{times['ring']:.4f} ms, flash {times['flash']:.4f} ms")
    del res, q, k, v, do
    torch.cuda.empty_cache()


# ------------------------------------------------------ serving fleet (11)

FLEET_SEED = 0
FLEET_NEW = 32                     # new tokens a request, greedy
FLEET_ENGINE = dict(page_size=16, num_pages=2048, max_batch_size=8,
                    chunk_len=64)  # phase 4's pool and batch
# burst then quiet: 28 arrivals over 8 s (14 inside the burst window,
# which the first arrival opens; the replay starts at the first arrival)
FLEET_TRAFFIC = dict(base_rate_per_s=2.0, diurnal_amplitude=0.0,
                     bursts=((1.0, 1.5, 5.0),), n_cohorts=3,
                     cohort_prefix_len=256, cohort_fraction=0.5,
                     prompt_len=(64, 1024),
                     max_new_tokens=(FLEET_NEW, FLEET_NEW), seed=FLEET_SEED)
FLEET_HORIZON_S = 8.0
# the autoscaler's bands: pressure is the mean drain estimate of a ready
# replica (decode tokens owed over its measured decode rate) plus the
# router queue's term.  One request owes 32 tokens, about 0.05 s at a
# batch's rate: a replica with two or more aboard crosses 0.1 s, an idle
# fleet owes nothing
FLEET_SCALER = dict(min_replicas=2, max_replicas=4, poll_interval_s=0.05,
                    up_pressure_s=0.1, down_pressure_s=0.02,
                    up_pending_depth=6, scale_up_cooldown_s=1.0,
                    scale_down_cooldown_s=2.0)
FLEET_MEM_SLACK = 64 << 20         # bytes beyond pools + params
# an engine's captured step keeps a private memory pool: the ragged
# kernel's split scratch (at most 64 MiB, ``_SCRATCH_BYTES``; 34 MiB at
# these shapes) and the step's activations (a few MiB at 71 tokens),
# rounded up to the allocator's segments.  Memory allocated stays within
# FLEET_MEM_SLACK of params + pools (the graph's live outputs are its
# logits, 1.6 MB); what the pools reserve is held apart to this bound
GRAPH_POOL_BOUND = 80 << 20


def fleet_engine_class(serving):
    """The port's Engine, counting what phase 11 checks: every step it
    runs (the kernel's launches are held to 24 x their sum), whether its
    live logits were finite, its warmups and its prefix-cache hits.  A
    subclass, not a patched method: a bound method stored on the engine
    would tie it into a reference cycle and keep its pool alive."""

    class FleetEngine(serving.Engine):
        steps_by_engine = {}           # serial -> steps
        step_s = {}                    # serial -> host seconds in step()
        hits_by_engine = {}            # serial -> prefix-cache hits
        graphs = {}                    # serial -> (captures, pool bytes)
        warmed = set()                 # serials warmed up
        finite = []
        _serials = iter(range(1 << 30))

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.serial = next(FleetEngine._serials)

        def _run_step(self, tokens, rows, slots, qlens, ctxs, tables):
            logits = super()._run_step(tokens, rows, slots, qlens, ctxs,
                                       tables)
            FleetEngine.finite.append(
                bool(np.isfinite(logits[qlens > 0]).all()))
            FleetEngine.steps_by_engine[self.serial] = self.steps
            FleetEngine.graphs[self.serial] = (self.captures,
                                               self.graph_pool_bytes)
            return logits

        def step(self):
            t = time.perf_counter()
            done = super().step()
            FleetEngine.step_s[self.serial] = FleetEngine.step_s.get(
                self.serial, 0.0) + time.perf_counter() - t
            FleetEngine.hits_by_engine[self.serial] = \
                self.cache.prefix_stats()["hits"]
            return done

        def warmup(self, *args, **kw):
            FleetEngine.warmed.add(self.serial)
            return super().warmup(*args, **kw)

    return FleetEngine


def phase_fleet(torch, cfg, pa, serving, resilience, watchdog):
    """Phase 11: ``FleetRouter`` over three GPT-3 1.3B engines with an
    ``Autoscaler``, a seeded burst-then-quiet trace replayed in wall
    time, and chaos at fixed points: (a) an io_error at ``serving.step``
    on a replica with requests mid-decode, (b) a hard kill of another,
    (c) a rolling restart (``drain``) of a third; (d) the burst scales
    the fleet up to a fourth engine and the quiet tail scales it down.
    Returns the kernel's launches over the phase."""
    from paddle_tpu_torch.models import gpt_init
    from paddle_tpu_torch.observability.metrics import Histogram

    FleetEngine = fleet_engine_class(serving)
    RS, FRS = serving.ReplicaState, serving.FleetRequestState
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - base
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    pool_bytes = (2 * L * FLEET_ENGINE["num_pages"]
                  * FLEET_ENGINE["page_size"] * H * hd * 2)

    def factory():
        return FleetEngine(cfg, params, device="cuda", **FLEET_ENGINE)

    mem_checks = []

    def check_memory(when):
        gc.collect()
        torch.cuda.synchronize()
        held = [rep.replica_id for rep in router.replicas
                if isinstance(rep.engine, serving.Engine)]
        want = base + params_bytes + len(held) * pool_bytes
        got = torch.cuda.memory_allocated()
        mem_checks.append((when, len(held), got - want))
        check(abs(got - want) <= FLEET_MEM_SLACK,
              f"after {when}: {got / 2**30:.3f} GiB allocated, "
              f"{len(held)} engines account for {want / 2**30:.3f} GiB")

    pa.ragged_paged_attention.launches = 0
    watchdog.reset()
    router = serving.FleetRouter([factory] * 3,
                                 warmup=lambda eng: eng.warmup())
    sp = serving.SamplingParams(max_new_tokens=FLEET_NEW)
    for rep in router.replicas:
        # the first build is the caller's to warm; then one short request
        # each, so the fleet starts as a serving fleet does, with a
        # measured decode rate (a warmed engine counts as warming until
        # its first real decode)
        rep.engine.warmup()
        rep.engine.generate([[1, 2, 3, 4]],
                            serving.SamplingParams(max_new_tokens=4))
    scaler = serving.Autoscaler(router, **FLEET_SCALER)
    arrivals = serving.TrafficGenerator(
        vocab_size=cfg.vocab_size, **FLEET_TRAFFIC).trace(FLEET_HORIZON_S)
    check(24 <= len(arrivals) <= 32,
          f"{len(arrivals)} arrivals, expected 24-32")
    t_first = arrivals[0].t

    def mid_decode(rid):
        return [f for f in router._assigned[rid].values()
                if f.tokens_out and len(f.tokens_out) < FLEET_NEW]

    def pick(exclude, need_decode=True):
        for rep in router.replicas:
            if rep.state == RS.HEALTHY and rep.replica_id not in exclude \
                    and (mid_decode(rep.replica_id) or not need_decode):
                return rep.replica_id
        return None

    def stepping_before(rid, now):
        """Replicas ahead of ``rid`` that the next tick steps: the io_error
        must land on the ``serving.step`` hit of ``rid``'s engine."""
        n = 0
        for rep in router.replicas:
            if rep.replica_id == rid:
                return n
            if rep.state == RS.DEAD:
                continue
            try:
                work = rep.engine.has_work()
            except OSError:
                continue
            if work and not (rep.state == RS.DRAINING
                             and now >= rep.drain_deadline):
                n += 1
        return n

    serial_rep = {}         # engine serial -> the replica it served
    reqs, events = [], {}
    harvested = {}          # fleet request id -> [tokens at each failure]
    expected_moves = 0
    draining_seen = {}      # replica id -> {request id: tokens} last tick
    ticks = 0
    # host seconds in router.step, in the engine steps it ran, and in
    # scaler.tick (whose spawns build and warm engines)
    router_s = router_steps_s = scaler_s = 0.0
    t0 = time.perf_counter()
    with resilience.injected_faults() as inj:
        while True:
            now = time.perf_counter() - t0
            while len(reqs) < len(arrivals) and \
                    arrivals[len(reqs)].t - t_first <= now:
                reqs.append(router.submit(arrivals[len(reqs)].prompt, sp))
            if "tail_down_done" in events:
                break
            check(now < FLEET_HORIZON_S + 30.0,
                  f"fleet did not settle: {len(reqs)} submitted, events "
                  f"{sorted(events)}, scaler {scaler.status()['scale_events']}")
            # ---- chaos, each at a fixed tick (or the first tick after it
            # where its target exists)
            if "a" not in events and ticks >= 20 and (
                    len(router.replicas) == 4 or now > 3.0):
                rid = pick(exclude=())
                if rid is not None and not any(
                        rep.state == RS.DRAINING for rep in router.replicas):
                    moving = router._assigned[rid]
                    for f in moving.values():
                        harvested.setdefault(f.id, []).append(
                            list(f.tokens_out))
                    expected_moves += len(moving)
                    inj.specs.append(resilience.FaultSpec(
                        "serving.step", "io_error",
                        occurrence=inj.hits("serving.step") + 1
                        + stepping_before(rid, router._clock())))
                    events["a"] = (ticks, rid, len(moving))
            elif "a" in events and "b" not in events and \
                    ticks >= events["a"][0] + 5:
                rid = pick(exclude=(events["a"][1],))
                if rid is not None:
                    moving = router._assigned[rid]
                    for f in moving.values():
                        harvested.setdefault(f.id, []).append(
                            list(f.tokens_out))
                    expected_moves += len(moving)
                    router.kill_replica(rid)
                    events["b"] = (ticks, rid, len(moving))
                    check_memory("(b) kill_replica")
            elif "b" in events and "c" not in events and \
                    ticks >= events["b"][0] + 5:
                rid = pick(exclude=(events["a"][1], events["b"][1]),
                           need_decode=False)
                if rid is not None:
                    router.drain(rid, deadline_s=0.5)
                    events["c"] = (ticks, rid, len(router._assigned[rid]))
            # stragglers of a drain are reclaimed with the tokens they had
            # before the tick that reclaims them (a draining replica past
            # its deadline is not stepped again); a request that finishes
            # on the replica in the tick that ends its drain is no
            # straggler
            draining_seen = {
                rep.replica_id: {f.id: (f, list(f.tokens_out),
                                        f.redispatches)
                                 for f in router._assigned[
                                     rep.replica_id].values()}
                for rep in router.replicas if rep.state == RS.DRAINING}
            moved0 = router.metrics.redispatched.value
            fails0 = router.metrics.failure_events.value
            t_tick = time.perf_counter()
            in_steps = sum(FleetEngine.step_s.values())
            router.step()
            router_s += time.perf_counter() - t_tick
            router_steps_s += sum(FleetEngine.step_s.values()) - in_steps
            ticks += 1
            for rid, seen in draining_seen.items():
                rep = router._rep(rid)
                if rep.state == RS.DRAINING:
                    continue
                # this tick ended rid's drain: its stragglers moved now,
                # once each; every other request aboard finished here
                check(router.metrics.failure_events.value == fails0,
                      "a failure landed on a drain's last tick")
                moved = {fid: toks for fid, (f, toks, n) in seen.items()
                         if f.redispatches > n}
                check(all(f.redispatches == n + 1 for f, _, n in
                          (seen[fid] for fid in moved))
                      and all(f.state == FRS.FINISHED
                              for fid, (f, _, _) in seen.items()
                              if fid not in moved),
                      f"drain of {rid}: of {len(seen)} aboard, "
                      f"{len(moved)} moved and the rest did not finish")
                stragglers = router.metrics.redispatched.value - moved0
                check(stragglers == len(moved),
                      f"drain of {rid}: {stragglers} moved, {len(moved)} "
                      f"stragglers were aboard")
                for fid, toks in moved.items():
                    harvested.setdefault(fid, []).append(toks)
                expected_moves += len(moved)
                events.setdefault("drains", []).append(
                    (ticks, rid, len(seen), len(moved), rep.state))
                if rid == events.get("c", (None, None))[1] and \
                        "c_done" not in events:
                    events["c_done"] = ticks
                    check(rep.state == RS.HEALTHY,
                          f"drained replica {rid} did not restart")
                    check_memory("(c) drain and restart")
                elif rep.state == RS.DEAD:
                    check_memory(f"scale-down of replica {rid}")
                    if "tail_down" in events:
                        events["tail_down_done"] = ticks
            t_tick = time.perf_counter()
            decision = scaler.tick()
            scaler_s += time.perf_counter() - t_tick
            if decision is not None:
                events.setdefault(decision[0], ticks)
                if decision[0] == "down" and len(reqs) == len(arrivals) \
                        and not router.has_work():
                    events.setdefault("tail_down", ticks)
            for rep in router.replicas:
                if isinstance(rep.engine, FleetEngine):
                    serial_rep[rep.engine.serial] = rep.replica_id
            if not router.has_work() and len(reqs) < len(arrivals):
                time.sleep(max(0.0, min(
                    arrivals[len(reqs)].t - t_first
                    - (time.perf_counter() - t0), 0.005)))
        fired = inj.fired
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the traffic's span: first submission to last completion (the quiet
    # tail that waits for the scale-down is not serving time)
    served_s = max(f.t_finished for f in reqs) - t0
    launches = pa.ragged_paged_attention.launches
    total_steps = sum(FleetEngine.steps_by_engine.values())
    snap = router.metrics.snapshot()
    status = scaler.status()

    # ---- checks
    for f in reqs:
        check(f.state == FRS.FINISHED and len(f.output) == FLEET_NEW,
              f"fleet request {f.id} ended {f.state} with "
              f"{len(f.output)} tokens ({f.finish_reason})")
    check(snap["lost"] == 0, f"router lost {snap['lost']} requests")
    check(all(k in events for k in ("a", "b", "c", "c_done")),
          f"chaos did not run: {events}")
    check(len(fired) == 1 and fired[0][:2] == ("serving.step", "io_error"),
          f"injected faults fired: {fired}")
    check(snap["failovers"] == {f"{events['a'][1]},io_error": 1,
                                f"{events['b'][1]},crash": 1},
          f"failovers {snap['failovers']}")
    check(snap["redispatched"] == expected_moves,
          f"redispatched {snap['redispatched']} != {expected_moves} in "
          f"flight at (a), (b) and the drains' stragglers")
    for f in reqs:
        prefixes = harvested.get(f.id, [])
        check(f.redispatches == len(prefixes),
              f"request {f.id}: {f.redispatches} re-dispatches, aboard "
              f"{len(prefixes)} failure events")
        for toks in prefixes:
            check(f.output[:len(toks)] == toks,
                  f"request {f.id}: output does not begin with the "
                  f"{len(toks)} tokens harvested before its failover")
        if prefixes:
            # the last dispatch admitted prompt + exactly the tokens
            # harvested before the last failover: none twice, none lost
            check(len(f._engine_req.prompt)
                  == len(f.prompt) + len(prefixes[-1]),
                  f"request {f.id}: re-dispatched with "
                  f"{len(f._engine_req.prompt) - len(f.prompt)} tokens, "
                  f"{len(prefixes[-1])} were harvested")
    check(FleetEngine.finite and all(FleetEngine.finite),
          "fleet logits not finite")
    check(launches == cfg.num_layers * total_steps,
          f"kernel launches {launches} != {cfg.num_layers} x "
          f"{total_steps} engine steps")
    caps = [c for c, _ in FleetEngine.graphs.values()]
    rep = watchdog.report().get("serving::unified_step", {})
    check(caps and all(c == 1 for c in caps)
          and rep.get("compiles") == len(caps)
          and rep.get("recompiles") == 0,
          f"fleet engines captured {caps}; watchdog {rep}")
    pools = [b for _, b in FleetEngine.graphs.values()]
    check(max(pools) <= GRAPH_POOL_BOUND,
          f"a graph pool holds {max(pools) / 2**20:.1f} MiB, bound "
          f"{GRAPH_POOL_BOUND / 2**20:.0f} MiB")
    ups = [e for e in status["events"] if e["direction"] == "up"]
    downs = [e for e in status["events"] if e["direction"] == "down"]
    check(any(e.get("replica") == 3 for e in ups),
          f"no fourth engine was appended: {status['events']}")
    check(set(serial_rep) <= FleetEngine.warmed,
          "an engine entered rotation without its warmup")
    check(downs and "tail_down_done" in events,
          "no scale-down in the quiet tail")
    check(sum(FleetEngine.hits_by_engine.values()) >= 1,
          "no prefix-cache hit in the fleet")
    check(snap["cache_aware_dispatches"] >= 1, "no cache-aware dispatch")

    # ---- report
    gen = sum(len(f.output) for f in reqs)
    ttft, moved = Histogram("ttft"), Histogram("ttft_failed_over")
    for f in reqs:
        for h in (ttft, moved) if f.redispatches else (ttft,):
            h.observe(f.t_first_token - f.t_submit)
    by_rep = {}
    for serial, rid in serial_rep.items():
        by_rep[rid] = by_rep.get(rid, 0) + \
            FleetEngine.steps_by_engine.get(serial, 0)
    peak = torch.cuda.max_memory_allocated()
    print(f"[phase 11] fleet of gpt3-1.3b bf16 engines (pool "
          f"{FLEET_ENGINE}), {len(reqs)} requests (trace seed "
          f"{FLEET_SEED}: prompts 64-1024, 3 cohorts sharing 256-token "
          f"prefixes at fraction 0.5, burst x5 over 1.0-2.5 s, {FLEET_NEW} "
          f"new tokens, greedy) replayed in wall time: served in "
          f"{served_s:.2f} s ({wall:.2f} s with the quiet tail), {ticks} "
          f"fleet ticks, {gen / served_s:.1f} generated tok/s "
          f"({card_line()})")
    print(f"[phase 11] TTFT (fleet clock) p50 "
          f"{ttft.percentile(50) * 1e3:.1f} ms p95 "
          f"{ttft.percentile(95) * 1e3:.1f} ms; failed-over requests "
          f"({moved.total}): p50 {moved.percentile(50) * 1e3:.1f} ms p95 "
          f"{moved.percentile(95) * 1e3:.1f} ms")
    print(f"[phase 11] chaos: (a) io_error on replica {events['a'][1]} at "
          f"tick {events['a'][0]} ({events['a'][2]} aboard), (b) kill of "
          f"replica {events['b'][1]} at tick {events['b'][0]} "
          f"({events['b'][2]} aboard), (c) drain of replica "
          f"{events['c'][1]} at tick {events['c'][0]} (restarted at tick "
          f"{events['c_done']}); drains (tick, replica, aboard, moved, "
          f"state) {events.get('drains')}; "
          f"redispatched {snap['redispatched']} = expected "
          f"{expected_moves}; lost {snap['lost']}; failovers "
          f"{snap['failovers']}")
    print(f"[phase 11] autoscaler bands {FLEET_SCALER}: events "
          + "; ".join(f"{e['direction']} {e['reason']} replica "
                      f"{e.get('replica')} at {e['time'] - t0:.2f} s "
                      f"(pressure {e['pressure_s']})"
                      for e in status["events"]))
    # where the host's time went (one thread drives every replica): the
    # engines' steps, the router around them, the autoscaler (its spawns
    # build and warm engines), and the rest (waits for arrivals, chaos,
    # the memory checks' collections)
    print(f"[phase 11] host time over {wall:.2f} s: router ticks "
          f"{router_s:.2f} s, of which engine steps {router_steps_s:.2f} s "
          f"and routing {router_s - router_steps_s:.2f} s "
          f"({(router_s - router_steps_s) / ticks * 1e3:.3f} ms/tick); "
          f"autoscaler {scaler_s:.2f} s; the rest "
          f"{wall - router_s - scaler_s:.2f} s; all engine steps "
          f"{sum(FleetEngine.step_s.values()) / max(total_steps, 1) * 1e3:.2f}"
          f" ms/step on the host (warmups included)")
    print(f"[phase 11] engine steps by replica {by_rep} (sum "
          f"{total_steps}); kernel launches {launches} = "
          f"{cfg.num_layers} x {total_steps}; prefix hits "
          f"{sum(FleetEngine.hits_by_engine.values())}; cache-aware "
          f"dispatches {snap['cache_aware_dispatches']}; peak memory "
          f"{peak / 2**30:.2f} GiB; memory beyond pools + params: "
          + ", ".join(f"{w} ({n} engines) {d / 2**20:+.1f} MiB"
                      for w, n, d in mem_checks))
    print(f"[phase 11] captured steps: {len(caps)} engines, captures "
          f"{sum(caps)} (watchdog serving::unified_step: {rep['calls']} "
          f"calls, {rep['compiles']} builds, {rep['recompiles']} "
          f"rebuilds); graph pools {min(pools) / 2**20:.1f}-"
          f"{max(pools) / 2**20:.1f} MiB an engine (bound "
          f"{GRAPH_POOL_BOUND / 2**20:.0f} MiB)")

    # ---- a single-engine oracle on the same prompts and params
    outputs = [f.output for f in reqs]
    prompts = [list(f.prompt) for f in reqs]
    del router, scaler, reqs
    gc.collect()
    torch.cuda.empty_cache()
    oracle = serving.Engine(cfg, params, device="cuda", **FLEET_ENGINE)
    oracle.warmup()
    steps0 = oracle.steps
    torch.cuda.synchronize()
    t_one = time.perf_counter()
    ref = oracle.generate(prompts, sp)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t_one
    same, diffs = 0, []
    for i, (a, b) in enumerate(zip(outputs, ref)):
        if a == b:
            same += 1
        else:
            diffs.append((i, next(j for j, (x, y) in enumerate(zip(a, b))
                                  if x != y)))
    print(f"[phase 11] one engine on the same {len(prompts)} prompts, "
          f"all submitted at once: {one_s:.2f} s, {oracle.steps - steps0} "
          f"steps, "
          f"{gen / one_s:.1f} generated tok/s; token identity against "
          f"it: {same}/{len(outputs)} equal; first differing position "
          f"of the others (request, position): {diffs}")
    del oracle, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ MoE and BERT (12-14)

MOE_EXPERTS = 8                    # Mixtral's expert count, top-2
MOE_TRAIN_LAYERS = 8               # phase 13's depth: what one card holds
MOE_CHECK_BATCH = (1, 2048)        # phase 13's fp32 kernel-vs-plain step
MOE_TRAIN_BATCH = (8, 2048)        # phase 13's throughput batch
BERT_BATCH = (32, 512)             # phase 14's batch
RESNET_CHECK_BATCH = 4             # phase 15 (a): card vs CPU, fp32
RESNET_BATCHES = (32, 128)         # phase 15 (b): bench_resnet's and 4x it
HAPI_FIT = (8, 32)                 # phase 15 (c): batches x images
ENCODER_BATCH = (32, 512)          # phase 15 (d), BERT-base widths


def moe_config(cfg):
    """``cfg``'s widths with every FFN a top-2 MoE of ``MOE_EXPERTS``
    experts (capacity factor 2.0, aux weight 0.01: GPTConfig's
    defaults)."""
    return dataclasses.replace(cfg, moe_experts=MOE_EXPERTS)


class RouteLog:
    """While installed, keeps every ``moe_route`` result (one MoE layer
    call's routing), in call order; a routing made while a CUDA graph is
    being captured goes to ``captured`` instead: its tensors live in the
    graph's memory, and every replay of the graph writes that step's
    routing into them."""

    def __init__(self, moe):
        self.moe, self.routes, self.captured = moe, [], []

    def __enter__(self):
        route = self._route = self.moe.moe_route
        import torch

        def spy(logits, **kw):
            r = route(logits, **kw)
            (self.captured if torch.cuda.is_current_stream_capturing()
             else self.routes).append(r)
            return r

        self.moe.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.moe.moe_route = self._route


def same_routes(torch, a, b):
    return len(a) == len(b) and all(
        torch.equal(x.expert, y.expert) and torch.equal(x.slot, y.slot)
        and torch.equal(x.keep, y.keep) for x, y in zip(a, b))


def drop_shares(torch, keeps, batches, L):
    """(dropped, all) (token, choice) assignments of the valid tokens and
    of the padding slots, over serving steps whose packings (rows, slots,
    qlens) are ``batches`` and whose routings' ``keep`` masks are
    ``keeps`` (one ``[L, T, top_k]`` tensor a step)."""
    check(len(keeps) == len(batches) and all(k.shape[0] == L
                                             for k in keeps),
          f"{len(keeps)} routings for {len(batches)} steps of {L} layers")
    sums = torch.zeros(4, dtype=torch.long, device="cuda")
    for keep, (rows, slots, qlens) in zip(keeps, batches):
        B = len(qlens)
        valid = (rows < B) & (slots < qlens[np.minimum(rows, B - 1)])
        v = torch.from_numpy(valid).cuda()[:, None]
        for kp in keep:
            drop = ~kp
            sums += torch.stack([(drop & v).sum(), v.sum() * kp.shape[1],
                                 (drop & ~v).sum(),
                                 (~v).sum() * kp.shape[1]])
    d, n, pd, pn = sums.tolist()
    return (d, n), (pd, pn)


def recording_engine(serving):
    """The port's Engine, keeping each step's packing as the host built
    it (rows, slots, qlens), whether its live logits were finite and,
    with a ``RouteLog`` installed before its capture (``log``), the
    ``keep`` masks its replay routed (a subclass: a patched bound method
    would tie the engine into a reference cycle)."""
    import torch

    class RecordingEngine(serving.Engine):
        def __init__(self, *args, log=None, **kw):
            super().__init__(*args, **kw)
            self.batches, self.finite, self.keeps = [], [], []
            self.log = log

        def _run_step(self, tokens, rows, slots, qlens, ctxs, tables):
            logits = super()._run_step(tokens, rows, slots, qlens, ctxs,
                                       tables)
            self.batches.append((rows.copy(), slots.copy(), qlens.copy()))
            self.finite.append(bool(np.isfinite(logits[qlens > 0]).all()))
            if self.log is not None and self.log.captured:
                self.keeps.append(torch.stack(
                    [r.keep for r in self.log.captured]))
            return logits

    return RecordingEngine


def phase_moe_step(torch, cfg, pa, moe, gpt_init, gpt_ragged_step):
    """Phase 12(a): one full-width MoE serving step in fp32 on phase 3's
    batch (a pool of 1024 pages), the kernel against the plain
    attention: each layer's ragged call at ``TOL["float32"]`` against the
    plain version on its inputs, every layer routed identically, and
    logits and written pages at ``TOL_FLASH["float32"]`` (the one-call
    differences grow through 24 layers; the CPU tests hold the whole
    step to JAX's at the same 1e-4)."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    L = cfg.num_layers
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(12),
                      device="cuda")
    args, k0, v0, tables, Q = mixed_batch(torch, cfg, 1024, torch.float32)
    k1, v1 = k0.clone(), v0.clone()
    call_errs = []

    def kernel_and_ref(q, kp, vp, pt, qlens, ctxs):
        # each layer's kernel call against the plain version on the same
        # inputs, at its live query slots
        out = pa.ragged_paged_attention(q, kp, vp, pt, qlens, ctxs)
        ref = pa._ragged_attention_ref(q, kp, vp, pt, qlens, ctxs)
        live_q = (torch.arange(q.shape[1], device=q.device)[None]
                  < qlens[:, None])
        call_errs.append((max_err(torch, out[live_q], ref[live_q]),
                          torch.allclose(out[live_q], ref[live_q],
                                         **TOL["float32"])))
        return out

    runs = []
    for kw, kp, vp in (({"attention": kernel_and_ref}, k1, v1),
                       ({"attention": pa._ragged_attention_ref}, k0, v0)):
        with RouteLog(moe) as log:
            logits, _, _ = gpt_ragged_step(cfg, params, *args, kp, vp,
                                           tables, max_q=Q, **kw)
        runs.append((logits, log.routes))
    torch.cuda.synchronize()
    live = torch.tensor([n > 0 for n in MIXED_QLENS], device="cuda")
    (lk, rk), (lp, rp) = runs
    lk, lp = lk[live], lp[live]
    check(bool(torch.isfinite(lk).all()), "MoE step logits not finite")
    err = max_err(torch, lk, lp)
    P = k0.shape[1] - 1                  # the scratch page is not compared
    k0, v0, k1, v1 = k0[:, :P], v0[:, :P], k1[:, :P], v1[:, :P]
    page_err = max(max_err(torch, k1, k0), max_err(torch, v1, v0))
    routed = same_routes(torch, rk, rp) and len(rk) == L
    r = rk[0]
    T, C = r.keep.shape[0], r.capacity
    dropped = sum(int((~x.keep).sum()) for x in rk)
    print(f"[phase 12] gpt3-1.3b x{MOE_EXPERTS} experts fp32 x{L} layers, "
          f"phase 3's batch ({T} tokens, C = {C}): logits max abs err "
          f"{err:.3g} (max |logit| {float(lp.abs().max()):.3g}), written "
          f"pages {page_err:.3g}; routing identical in all {len(rk)} "
          f"layers: {routed}; (token, choice) assignments dropped "
          f"{dropped} of {T * r.keep.shape[1] * L}")
    call_err = max(e for e, _ in call_errs)
    print(f"[phase 12] one ragged call, kernel vs plain on the same "
          f"inputs: max abs err {call_err:.3g} over {len(call_errs)} "
          f"layers (held to TOL float32 {TOL['float32']}); the whole "
          f"step above is held to TOL_FLASH float32 "
          f"{TOL_FLASH['float32']}, since the calls' differences feed "
          f"the next layers")
    check(len(call_errs) == L and all(ok for _, ok in call_errs),
          f"MoE step: a ragged call differs from the plain version by "
          f"{call_err:.3g}")
    check(routed, "MoE routing differs between kernel and plain attention")
    check(torch.allclose(lk, lp, **TOL_FLASH["float32"]),
          f"MoE step: kernel vs plain logits differ by {err:.3g}")
    check(torch.allclose(k1, k0, **TOL_FLASH["float32"])
          and torch.allclose(v1, v0, **TOL_FLASH["float32"]),
          f"MoE step: written pages differ by {page_err:.3g}")
    del params, k0, v0, k1, v1, runs, rk, rp, r
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_serving(torch, cfg, params, pa, moe, serving, watchdog):
    """Phase 12(b): the bf16 Engine over the full-width MoE model serving
    phase 4's 8 requests from its captured step, ragged launches held to
    L a step and one capture; tok/s, ms/step untraced and on the device
    by kind, and the share of (token, choice) assignments capacity drops
    (read from the captured routing after each replay).  Returns the
    launches."""
    L, E = cfg.num_layers, cfg.moe_experts
    t0 = time.perf_counter()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    watchdog.reset()
    with RouteLog(moe) as log:
        eng = recording_engine(serving)(cfg, params, page_size=16,
                                        num_pages=2048, max_batch_size=8,
                                        chunk_len=64, device="cuda",
                                        log=log)
        eng.warmup()
        eng.metrics = serving.ServingMetrics()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        check(len(log.captured) == L,
              f"{len(log.captured)} routings captured, {L} layers")
        lens, prompts = serving_prompts(cfg.vocab_size)
        eng.batches.clear()
        eng.keeps.clear()
        pa.ragged_paged_attention.launches = 0
        steps0 = eng.steps
        t0 = time.perf_counter()
        reqs = serve_requests(eng, serving, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.ragged_paged_attention.launches
        eng.log = None
    steps = eng.steps - steps0
    for r in reqs:
        check(r.state == serving.RequestState.FINISHED,
              f"request {r.id} ended {r.state}: {r.finish_reason}")
        check(len(r.output) == 32, f"request {r.id} made {len(r.output)}")
    check(all(eng.finite), "MoE serving logits not finite")
    check(launches == L * steps,
          f"MoE serving: kernel launches {launches} != {L} x {steps} steps")
    captures = check_one_capture(watchdog, [eng], "MoE serving")
    (d, n), (pd, pn) = drop_shares(torch, eng.keeps, eng.batches, L)
    eng.keeps.clear()
    del log
    gen = sum(len(r.output) for r in reqs)
    snap = eng.metrics.snapshot()
    print(f"[phase 12] Engine gpt3-1.3b x{E} experts bf16 x{L} layers "
          f"({n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB; "
          f"params, pool and warm-up {setup:.1f} s): served {len(reqs)} "
          f"requests (phase 4's prompts, 32 new tokens each, greedy) in "
          f"{steps} steps, {wall:.3f} s: {gen / wall:.1f} generated tok/s, "
          f"mean step {wall / steps * 1e3:.2f} ms, TTFT p50 "
          f"{snap['ttft_s']['p50'] * 1e3:.1f} ms, kernel launches "
          f"{launches} = {L} x {steps}, {captures}")
    print(f"[phase 12] capacity drops of (token, choice) assignments: "
          f"valid tokens {d} of {n} ({d / max(n, 1):.4f}), padding slots "
          f"{pd} of {pn} ({pd / max(pn, 1):.4f})")
    # a replayed graph's kernels have no launching op to split the MoE
    # work by: phase 16 splits it on the eager route's trace
    profile_serving(torch, eng, serving, cfg.vocab_size, tag="phase 12")
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_step_flops(cfg, B, S):
    """(FLOPs one training step does, FLOPs by ``gpt_flops_per_token``)
    at batch ``B`` x ``S``: the first counts the E·C expert slots the
    expert products compute (forward and backward, 12·D·F a slot), the
    dense products and the tied head at 6 FLOPs a weight a token, and
    attention at ``gpt_flops_per_token``'s 12·L·D·S a token; the second
    is 6N + attention, with N counting all E experts for every token."""
    from paddle_tpu_torch.distributed.moe import moe_capacity
    from paddle_tpu_torch.models import gpt_flops_per_token

    D, F_, L, V = cfg.hidden, cfg.ffn_hidden, cfg.num_layers, cfg.vocab_size
    E, n = cfg.moe_experts, B * S
    C = moe_capacity(n, E, cfg.moe_capacity_factor, cfg.moe_top_k)
    dense = 6 * n * (L * (4 * D * D + D * E) + V * D)
    attention = n * 12 * L * D * S
    experts = L * E * C * 12 * D * F_
    return dense + attention + experts, n * gpt_flops_per_token(cfg, S)


def moe_train_check(torch, cfg, fa, moe, gpt_init, gpt_loss):
    """Phase 13's first part: one fp32 step of the MoE model at
    ``MOE_CHECK_BATCH``, loss and every gradient (gate_w included) with
    the kernels against the plain attention at ``TOL_FLASH["float32"]``,
    and identical routing.  Everything it allocates is freed on return."""
    L, E = cfg.num_layers, cfg.moe_experts
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = gpt_init(c32, torch.Generator(device="cuda").manual_seed(13),
                      device="cuda")
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           MOE_CHECK_BATCH)).cuda()
    names = ["wte", "wpe", "lnf_g", "lnf_b"] + [
        f"blocks/{k}" for k in sorted(params["blocks"])]
    leaves = [params[n] if "/" not in n else params["blocks"][n[7:]]
              for n in names]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for label, attention in (("kernel", None),
                             ("plain", lambda q, k, v:
                              fa.flash_attention_plain(q, k, v,
                                                       causal=True))):
        before = dict(fa.launches)
        with RouteLog(moe) as log:
            loss = gpt_loss(c32, params, tokens, attention=attention)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[label] = (float(loss.detach()), grads, log.routes)
        if label == "kernel":
            # remat "dots" runs each forward twice; an fp32 backward is
            # two kernels (dK/dV, then dQ)
            got = {n: fa.launches[n] - before[n] for n in before}
            check(got == {"fwd": 2 * L, "bwd": 2 * L},
                  f"MoE fp32 training step launched {got}")
    (lk, gk, rk), (lp, gp, rp) = runs["kernel"], runs["plain"]
    routed = same_routes(torch, rk, rp)
    worst = (0.0, "")
    bad = []
    for name, a, b in zip(names, gk, gp):
        check(bool(torch.isfinite(a).all()), f"grad {name} not finite")
        worst = max(worst, (max_err(torch, a, b), name))
        if not torch.allclose(a, b, **TOL_FLASH["float32"]):
            bad.append(name)
    print(f"[phase 13] gpt3-1.3b x{E} experts fp32 x{L} layers, batch "
          f"{MOE_CHECK_BATCH[0]} x {MOE_CHECK_BATCH[1]}, one training step: "
          f"loss kernel {lk:.6f} plain {lp:.6f} (|diff| {abs(lk - lp):.3g});"
          f" worst gradient max abs err {worst[0]:.3g} ({worst[1]}) over "
          f"{len(names)} leaves, gate_w included; routing identical in all "
          f"{len(rk)} calls (forward and recompute): {routed}; flash "
          f"launches {got}")
    check(routed, "MoE training: routing differs between kernel and plain")
    check(abs(lk - lp) <= 1e-4 + 1e-4 * abs(lp),
          f"MoE training: loss differs by {abs(lk - lp):.3g}")
    check(not bad, f"MoE training: gradients {bad} differ beyond "
                   f"atol = rtol = 1e-4")


def phase_moe_train(torch, cfg, fa, moe, distributed, gpt_init, gpt_loss):
    """Phase 13: MoE training at the full width on ``MOE_TRAIN_LAYERS``
    layers.  First one fp32 step (``moe_train_check``); then
    ``HybridEngine`` bf16 at ``MOE_TRAIN_BATCH``, 10 steps.  Returns the
    flash launches over the timed steps."""
    cfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    L, E = cfg.num_layers, cfg.moe_experts
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_check(torch, cfg, fa, moe, gpt_init, gpt_loss)
    gc.collect()
    torch.cuda.empty_cache()

    B, S = MOE_TRAIN_BATCH
    eng = distributed.HybridEngine(cfg, device="cuda")
    check(cfg.remat == "dots" and eng._has_master(),
          "expected remat 'dots' and an fp32 master")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)
    run = train_run(torch, eng, tokens, labels, [fa.launches], experts=E)
    return report_training(torch, "phase 13", cfg, run, B, S,
                           moe_step_flops(cfg, B, S), {
                               "fwd": 2 * L, "bwd": L},
                           f"gpt3-1.3b x{E} experts bf16 x{L} layers")


def flash_noncausal(torch, fa, B, H, S, D):
    """The bf16 flash forward and backward at q/k/v ``[B, H, S, D]``
    without the causal mask: kernel (forward) and whole-call (backward)
    ms, plain ms, bound and SDPA's times, and the max abs error against
    the plain version."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(D)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, False)
    ref, ref_lse = fa._flash_fwd_ref(q, k, v, scale, False)
    delta = fa._delta(ref, do)
    dq, dk, dv = fa._bwd_sm90(q, k, v, do, ref_lse, delta, scale, False)
    rk, rv = fa._bwd_dkdv_ref(q, k, v, do, ref_lse, delta, scale, False)
    rq = fa._bwd_dq_ref(q, k, v, do, ref_lse, delta, scale, False)
    torch.cuda.synchronize()
    errs = {"fwd": max(max_err(torch, out, ref), max_err(torch, lse,
                                                          ref_lse)),
            "bwd": max(max_err(torch, dq, rq), max_err(torch, dk, rk),
                       max_err(torch, dv, rv))}
    for name, a, b in (("out", out, ref), ("dq", dq, rq), ("dk", dk, rk),
                       ("dv", dv, rv)):
        check(torch.allclose(a.float(), b.float(), **TOL_FLASH["bfloat16"]),
              f"non-causal flash {name} != plain at {[B, H, S, D]}: "
              f"{max_err(torch, a, b):.3g}")
    del ref, rq, rk, rv, dq, dk, dv
    ms = {"fwd": time_ms(torch, lambda: fa._flash_fwd_cuda(
              q, k, v, scale, False), 20),
          "bwd": time_ms(torch, lambda: fa._bwd_sm90(
              q, k, v, do, lse, delta, scale, False), 20)}
    plain = {"fwd": time_ms(torch, lambda: fa._flash_fwd_ref(
                 q, k, v, scale, False), 3, warmup=1),
             "bwd": time_ms(torch, lambda: (fa._bwd_dkdv_ref(
                 q, k, v, do, lse, delta, scale, False), fa._bwd_dq_ref(
                 q, k, v, do, lse, delta, scale, False)), 3, warmup=1)}
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib = {"fwd": time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v), 20)}
    lout = F.scaled_dot_product_attention(lq, lk, lv)
    lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do, retain_graph=True), 20)
    result = {}
    for name, (nbytes, flops) in flash_work(B, H, S, D, False).items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        result[name] = {"shape": [B, H, S, D], "max_abs_err": errs[name],
                     "ms": ms[name], "plain_ms": plain[name],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": lib[name]}
    del q, k, v, do, out, lse, delta, lq, lk, lv, lout
    torch.cuda.empty_cache()
    return result


def phase_bert_train(torch, fa, distributed, models):
    """Phase 14: ``HybridEngine(BertAdapter)`` on BERT-base, bf16, batch
    32 x 512 with MLM corruption at 0.15 ([MASK] the last id), 10 steps;
    then the non-causal flash kernels at its attention shape against
    their bound and SDPA.  Returns (flash launches over the timed steps,
    the non-causal times)."""
    cfg = models.BERT_CONFIGS["bert-base"]
    L, V = cfg.num_layers, cfg.vocab_size
    B, S = BERT_BATCH
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(14)
    tokens = rng.randint(0, V, (B, S))
    mask = rng.rand(B, S) < 0.15
    labels = np.where(mask, tokens, -100)
    corrupted = np.where(mask, V - 1, tokens)
    eng = distributed.HybridEngine(distributed.BertAdapter(cfg),
                                   device="cuda")
    n_params = sum(t.numel() for t in _leaves(models.bert_init(
        cfg, device="cuda")))
    flops = B * S * (6 * n_params + 12 * L * cfg.hidden * S)
    run = train_run(torch, eng, corrupted, labels, [fa.launches])
    launches = report_training(torch, "phase 14", cfg, run, B, S, flops,
                               {"fwd": 2 * L, "bwd": L},
                               f"bert-base bf16 ({n_params / 1e6:.1f} M "
                               f"params), MLM at 0.15")
    H, D = cfg.num_heads, cfg.head_dim
    times = flash_noncausal(torch, fa, B, H, S, D)
    for name, t in times.items():
        print(f"[phase 14] flash {name} at q/k/v {[B, H, S, D]} bf16 "
              f"non-causal: {'whole call ' if name == 'bwd' else 'kernel '}"
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), SDPA "
              f"{t['library_ms']:.4f} ms, max abs err {t['max_abs_err']:.3g}")
    return launches, times



# ------------------------------------------------ the eager API (15)


@contextlib.contextmanager
def torch_default_tf32(torch):
    """PyTorch's default flags (fp32 matmuls exact, cuDNN's fp32
    convolutions allowed TF32) for the duration, then this script's."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _maxrel(torch, a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def resnet_model(paddle, lr, wd=None, metrics=None, seed=0):
    paddle.seed(seed)
    net = paddle.vision.resnet50(num_classes=1000)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=model.parameters(),
        weight_decay=wd), paddle.nn.CrossEntropyLoss(), metrics)
    return model


def resnet_card_vs_cpu(torch, paddle):
    """Phase 15 (a): one fp32 train_batch of ResNet-50 on the card and on
    the CPU from the same weights and batch (numpy seed 15)."""
    B = RESNET_CHECK_BATCH
    rng = np.random.RandomState(15)
    x = rng.rand(B, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, (B,)).astype(np.int64)
    runs, start = {}, None
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        model = resnet_model(paddle, 0.1, 1e-4, paddle.metric.Accuracy())
        if start is None:
            start = {k: v.detach().cpu().clone()
                     for k, v in model.network.state_dict().items()}
        else:
            model.network.set_state_dict(start)
        logits = []
        # the first forward's output only (the card's first call runs the
        # step eagerly, then captures it, which computes nothing); a
        # device copy, as a read to the host cannot be captured
        hook = model.network.register_forward_post_hook(
            lambda m, a, out: None if logits else logits.append(
                out.detach().clone()))
        t0 = time.perf_counter()
        loss, res = model.train_batch(x, y)
        secs = time.perf_counter() - t0
        hook.remove()
        runs[dev] = {"loss": loss, "acc": res["acc"],
                     "logits": logits[0].cpu(),
                     "s": secs, "state": {
                         k: v.detach().cpu() for k, v in
                         model.network.state_dict().items()}}
        del model
    paddle.set_device("gpu")
    gpu, cpu = runs["gpu"], runs["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    logit_err = _maxrel(torch, gpu["logits"], cpu["logits"])
    buf_err = max(_maxrel(torch, gpu["state"][k], cpu["state"][k])
                  for k in start if k.endswith(("_mean", "_variance")))
    params = [k for k in start if not k.endswith(("_mean", "_variance"))]
    upd = {k: (gpu["state"][k] - start[k], cpu["state"][k] - start[k])
           for k in params}
    per = {k: _maxrel(torch, g, c) for k, (g, c) in upd.items()}
    worst = max(per, key=per.get)
    diff = sum(float((g - c).square().sum()) for g, c in upd.values())
    ref = sum(float(c.square().sum()) for _, c in upd.values())
    glob = (diff / ref) ** 0.5
    print(f"[phase 15a] ResNet-50 fp32 train_batch at {B} x 3 x 224 x 224, "
          f"card {gpu['s']:.2f} s, CPU {cpu['s']:.2f} s: loss card "
          f"{gpu['loss']:.6f} CPU {cpu['loss']:.6f} (relative "
          f"{loss_rel:.3g}, checked at 1e-4); logits max diff / max "
          f"{logit_err:.3g} (checked at 1e-3); BN buffers worst "
          f"{buf_err:.3g} (1e-3); parameter updates: L2 of the difference "
          f"/ L2 of the CPU's {glob:.3g} (0.1), worst tensor {worst} "
          f"{per[worst]:.3g} (1.0); {len(params)} parameters, "
          f"{len(start) - len(params)} buffers")
    check(loss_rel <= 1e-4, f"15a: loss differs by {loss_rel:.3g}")
    check(logit_err <= 1e-3, f"15a: logits differ by {logit_err:.3g}")
    check(buf_err <= 1e-3, f"15a: BN buffers differ by {buf_err:.3g}")
    check(glob <= 0.1 and per[worst] <= 1.0,
          f"15a: parameter updates differ ({glob:.3g}, {worst} "
          f"{per[worst]:.3g})")
    check(gpu["acc"] == cpu["acc"], "15a: accuracy differs")


def resnet_flops(torch, net, B):
    """Training FLOPs of one step from the convolution and linear shapes:
    2 x MACs forward, x 3 for forward and backward."""
    macs = []

    def conv(m, args, out):
        macs.append(out.numel() * m.weight.shape[1]
                    * int(np.prod(m.weight.shape[2:])))

    def linear(m, args, out):
        macs.append(out.numel() * m.weight.shape[0])

    hooks = [m.register_forward_post_hook(
        conv if type(m).__name__ == "Conv2D" else linear)
        for m in net.modules() if type(m).__name__ in ("Conv2D", "Linear")]
    net.eval()
    with torch.no_grad():
        net(torch.zeros(1, 3, 224, 224, device="cuda"))
    net.train()
    for h in hooks:
        h.remove()
    return 3 * 2 * sum(macs) * B


def resnet_kind(op):
    """The kind an aten op's device time counts under in phase 15 (b)."""
    if "convolution_backward" in op:
        return "conv backward"
    if op in ("aten::cudnn_convolution", "aten::_convolution",
              "aten::convolution"):
        return "conv forward"
    if "batch_norm" in op or op == "aten::var_mean":
        return "batch norm"
    if op.startswith("aten::_foreach_"):
        return "optimizer"
    return None


def profile_kinds(torch, step, kind_of):
    """Device time of one step: busy ms from the kernels, and the device
    ms of the aten ops ``kind_of`` names a kind (the kernels each op
    launched itself), the rest under 'elementwise and rest'; and the
    host clock's ms over the same traced step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_kind, top = 0.0, {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.key.startswith(RANGES):
                busy += us / 1e3
                top.append((us / 1e3, e.key[:56]))
            continue
        kind = kind_of(e.key)
        if kind is not None:
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    check(busy > 0, "profiler saw no device time")
    by_kind["elementwise and rest"] = busy - sum(by_kind.values())
    return busy, wall, by_kind, sorted(top)[::-1][:6]


def resnet_throughput(torch, paddle, B):
    """Phase 15 (b) at batch ``B``: 2 warm-up steps, 5 timed, 2 more and
    a profiled one, all of ``train_batch`` under bf16 ``auto_cast`` on one
    fixed batch (bench_resnet's inputs: numpy seeds 0 and 1)."""
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    model = resnet_model(paddle, 0.1)
    flops = resnet_flops(torch, model.network, B)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        B, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.RandomState(1).randint(
        0, 1000, (B,))).cuda()
    losses = []

    def step():
        with paddle.amp.auto_cast(dtype="bfloat16"):
            losses.append(model.train_batch(x, y)[0])

    watchdog().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    timed = 5
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        step()
    # busy time from a replay; the kinds, by launching aten op, from one
    # more step on the eager route
    busy, traced, _, top = profile_kinds(torch, step, resnet_kind)
    captured = check_captured_once(model, "hapi::train_step",
                                   f"15b batch {B}")
    pool = model._train_fn.pool_bytes
    with eager_route(torch, model):
        eager_busy, eager_traced, kinds, _ = profile_kinds(
            torch, step, resnet_kind)
    mfu = flops / (ms / 1e3) / BF16_FLOPS
    print(f"[phase 15b] ResNet-50 bench_resnet protocol, batch {B}: "
          f"{B / ms * 1e3:.1f} imgs/s, {ms:.1f} ms/step, MFU {mfu:.4f} on "
          f"{flops / 1e12:.3f} TFLOP a step (convolutions and the linear "
          f"layer: 2 x MACs forward, x 3; 989 TFLOP/s peak; {card_line()}), "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"[phase 15b] batch {B}, graph route ({captured}; pool "
          f"{pool / 2**20:.1f} MiB), one traced replay (10th step): device "
          f"busy {busy:.1f} ms of its {traced:.1f} ms on the host clock "
          f"(busy share {busy / traced:.3f}; untraced {ms:.1f} ms/step); "
          f"the eager route's traced step (11th): busy {eager_busy:.1f} ms "
          f"of {eager_traced:.1f} ms (share {eager_busy / eager_traced:.3f})"
          f", by kind: " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in kinds.items()))
    print(f"[phase 15b] batch {B}, top kernels ms: " + "; ".join(
        f"{name} {t:.2f}" for t, name in top))
    print(f"[phase 15b] batch {B}, losses over the 11 steps at lr 0.1: "
          + " ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)), f"15b: loss not finite at batch {B}")
    del model


def resnet_loss_falls(torch, paddle, B, lr=0.01):
    """The loss of 10 bf16 O1 steps on a fixed batch falls; at the
    protocol's lr 0.1 the random-init net first blows up, so this check
    runs at ``lr``."""
    paddle.set_device("gpu")
    model = resnet_model(paddle, lr)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        B, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.RandomState(1).randint(
        0, 1000, (B,))).cuda()
    losses = []
    for _ in range(10):
        with paddle.amp.auto_cast(dtype="bfloat16"):
            losses.append(model.train_batch(x, y)[0])
    print(f"[phase 15b] batch {B}, losses over 10 steps at lr {lr}: "
          + " ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"15b: loss did not fall at batch {B}")
    del model


def images(paddle, n, seed):
    """A seeded in-memory dataset of ``n`` 224 x 224 images, 1000
    classes."""
    class Images(paddle.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(seed)
            self.x = rng.rand(n, 3, 224, 224).astype(np.float32)
            self.y = rng.randint(0, 1000, (n,)).astype(np.int64)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    return Images()


def hapi_on_card(torch, paddle):
    """Phase 15 (c): fit one epoch, evaluate, predict; save and load."""
    import tempfile

    n_batch, bs = HAPI_FIT
    paddle.set_device("gpu")
    model = resnet_model(paddle, 0.01, 1e-4, paddle.metric.Accuracy())
    train = images(paddle, n_batch * bs, 17)
    test = images(paddle, 2 * bs, 18)
    np.random.seed(0)
    t0 = time.perf_counter()
    hist = model.fit(train, batch_size=bs, epochs=1, verbose=0)
    fit_s = time.perf_counter() - t0
    logs = model.evaluate(test, batch_size=bs, verbose=0)
    preds = model.predict(test, batch_size=bs)[0]
    print(f"[phase 15c] fit: 1 epoch of {n_batch} x {bs} at 224 x 224 "
          f"fp32 in {fit_s:.2f} s, loss {hist[0]['loss']:.4f} acc "
          f"{hist[0]['acc']:.4f}; evaluate loss {logs['loss']:.4f} acc "
          f"{logs['acc']:.4f}; predict {preds.shape}; graphs captured "
          f"{model.captures}")
    check(model.captures == {"train": 1, "eval": 1},
          f"15c: captures {model.captures}")
    check(len(hist) == 1 and np.isfinite(hist[0]["loss"]), "15c: fit")
    check(np.isfinite(logs["loss"]) and 0 <= logs["acc"] <= 1, "15c: eval")
    check(preds.shape == (2 * bs, 1000) and np.isfinite(preds).all(),
          "15c: predict")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50")
        model.save(path)
        other = resnet_model(paddle, 0.01, 1e-4, seed=1)
        other.load(path)
    same = all(torch.equal(a, b) for a, b in zip(
        model.network.state_dict().values(),
        other.network.state_dict().values()))
    same_opt = all(torch.equal(s["velocity"],
                               other._opt_state["slots"][k]["velocity"])
                   for k, s in model._opt_state["slots"].items())
    print(f"[phase 15c] save/load on the card: weights and buffers "
          f"bit-equal {same}, velocities bit-equal {same_opt}")
    check(same and same_opt, "15c: save/load is not bit-equal")
    del model, other, train, test


def encoder_on_flash(torch, paddle, fa):
    """Phase 15 (d): nn.TransformerEncoder at BERT-base widths on the flash
    kernels.  Returns the launches over the timed training steps."""
    B, S = ENCODER_BATCH
    L = 12
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    paddle.seed(0)
    enc = paddle.nn.TransformerEncoder(paddle.nn.TransformerEncoderLayer(
        768, 12, 3072, dropout=0.1, activation="gelu", attn_dropout=0.0), L)
    x = torch.randn(B, S, 768, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(15))

    def zero():
        for k in fa.launches:
            fa.launches[k] = 0

    enc.eval()
    zero()
    with torch.no_grad(), paddle.amp.auto_cast():
        out = enc(x)
    torch.cuda.synchronize()
    eval_launches = dict(fa.launches)
    real = fa.flash_attention
    fa.flash_attention = fa.flash_attention_plain
    try:
        with torch.no_grad(), paddle.amp.auto_cast():
            plain = enc(x)
    finally:
        fa.flash_attention = real
    err = max_err(torch, out, plain)
    print(f"[phase 15d] TransformerEncoder 12 x (768, 12 heads, FFN 3072) "
          f"at {B} x {S}, bf16 auto_cast: eval launches {eval_launches}; "
          f"output vs the plain attention max abs err {err:.3g} (atol "
          f"{TOL_ENCODER['atol']}, rtol {TOL_ENCODER['rtol']})")
    check(eval_launches == {"fwd": L, "bwd": 0},
          f"15d: eval launches {eval_launches}")
    check(torch.allclose(out.float(), plain.float(), **TOL_ENCODER),
          f"15d: encoder on flash != plain: {err:.3g}")
    del out, plain
    enc.train()
    opt = paddle.optimizer.AdamW(1e-4, parameters=enc.parameters())

    def step():
        with paddle.amp.auto_cast():
            loss = enc(x).float().square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    zero()
    timed = 5
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    train_launches = dict(fa.launches)
    for layer in enc.layers:
        layer.self_attn.dropout = 0.1
    zero()
    step()
    torch.cuda.synchronize()
    drop_launches = dict(fa.launches)
    print(f"[phase 15d] training step (AdamW, bf16 auto_cast): {ms:.1f} "
          f"ms/step, launches over {timed} steps {train_launches}; with "
          f"attention dropout 0.1 one step launches {drop_launches}")
    check(train_launches == {"fwd": L * timed, "bwd": L * timed},
          f"15d: training launches {train_launches}")
    check(drop_launches == {"fwd": 0, "bwd": 0},
          f"15d: attention dropout launched {drop_launches}")
    del enc, opt, x
    return train_launches


def phase_eager(torch, fa):
    """Phase 15, under PyTorch's default TF32 flags."""
    import paddle_tpu_torch as paddle

    with torch_default_tf32(torch):
        resnet_card_vs_cpu(torch, paddle)
        for B in RESNET_BATCHES:
            resnet_throughput(torch, paddle, B)
            resnet_loss_falls(torch, paddle, B)
        hapi_on_card(torch, paddle)
        launches = encoder_on_flash(torch, paddle, fa)
    gc.collect()
    torch.cuda.empty_cache()
    return launches

def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


# ------------------------------------- the captured training steps (17)

TRAIN_CHECK_LAYERS = 4             # phase 17 (a): GPT-3 1.3B widths, fp32
TRAIN_CHECK_BATCH = (2, 2048)
HAPI_TAIL = (3, 8, 4)              # phase 17 (c): fit batches, size, tail


def _flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape"):
            out[prefix + k] = v.detach()
    return out


def train_routes_fp32(torch, distributed, dropout=0.0, accum=1):
    """Phase 17 (a): ``HybridEngine`` at GPT-3 1.3B's widths on
    ``TRAIN_CHECK_LAYERS`` layers, fp32, remat "dots", batch
    ``TRAIN_CHECK_BATCH``: 3 steps on the eager route (``eager_route``)
    and 3 on the graph route from one ``init(seed=0)`` and one batch; the losses, every
    parameter and every Adam slot held at ``TOL["float32"]``.  With
    dropout, the device keys (so the masks) of the routes are equal
    step for step, and the masks differ from one step to the next."""
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.models.gpt import _dropout, _fold

    cfg = dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"], dtype="float32",
                              num_layers=TRAIN_CHECK_LAYERS, dropout=dropout)
    check(cfg.remat == "dots", "expected remat 'dots'")
    B, S = TRAIN_CHECK_BATCH
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)
    runs = {}
    for route in ("eager", "graph"):
        gc.collect()
        torch.cuda.empty_cache()
        eng = distributed.HybridEngine(
            cfg, device="cuda",
            engine_cfg=distributed.EngineConfig(accum_steps=accum))
        params, opt = eng.init(seed=0)
        losses, keys = [], []
        t0 = time.perf_counter()
        with (eager_route(torch, eng) if route == "eager"
              else contextlib.nullcontext()):
            for _ in range(3):
                params, opt, loss = eng.step(params, opt, tokens, labels,
                                             dropout_seed=17)
                losses.append(loss)
                keys.append(eng._key.clone())
        torch.cuda.synchronize()
        runs[route] = dict(eng=eng, params=params, opt=opt, keys=keys,
                           losses=torch.stack(losses),
                           s=time.perf_counter() - t0)
    e, g = runs["eager"], runs["graph"]
    what = f"17a dropout {dropout}, accum {accum}"
    check(g["eng"].captures == 1 and e["eng"].captures == 0,
          f"{what}: captures {g['eng'].captures} / {e['eng'].captures}")
    pairs = [("loss", g["losses"], e["losses"])]
    for name, tree in (("param", "params"), ("slot", "opt")):
        want = _flat_tensors(e[tree] if tree == "params"
                             else e[tree]["slots"])
        got = _flat_tensors(g[tree] if tree == "params"
                            else g[tree]["slots"])
        check(want.keys() == got.keys(), f"{what}: {name} trees differ")
        pairs += [(f"{name} {k}", got[k], want[k]) for k in want]
    errs = [(max_err(torch, a, b), k) for k, a, b in pairs]
    bad = [k for k, a, b in pairs
           if not torch.allclose(a.float(), b.float(), **TOL["float32"])]
    worst = max(errs)
    n_slots = sum(k.startswith("slot") for k, _, _ in pairs)
    print(f"[phase 17a] gpt3-1.3b widths x{TRAIN_CHECK_LAYERS} layers fp32, "
          f"batch {B} x {S}, remat dots, dropout {dropout}, accum_steps "
          f"{accum}: 3 steps eager ({e['s']:.2f} s) and graph "
          f"({g['s']:.2f} s, 1 capture); losses eager "
          + " ".join(f"{float(x):.6f}" for x in e["losses"]) + " graph "
          + " ".join(f"{float(x):.6f}" for x in g["losses"])
          + f"; largest difference {worst[0]:.3g} ({worst[1]}) over the "
          f"losses, {len(pairs) - 1 - n_slots} parameters and {n_slots} "
          f"Adam slots (atol {TOL['float32']['atol']}, rtol "
          f"{TOL['float32']['rtol']})")
    check(not bad, f"{what}: graph != eager at {bad[:4]}")
    if dropout:
        same = all(torch.equal(a, b) for a, b in zip(e["keys"], g["keys"]))
        x = torch.ones(1 << 16, device="cuda")
        masks = [_dropout(x, dropout, _fold(k, 0)) != 0 for k in g["keys"]]
        differ = all(not torch.equal(a, b) for a, b in zip(masks,
                                                           masks[1:]))
        kept = [float(m.float().mean()) for m in masks]
        print(f"[phase 17a] dropout keys equal between the routes step for "
              f"step: {same}; masks differ from step to step: {differ}; "
              f"kept shares " + " ".join(f"{k:.4f}" for k in kept))
        check(same and differ, f"{what}: masks (same {same}, differ "
                               f"{differ})")
    del runs, e, g
    gc.collect()
    torch.cuda.empty_cache()


def route_times(torch, step, span, tmp, tag, timed=5, traced=3):
    """One route of a training step: 2 warm-up calls (on the graph route
    the eager step and the capture, then a replay), ``timed`` on the host
    clock, peak memory from the first call on (the capture's included);
    then ``traced`` calls under the ported ``Profiler``: device ms a step
    (kernels only, the ranges' device events apart), the host clock's ms
    a step over the same traced calls (the busy share's denominator) and
    the chrome export's ``span`` spans, one a step."""
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated()
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                    emit_counters=False)
    with prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / traced * 1e3
    path = os.path.join(tmp, f"{tag}.json")
    prof.export(path)
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X" and e["name"] == span]
    check(len(spans) == traced, f"{tag}: chrome export holds {len(spans)} "
                                f"{span} spans for {traced} steps")
    us = 0.0
    for e in prof.device_profile.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith(RANGES):
            continue
        t = getattr(e, "self_device_time_total", None)
        us += getattr(e, "self_cuda_time_total", 0.0) if t is None else t
    check(us > 0, f"{tag}: the profiler saw no device time")
    return {"ms": ms, "peak": peak, "busy": us / traced / 1e3,
            "traced_ms": traced_ms, "spans": len(spans)}


def print_routes(tag, res, card):
    for route, r in res.items():
        print(f"[phase 17b] {tag} {route}: {r['ms']:.3f} ms/step (host "
              f"clock, 5 steps), device {r['busy']:.3f} ms/step of "
              f"{r['traced_ms']:.3f} on the host clock over {r['spans']} "
              f"traced steps (busy share {r['busy'] / r['traced_ms']:.3f}),"
              f" peak memory "
              f"{r['peak'] / 2**30:.2f} GiB (max_memory_allocated), graph "
              f"pool {r['pool'] / 2**20:.1f} MiB ({card})")
    e, g = res["eager"], res["graph"]
    print(f"[phase 17b] {tag}: graph / eager speed {e['ms'] / g['ms']:.3f}x,"
          f" peak memory graph / eager {g['peak'] / e['peak']:.4f}")


def train_routes_times(torch, distributed, paddle, card):
    """Phase 17 (b): bf16 phase 7's cell (1.3B, 8 x 2048) and 15 (b)'s
    ResNet-50 at batch 32, each on the eager route and on the graph
    route (``route_times``); the 1.3B graph route's peak memory held to
    within 10 % of the eager route's.  The eager 1.3B route's traced
    step gives the optimizer's range (a replay has none)."""
    import tempfile

    from paddle_tpu_torch.models import GPT_CONFIGS

    cfg = GPT_CONFIGS["gpt3-1.3b"]
    B, S = 8, 2048
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)
    gpt, resnet = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for route in ("eager", "graph"):
            gc.collect()
            torch.cuda.empty_cache()
            eng = distributed.HybridEngine(cfg, device="cuda")
            params, opt = eng.init(seed=0)

            def step():
                nonlocal params, opt
                params, opt, _ = eng.step(params, opt, tokens, labels)

            with (eager_route(torch, eng) if route == "eager"
                  else contextlib.nullcontext()):
                gpt[route] = route_times(torch, step, "hybrid_engine::step",
                                         tmp, f"gpt_{route}")
                if route == "eager":
                    spans = profile_step(torch, step)["spans"]
                    print("[phase 17b] gpt3-1.3b eager route, device spans "
                          "of the ranges: " + ", ".join(
                              f"{k} {v:.1f} ms" for k, v in spans.items()))
            gpt[route]["pool"] = eng.graph_pool_bytes
            del eng, params, opt, step
        print_routes("gpt3-1.3b bf16, batch 8 x 2048", gpt, card)
        ratio = gpt["graph"]["peak"] / gpt["eager"]["peak"]
        check(ratio <= 1.10, f"17b: the graph route's peak memory is "
                             f"{ratio:.3f} x the eager route's")
        gc.collect()
        torch.cuda.empty_cache()
        with torch_default_tf32(torch):
            paddle.set_device("gpu")
            x = torch.from_numpy(np.random.RandomState(0).rand(
                32, 3, 224, 224).astype(np.float32)).cuda()
            y = torch.from_numpy(np.random.RandomState(1).randint(
                0, 1000, (32,))).cuda()
            for route in ("eager", "graph"):
                model = resnet_model(paddle, 0.1)

                def step():
                    with paddle.amp.auto_cast(dtype="bfloat16"):
                        model.train_batch(x, y)

                with (eager_route(torch, model) if route == "eager"
                      else contextlib.nullcontext()):
                    resnet[route] = route_times(
                        torch, step, "hapi::train_step", tmp,
                        f"resnet_{route}")
                resnet[route]["pool"] = model._train_fn.pool_bytes
                del model, step
                gc.collect()
                torch.cuda.empty_cache()
        print_routes("ResNet-50 bf16 O1, batch 32", resnet, card)


def hapi_eval_routes(torch, paddle):
    """Phase 17 (c): ``eval_batch`` of ResNet-50 (fp32, 8 x 3 x 224 x
    224, its batch norm in train mode, so the step would update the
    buffers) on the eager and the graph route from the same weights: the
    loss and the logits equal at ``TOL["float32"]``, the buffers
    unchanged on both; then ``fit`` over two epochs of ``HAPI_TAIL``
    (full batches and a tail): the captures it costs."""
    rng = np.random.RandomState(17)
    x = rng.rand(8, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, (8,)).astype(np.int64)
    out = {}
    with torch_default_tf32(torch):
        paddle.set_device("gpu")
        for route in ("eager", "graph"):
            model = resnet_model(paddle, 0.01)
            net = model.network
            bufs = {k: b.clone() for k, b in net.named_buffers()}
            with (eager_route(torch, model) if route == "eager"
                  else contextlib.nullcontext()):
                losses = [model.eval_batch(x, y)[0] for _ in range(2)]
                loss, logits = model._run_eval(*model._eval_in(x, y))
            kept = all(torch.equal(b, bufs[k])
                       for k, b in net.named_buffers())
            out[route] = (losses + [float(loss)], logits.clone(), kept,
                          model.captures["eval"])
            del model, net
        e, g = out["eager"], out["graph"]
        err = max_err(torch, g[1], e[1])
        print(f"[phase 17c] ResNet-50 eval_batch fp32, batch 8, batch norm "
              f"in train mode: losses eager {e[0]} graph {g[0]} (captures "
              f"{g[3]}); logits max abs diff {err:.3g}; buffers unchanged "
              f"eager {e[2]} graph {g[2]}")
        check(e[2] and g[2], "17c: eval_batch changed the buffers")
        check(g[3] == 1, f"17c: eval captures {g[3]}")
        check(np.allclose(g[0], e[0], **TOL["float32"])
              and torch.allclose(g[1], e[1], **TOL["float32"]),
              f"17c: graph eval != eager eval ({err:.3g})")
        n, bs, tail = HAPI_TAIL
        model = resnet_model(paddle, 0.01, 1e-4)
        np.random.seed(0)
        t0 = time.perf_counter()
        hist = model.fit(images(paddle, n * bs + tail, 19), batch_size=bs,
                         epochs=2, verbose=0, shuffle=False)
        fit_s = time.perf_counter() - t0
        caps = model.captures["train"]
        print(f"[phase 17c] fit: 2 epochs of {n} batches of {bs} and a tail "
              f"of {tail} in {fit_s:.2f} s, losses "
              + " ".join(f"{h['loss']:.4f}" for h in hist)
              + f"; train captures {caps} (each epoch's first batch and "
              f"its tail: {caps // 2} an epoch)")
        check(caps == 4 and all(np.isfinite(h["loss"]) for h in hist),
              f"17c: fit with a tail captured {caps} times")
        del model


def phase_train_graph(torch, distributed):
    """Phase 17: the captured training steps against the eager ones."""
    import paddle_tpu_torch as paddle

    train_routes_fp32(torch, distributed)
    train_routes_fp32(torch, distributed, dropout=0.1, accum=2)
    train_routes_times(torch, distributed, paddle, card_line())
    hapi_eval_routes(torch, paddle)
    gc.collect()
    torch.cuda.empty_cache()


DEPLOY_LAYERS = 12                 # phase 18 (a): BERT-base widths, eval
DEPLOY_BATCHES = ((32, 512), (8, 128))
DEPLOY_CALIBRATION = 4             # PTQ batches for the int8 predictor
DEPLOY_RESNET = (32, 128)          # phase 18 (d)
# bf16 and int8 predictors against fp32: the JAX tests' bounds
# (tests/test_inference.py: bf16 allclose at 0.05; int8 max error within
# 0.1 of the output's largest magnitude)
TOL_BF16_PREDICTOR = dict(atol=0.05, rtol=0.05)
INT8_MAX_REL = 0.1


def zero_counts(fa):
    for k in fa.launches:
        fa.launches[k] = 0


def device_window(torch, fn, reps=3, kinds=None):
    """``fn`` ``reps`` times under torch.profiler: device ms a call (the
    kernels' time; a replay's kernels included) and the host clock's ms
    a call over the same calls, its denominator.  ``kinds`` (a dict)
    gets the device ms a call by kind: flash, matrix products, the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith(RANGES):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        us += t
        if kinds is not None:
            key = e.key.lower()
            kind = ("flash" if "flash_" in key and "_kernel" in key else
                    "matmul" if is_gemm(key) else "other")
            kinds[kind] = kinds.get(kind, 0.0) + t / reps / 1e3
    check(us > 0, "the profiler saw no device time")
    return us / reps / 1e3, wall


def host_ms(torch, fn, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def route_report(torch, tag, graph_fn, eager_fn, iters, card, fa=None):
    """ms a call on the graph route and eagerly (host clock, ``iters``
    calls after a warm-up each), each route's device ms and busy share
    from one traced window of 3 calls; returns the printed numbers and,
    with ``fa``, the flash forward launches of the graph route's calls
    (``launches``, ``calls``)."""
    if fa is not None:
        zero_counts(fa)
    graph_fn()
    g_ms = host_ms(torch, graph_fn, iters)
    kinds = {}
    busy, wall = device_window(torch, graph_fn, kinds=kinds)
    launches = None if fa is None else fa.launches["fwd"]
    eager_fn()
    e_ms = host_ms(torch, eager_fn, iters)
    e_busy, e_wall = device_window(torch, eager_fn)
    print(f"[phase 18] {tag}: graph {g_ms:.3f} ms a call, eager "
          f"{e_ms:.3f} ({iters} calls each, host clock); device "
          f"{busy:.3f} ms of {wall:.3f} traced (busy share "
          f"{busy / wall:.3f}; eager {e_busy:.3f} of {e_wall:.3f}, "
          f"{e_busy / e_wall:.3f}); graph device ms by kind "
          f"{ {k: round(v, 3) for k, v in sorted(kinds.items())} } "
          f"({card})")
    return {"ms": g_ms, "eager_ms": e_ms, "busy": busy / wall,
            "eager_busy": e_busy / e_wall, "launches": launches,
            "calls": 1 + iters + 3}


def one_build(name, builds, what):
    rep = watchdog().report().get(name, {})
    check(rep.get("compiles") == builds,
          f"{what}: watchdog {name}: {rep} (expected {builds} builds)")
    return f"watchdog {name}: {rep['calls']} calls, {rep['compiles']} builds"


def predictor_routes(torch, paddle, fa, enc, x, path, eager, card):
    """Phase 18 (a), second half: the fp32 (saved program), bf16 and int8
    predictors at ``x``'s signature.  Returns the flash launches over
    their timed replays and the fp32 output."""
    import copy

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.contrib.quant import PTQ

    calib = copy.deepcopy(enc)
    ptq = PTQ()
    ptq.quantize(calib)
    g = torch.Generator(device="cuda").manual_seed(181)
    with torch.no_grad():
        for _ in range(DEPLOY_CALIBRATION):
            calib(torch.randn(8, DEPLOY_BATCHES[0][1], 768, device="cuda",
                              generator=g))
    scales = {k: {"activation": s} for k, s in ptq.scales().items()}
    del calib
    configs = {
        "float32": inference.Config(path),
        "bfloat16": inference.Config(path).set_precision(
            inference.PrecisionType.Bfloat16).set_model(enc),
        "int8": inference.Config(path).set_model(enc).enable_int8(scales)}
    outs, launches = {}, 0
    L = DEPLOY_LAYERS
    for precision, cfg in configs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wd = watchdog()
        wd.reset()
        pred = inference.create_predictor(cfg)
        first = pred.run(x)
        (_, mod, route), = pred._impl._programs.values()
        check(route == "graph", f"18a {precision}: route {route}")
        zero_counts(fa)
        replay = pred.run(x)
        torch.cuda.synchronize()
        check(fa.launches["fwd"] == L,
              f"18a {precision}: a replay launched {fa.launches}")
        with torch.no_grad():
            eager_out = mod(x)
        check(torch.equal(first, replay) and torch.equal(replay, eager_out),
              f"18a {precision}: graph replay != the same route eagerly")
        peak = torch.cuda.max_memory_allocated()
        builds = one_build(f"inference::predictor[{precision}]", 1,
                           f"18a {precision}")

        def eager_call():
            with torch.no_grad():
                mod(x)

        r = route_report(torch, f"(a) {precision} predictor "
                                f"{tuple(x.shape)}",
                         lambda: pred.run(x), eager_call, 10, card, fa)
        check(r["launches"] == L * r["calls"],
              f"18a {precision}: {r['launches']} flash launches over "
              f"{r['calls']} replays")
        launches += r["launches"]
        print(f"[phase 18] (a) {precision}: flash launches "
              f"{r['launches']} = {L} x {r['calls']} replays, peak "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated), graph pool "
              f"{pred.pool_bytes / 2**20:.1f} MiB (one pool shared by the "
              f"predictor's graphs), captures {pred.captures}, {builds}; "
              f"replay = eager run of the same program, bit for bit")
        outs[precision] = replay.float()
        del pred, mod, first, replay, eager_out
    f32 = outs["float32"]
    check(torch.equal(f32, eager), "18a: fp32 predictor != eager forward")
    real = fa.flash_attention
    fa.flash_attention = fa.flash_attention_plain
    try:
        with torch.no_grad():
            plain = enc(x)
    finally:
        fa.flash_attention = real
    err_plain = max_err(torch, f32, plain)
    err_bf16 = max_err(torch, outs["bfloat16"], f32)
    rel_int8 = _maxrel(torch, outs["int8"], f32)
    print(f"[phase 18] (a) fp32 predictor = eager forward to the bit; vs "
          f"flash_attention_plain max abs err {err_plain:.3g} (1e-4); "
          f"bf16 vs fp32 {err_bf16:.3g} (allclose at "
          f"{TOL_BF16_PREDICTOR}); int8 vs fp32 max rel err "
          f"{rel_int8:.4g} ({INT8_MAX_REL})")
    check(torch.allclose(f32, plain, atol=1e-4, rtol=1e-4),
          f"18a: fp32 predictor vs plain attention {err_plain:.3g}")
    check(torch.allclose(outs["bfloat16"], f32, **TOL_BF16_PREDICTOR),
          f"18a: bf16 predictor vs fp32 {err_bf16:.3g}")
    check(0 < rel_int8 < INT8_MAX_REL,
          f"18a: int8 predictor vs fp32 relative {rel_int8:.4g}")
    return launches


def deploy_encoder(torch, paddle, fa, tmp, card):
    """Phase 18 (a): ``nn.TransformerEncoder`` at BERT-base widths through
    ``jit.to_static`` (two signatures), ``jit.save`` from CPU tensors,
    ``jit.load`` on the card and the three predictors.  Returns the
    encoder, its eager outputs, the (32, 512) input and the flash launches
    over the predictors' timed replays."""
    from paddle_tpu_torch import jit

    L = DEPLOY_LAYERS
    paddle.set_device("gpu")
    paddle.seed(0)
    enc = paddle.nn.TransformerEncoder(paddle.nn.TransformerEncoderLayer(
        768, 12, 3072, dropout=0.0, activation="gelu"), L).eval()
    g = torch.Generator(device="cuda").manual_seed(18)
    xs = {sig: torch.randn(*sig, 768, device="cuda", generator=g)
          for sig in DEPLOY_BATCHES}
    with torch.no_grad():
        eager = {sig: enc(x) for sig, x in xs.items()}
    wd = watchdog()
    wd.reset()
    traced = jit.to_static(enc)
    for rep in range(2):
        for sig, x in xs.items():
            zero_counts(fa)
            out = traced(x)
            torch.cuda.synchronize()
            check(torch.equal(out, eager[sig]),
                  f"18a: to_static {sig} call {rep} != eager")
            if rep:
                check(fa.launches["fwd"] == L,
                      f"18a: to_static replay launched {fa.launches}")
    check(traced.captures == 2 and set(traced.routes.values()) == {"graph"},
          f"18a: to_static captures {traced.captures}, {traced.routes}")
    builds = one_build("jit::TransformerEncoder", 2, "18a to_static")
    print(f"[phase 18] (a) to_static at {list(DEPLOY_BATCHES)}: equal to the "
          f"eager forward to the bit, {traced.captures} captures, {builds} "
          f"(no third on repeat calls), graph pool "
          f"{traced.pool_bytes / 2**20:.1f} MiB")
    for sig, x in xs.items():
        def eager_call(x=x):
            with torch.no_grad():
                enc(x)

        route_report(torch, f"(a) to_static {sig}", lambda x=x: traced(x),
                     eager_call, 10 if sig[0] == 32 else 30, card)
    traced.release()
    del traced
    x = xs[DEPLOY_BATCHES[0]]
    path = os.path.join(tmp, "encoder")
    t0 = time.perf_counter()
    jit.save(enc, path, example_inputs=[x.cpu()])
    save_s = time.perf_counter() - t0
    pred = jit.load(path)
    zero_counts(fa)
    outs = [pred(x) for _ in range(3)]
    torch.cuda.synchronize()
    check(all(torch.equal(o, eager[DEPLOY_BATCHES[0]]) for o in outs),
          "18a: the CPU-saved program on the card != eager forward")
    check(fa.launches["fwd"] == 3 * L and pred.captures == 1,
          f"18a: CPU-saved program: launches {fa.launches}, captures "
          f"{pred.captures}")
    print(f"[phase 18] (a) jit.save from CPU tensors ({save_s:.1f} s), "
          f"jit.load on the card: 3 calls equal the eager forward to the "
          f"bit, flash launches {fa.launches['fwd']} = {L} x 3 (1 eager "
          f"warm-up + 2 replays), 1 capture")
    del pred, outs
    launches = predictor_routes(torch, paddle, fa, enc, x, path,
                                eager[DEPLOY_BATCHES[0]], card)
    return enc, eager, xs, launches


def deploy_static(torch, enc, eager, xs):
    """Phase 18 (b): a ``static.Program`` around the encoder, run by the
    ``Executor`` at batch 32 and 8, then with ``AmpBf16Pass``."""
    from paddle_tpu_torch import static

    main = static.Program()
    with static.program_guard(main):
        src = static.data("src", [None, DEPLOY_BATCHES[0][1], 768],
                          "float32")
        out = enc(src)
    exe = static.Executor()
    x32 = xs[DEPLOY_BATCHES[0]]
    x8 = x32[:8]
    with torch.no_grad():
        ref8 = enc(x8).cpu().numpy()
    ref32 = eager[DEPLOY_BATCHES[0]].cpu().numpy()
    for x, ref in ((x32, ref32), (x8, ref8), (x32, ref32), (x8, ref8)):
        (got,) = exe.run(main, feed={"src": x}, fetch_list=[out])
        check(np.array_equal(got, ref), f"18b: Executor at batch "
                                        f"{x.shape[0]} != eager forward")
    check(exe.captures == 2 and exe.last_route == "graph",
          f"18b: {exe.captures} captures, route {exe.last_route}")
    norm = enc.layers[0].norm1.weight
    with torch.no_grad():
        norm.mul_(2.0)
        upd = enc(x8).cpu().numpy()
    (got,) = exe.run(main, feed={"src": x8}, fetch_list=[out])
    with torch.no_grad():
        norm.mul_(0.5)
    check(np.array_equal(got, upd) and not np.array_equal(got, ref8),
          "18b: an in-place weight update was not seen by the replay")
    check(exe.captures == 2, f"18b: the update captured again "
                             f"({exe.captures})")
    captures = exe.captures
    (amp,) = exe.run(main, feed={"src": x32}, fetch_list=[out],
                     use_passes=("dead_code_elimination", "amp_bf16"))
    err = float(np.abs(amp - ref32).max())
    check(np.allclose(amp, ref32, atol=0.1) and err > 0,
          f"18b: AmpBf16Pass vs fp32 max abs err {err:.3g}")
    prog = static.Program()
    with static.program_guard(prog):
        v = static.data("v", [4], "float32")
        y = static.cond(v.sum() > 0.0, lambda: v * 2.0, lambda: v - 1.0)
    (r,) = exe.run(prog, feed={"v": np.ones(4, np.float32)}, fetch_list=[y])
    check(np.array_equal(r, np.full(4, 2.0, np.float32))
          and exe.last_route == "eager", f"18b: cond program {r}, route "
                                         f"{exe.last_route}")
    print(f"[phase 18] (b) Executor over the encoder program ({len(main.ops)}"
          f" ops, src {[None, *x32.shape[1:]]}) at batch {x32.shape[0]} "
          f"and {x8.shape[0]}: equal to the "
          f"eager forward to the bit, an in-place weight update seen, "
          f"{captures} captures (one a feed signature) before the "
          f"AmpBf16Pass entry, {exe.captures} after; AmpBf16Pass vs fp32 "
          f"max abs err {err:.3g} "
          f"(atol 0.1); a program holding cond took the "
          f"'{exe.last_route}' route (read on the host; torch.cond is not "
          f"captured by PyTorch {torch.__version__})")
    exe.close()


def deploy_generation(torch, cfg, pa, serving, gpt_init, card):
    """Phase 18 (c): ``GenerationPredictor`` over phase 4's 1.3B engine
    knobs and prompts, against ``Engine.generate`` on the same params."""
    from paddle_tpu_torch import inference

    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    knobs = dict(page_size=16, num_pages=2048, max_batch_size=8,
                 chunk_len=64)
    _, prompts = serving_prompts(cfg.vocab_size)
    sp = serving.SamplingParams(max_new_tokens=32)
    eng = serving.Engine(cfg, params, device="cuda", **knobs)
    ref = eng.generate(prompts, sp)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    wd = watchdog()
    wd.reset()
    pred = inference.create_predictor(
        inference.Config().enable_generation(cfg, params, **knobs))
    pred.engine.warmup()
    torch.cuda.synchronize()
    pa.ragged_paged_attention.launches = 0
    steps0 = pred.engine.steps
    t0 = time.perf_counter()
    out = pred.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = pred.engine.steps - steps0
    launches = pa.ragged_paged_attention.launches
    check(out == ref, "18c: GenerationPredictor tokens != Engine.generate")
    check(launches == cfg.num_layers * steps,
          f"18c: ragged launches {launches} != {cfg.num_layers} x {steps}")
    captures = check_one_capture(wd, [pred.engine], "18c")
    gen = sum(len(o) for o in out)
    print(f"[phase 18] (c) GenerationPredictor (gpt3-1.3b, phase 4's knobs "
          f"and 8 prompts, 32 greedy tokens each): tokens identical to "
          f"Engine.generate; {gen} tokens in {steps} steps, {wall:.3f} s, "
          f"{gen / wall:.1f} tok/s, ragged launches {launches} = "
          f"{cfg.num_layers} x {steps}, {captures} ({card})")
    del pred, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def deploy_resnet(torch, paddle, card):
    """Phase 18 (d): ResNet-50 at 224² through the bf16 predictor
    (``set_model``, eval), batch 32 and 128."""
    from paddle_tpu_torch import inference

    paddle.set_device("gpu")
    paddle.seed(0)
    net = paddle.vision.resnet50(num_classes=1000).eval()
    pred = inference.create_predictor(inference.Config().set_model(
        net).set_precision(inference.PrecisionType.Bfloat16))
    g = torch.Generator(device="cuda").manual_seed(184)
    for B in DEPLOY_RESNET:
        x = torch.randn(B, 3, 224, 224, device="cuda", generator=g)
        torch.cuda.reset_peak_memory_stats()
        out = pred.run(x)
        check(out.shape == (B, 1000) and bool(torch.isfinite(
            out.float()).all()), f"18d: logits {tuple(out.shape)}")
        (_, mod, _), = [p for k, p in pred._impl._programs.items()
                        if k[0][0][0][0] == B]

        def eager_call():
            with torch.no_grad():
                mod(x)

        r = route_report(torch, f"(d) ResNet-50 bf16 predictor batch {B}",
                         lambda: pred.run(x), eager_call, 10, card)
        print(f"[phase 18] (d) ResNet-50 batch {B}: {B / r['ms'] * 1e3:.1f} "
              f"imgs/s on the graph ({B / r['eager_ms'] * 1e3:.1f} eager), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(pred.captures == 2, f"18d: {pred.captures} captures")
    del pred, net
    gc.collect()
    torch.cuda.empty_cache()


def phase_deploy(torch, fa, pa, serving, gpt_init, cfg):
    """Phase 18: the deployment path at full width."""
    import tempfile

    import paddle_tpu_torch as paddle

    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        enc, eager, xs, launches = deploy_encoder(torch, paddle, fa, tmp,
                                                  card)
    deploy_static(torch, enc, eager, xs)
    del enc, eager, xs
    gc.collect()
    torch.cuda.empty_cache()
    gen = deploy_generation(torch, cfg, pa, serving, gpt_init, card)
    deploy_resnet(torch, paddle, card)
    return launches, gen


# ---------------------------------- fault-tolerant training (19)


FT_FIT = (24, 32)                  # phase 19 (a): batches x batch size
FT_EVERY = 4                       # (a): a checkpoint every 4 steps
FT_KILL_AT = 10                    # (a): the supervised child's kill
FT_ROLLBACK = (8, 32, 5)           # (b): batches, batch size, bad batch
FT_ENGINE_LAYERS = 4               # (d): GPT-3 1.3B widths, 4 layers
FT_ENGINE_BATCH = (8, 2048)
FT_SENTINEL = (25, 100)            # (f): bench.py's fingerprint / replay
SENTINEL_BOUND = 0.03              #      intervals and documented bound
SENTINEL_REPLAYS = 21              #      replays under the median


class FtLosses:
    """A fit callback recording each step's loss by global step
    (``losses``; a replayed step overwrites) and in order (``history``),
    and in the supervised child appending ``step loss`` lines to
    ``log``."""

    def __init__(self, log=None):
        self.model, self.params = None, {}
        self.log, self.losses, self.history, self.gstep = log, {}, [], 0

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        info = getattr(self.model, "_resume_info", None) or {}
        self.gstep = int(info.get("global_step", 0))

    def on_train_batch_end(self, step, logs=None):
        self.gstep += 1
        self.losses[self.gstep] = logs["loss"]
        self.history.append(logs["loss"])
        if self.log:
            with open(self.log, "a") as f:
                f.write(f"{self.gstep} {logs['loss']!r}\n")

    def rewind_to(self, global_step):
        self.gstep = int(global_step)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def ft_state_digest(model):
    """The fit state's per-leaf CRC32 digest: params, buffers, slots."""
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    net = model.network
    return tree_fingerprint({"params": dict(net.named_parameters()),
                             "buffers": dict(net.named_buffers()),
                             "slots": model._opt_state["slots"]})


def ft_fit(torch, paddle, ckdir, log=None, resume=None, settle_at=None):
    """Phase 19 (a)'s run: ResNet-50 from seed 0, bf16 O1, Momentum at lr
    0.01 (0.1 first blows up, 15(b)), ``FT_FIT`` seeded synthetic
    batches, train_batch as a graph, with the async CheckpointCallback,
    GoodputMonitor, HealthMonitor(rollback) and IntegrityCallback.
    ``settle_at``: at that global step wait for the in-flight save (the
    supervised child, before its kill)."""
    from paddle_tpu_torch.hapi import CheckpointCallback, IntegrityCallback
    from paddle_tpu_torch.observability import GoodputMonitor, HealthMonitor

    n, B = FT_FIT
    paddle.set_device("gpu")
    model = resnet_model(paddle, 0.01)
    flops = resnet_flops(torch, model.network, B)
    health = HealthMonitor(action="rollback")
    cbs = {"losses": FtLosses(log),
           "goodput": GoodputMonitor(flops_per_step=flops),
           "integrity": IntegrityCallback(fingerprint_every=FT_EVERY,
                                          replay_every=6, monitor=health),
           "ckpt": CheckpointCallback(ckdir, every_n_steps=FT_EVERY,
                                      keep_last_n=2, async_save=True),
           "health": health}
    if settle_at:
        ckpt = cbs["ckpt"]

        class Settle(paddle.hapi.Callback):
            def on_train_batch_end(self, step, logs=None):
                if ckpt._global_step == settle_at:
                    ckpt.manager.wait()

        cbs["settle"] = Settle()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        model.fit(images(paddle, n * B, 19), batch_size=B, epochs=1,
                  shuffle=False, verbose=0, callbacks=list(cbs.values()),
                  resume_from=resume)
    torch.cuda.synchronize()
    return model, cbs, flops


def child_fit(log):
    """``chip_smoke.py --child fit LOG``: phase 19 (a)'s trainer under
    the supervisor.  Attempt 0 keeps the kill of ``PADDLE_TPU_FAULTS``
    (after waiting for the save of the step before it); a relaunch
    resumes from ``PADDLE_ELASTIC_RESUME_DIR``.  Appends its losses and a
    JSON line of its captures, resume point and final state digest."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import resilience

    attempt = int(os.environ.get(resilience.ENV_ATTEMPT, "0"))
    if attempt:
        resilience.uninstall()          # the kill is attempt 0's alone
    prepare(torch)
    resume = os.environ[resilience.ENV_RESUME_DIR]
    model, cbs, _ = ft_fit(torch, paddle, resume, log=log, resume=resume,
                           settle_at=FT_KILL_AT - FT_KILL_AT % FT_EVERY
                           if attempt == 0 else None)
    with open(log, "a") as f:
        f.write(json.dumps({
            "attempt": attempt, "captures": model.captures["train"],
            "resume": model._resume_info and
            model._resume_info.get("global_step"),
            "integrity_events": len(cbs["integrity"].events),
            "digest": ft_state_digest(model)}) + "\n")
    return 0


def ft_supervised(torch, ref, tmp):
    """Phase 19 (a), the second half: the same run in a child process
    under ``TrainingSupervisor``, killed at global step ``FT_KILL_AT`` by
    ``PADDLE_TPU_FAULTS``; the relaunch resumes and finishes.  Held bit
    for bit to the uninterrupted run ``ref``."""
    from paddle_tpu_torch.resilience import TrainingSupervisor

    log = os.path.join(tmp, "losses.log")
    env = dict(os.environ,
               PADDLE_TPU_FAULTS=f"hapi.train_step:kill:{FT_KILL_AT}")
    sup = TrainingSupervisor(
        [sys.executable, os.path.abspath(__file__), "--child", "fit", log],
        checkpoint_dir=os.path.join(tmp, "ck_sup"), max_restarts=2,
        backoff_base=0.05, backoff_cap=0.1, env=env,
        log_path=os.path.join(tmp, "child.log"))
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    if rc:
        print(open(os.path.join(tmp, "child.log")).read()[-4000:])
    check(rc == 0, f"19a: the supervised run exited {rc}")
    losses, attempts = {}, []
    with open(log) as f:
        for line in f:
            if line.startswith("{"):
                attempts.append(json.loads(line))
                continue
            step, loss = line.split(" ", 1)
            losses.setdefault(int(step), []).append(float(loss))
    n = FT_FIT[0]
    check(sup.restarts == [("crash", 1)], f"19a: restarts {sup.restarts}")
    check([a["attempt"] for a in attempts] == [1],
          f"19a: attempts that finished {attempts}")
    final = attempts[0]
    resumed = final["resume"]
    check(resumed == FT_KILL_AT - FT_KILL_AT % FT_EVERY,
          f"19a: resumed from step {resumed}")
    check(sorted(losses) == list(range(1, n + 1)),
          f"19a: steps logged {sorted(losses)}")
    again = [s for s, v in losses.items() if len(v) > 1]
    same = all(v == [ref["losses"][s]] * len(v) for s, v in losses.items())
    check(same, "19a: the supervised losses differ from the uninterrupted "
                "run's: " + ", ".join(
                    f"{s}: {v} vs {ref['losses'][s]}"
                    for s, v in sorted(losses.items())
                    if v != [ref['losses'][s]] * len(v))[:600])
    differ = [k for k in ref["digest"]
              if ref["digest"][k] != final["digest"].get(k)]
    check(not differ, f"19a: final state differs at {differ[:4]}")
    check(final["captures"] == 1 and final["integrity_events"] == 0,
          f"19a: the relaunch captured {final['captures']} graphs, "
          f"{final['integrity_events']} integrity events")
    print(f"[phase 19a] supervised: killed at global step {FT_KILL_AT} "
          f"(PADDLE_TPU_FAULTS), {len(sup.restarts)} restart, the relaunch "
          f"resumed from step {resumed} and retrained steps {again}; "
          f"{n} losses and the final {len(ref['digest'])} leaves (params, "
          f"buffers, Momentum slots) bitwise equal to the uninterrupted "
          f"run; the relaunch captured train_batch once; supervised wall "
          f"{wall:.1f} s (two processes, each with its start, build check "
          f"and capture)")


def ft_uninterrupted(torch, paddle, tmp):
    """Phase 19 (a), the first half (in this process), and (e)."""
    watchdog().reset()
    t0 = time.perf_counter()
    model, cbs, flops = ft_fit(torch, paddle, os.path.join(tmp, "ck_ref"))
    wall = time.perf_counter() - t0
    integ = cbs["integrity"]
    captured = check_captured_once(model, "hapi::train_step", "19a")
    n = FT_FIT[0]
    check(len(cbs["losses"].losses) == n and all(
        np.isfinite(list(cbs["losses"].losses.values()))),
        "19a: losses missing or not finite")
    check(integ.events == [] and integ.checks == {
        "fingerprint": n // FT_EVERY, "replay": n // 6},
        f"19a: integrity {integ.events[:2]}, checks {integ.checks}")
    check(cbs["health"].rollbacks == 0, "19a: a rollback in a healthy run")
    losses = cbs["losses"].losses
    print(f"[phase 19a] hapi ResNet-50 bf16 O1, batch {FT_FIT[1]}, {n} "
          f"steps with CheckpointCallback(every {FT_EVERY}, async), "
          f"GoodputMonitor, HealthMonitor(rollback), IntegrityCallback("
          f"fingerprint every {FT_EVERY}, replay every 6): {wall:.1f} s; "
          f"{integ.checks['replay']} replays and "
          f"{integ.checks['fingerprint']} fingerprints, 0 divergences; "
          f"{captured}; losses {losses[1]:.4f} .. {losses[n]:.4f}")
    rep = cbs["goodput"].report()
    shares = {k: v / rep["total_seconds"]
              for k, v in rep["phases_seconds"].items()}
    print(f"[phase 19e] goodput of (a): " + ", ".join(
        f"{k} {shares[k]:.4f}" for k in ("compute", "data_wait", "compile",
                                         "checkpoint", "eval"))
          + f" of {rep['total_seconds']:.2f} s over {rep['steps']} steps; "
          f"MFU {rep['mfu']:.4f} of the last step ({flops / 1e12:.3f} "
          f"TFLOP a step against {rep['peak_flops'] / 1e12:.0f} TFLOP/s, "
          f"the table's entry for {rep['device']!r}); {card_line()}")
    check(rep["peak_flops"] == BF16_FLOPS and rep["mfu"] > 0,
          f"19e: peak {rep['peak_flops']} mfu {rep['mfu']}")
    ref = {"losses": dict(losses), "digest": ft_state_digest(model)}
    del model, cbs
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def ft_rollback(torch, paddle, tmp):
    """Phase 19 (b): a NaN batch under HealthMonitor(rollback): one
    rollback, the skipped window in the manifest, and the losses past it
    bitwise those of a run that never saw the batch."""
    from paddle_tpu_torch.hapi import CheckpointCallback
    from paddle_tpu_torch.observability import HealthMonitor
    from paddle_tpu_torch.resilience import CheckpointManager

    n, B, bad = FT_ROLLBACK
    data = images(paddle, n * B, 23)
    clean = images(paddle, n * B, 23)
    keep = np.ones(n * B, bool)
    keep[bad * B:(bad + 1) * B] = False
    clean.x, clean.y = clean.x[keep], clean.y[keep]
    data.x[bad * B:(bad + 1) * B] = np.nan
    runs = {}
    for name, ds in (("clean", clean), ("poisoned", data)):
        paddle.set_device("gpu")
        model = resnet_model(paddle, 0.01)
        rec = FtLosses()
        mon = HealthMonitor(action="gauge" if name == "clean"
                            else "rollback")
        ckdir = os.path.join(tmp, f"ck_{name}")
        cbs = [rec, mon, CheckpointCallback(ckdir, every_n_steps=1,
                                            keep_last_n=2, async_save=True)]
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(dtype="bfloat16"):
            model.fit(ds, batch_size=B, epochs=1, shuffle=False, verbose=0,
                      callbacks=cbs)
        torch.cuda.synchronize()
        runs[name] = (rec.history, mon.rollbacks,
                      time.perf_counter() - t0, ckdir)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    ref, _, _, _ = runs["clean"]
    got, rollbacks, wall, ckdir = runs["poisoned"]
    _, _, manifest = CheckpointManager(ckdir, sweep_orphans=False).restore()
    windows = manifest["extra"].get("skipped_windows", [])
    print(f"[phase 19b] ResNet-50 bf16 O1, batch {B}, {n} batches with "
          f"batch {bad} NaN, HealthMonitor(rollback), a checkpoint every "
          f"step (async): {rollbacks} rollback, skipped windows "
          f"{windows}; loss at the bad step {got[bad]}; losses past it "
          + " ".join(f"{x:.6f}" for x in got[bad + 1:]) + " vs the run "
          f"without the batch " + " ".join(f"{x:.6f}" for x in ref[bad:])
          + f" ({wall:.1f} s)")
    check(rollbacks == 1 and len(windows) == 1
          and (windows[0]["first_step"], windows[0]["last_step"])
          == (bad, bad), f"19b: rollbacks {rollbacks}, {windows}")
    check(not np.isfinite(got[bad]) and got[:bad] == ref[:bad]
          and got[bad + 1:] == ref[bad:],
          "19b: the losses around the window differ from the clean run's")


def ft_ranks(torch, paddle, tmp, monitored, store):
    """Phase 19 (c): ``TestCrossRankDivergence``'s protocol on the card:
    two sequential ranks of the toy model over one TCPStore, rank 1 with
    a bitflip of ``0.weight`` (bit 17) at its 5th ``hapi.step_params``,
    fingerprints every 2 steps.  Returns each rank's callback, losses and
    final parameters."""
    from paddle_tpu_torch.hapi import CheckpointCallback, IntegrityCallback
    from paddle_tpu_torch.observability import (HealthMonitor,
                                                MetricsRegistry, Tracer)
    from paddle_tpu_torch.resilience import FaultSpec, injected_faults

    rng = np.random.RandomState(7)
    y = rng.randint(0, 2, (32,)).astype(np.int64)
    x = (rng.randn(32, 4) * 0.3 + y[:, None] * 2.0).astype(np.float32)

    class Arrays(paddle.io.Dataset):
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return x[i], y[i]

    out = {}
    for rank in range(2):
        reg = MetricsRegistry()
        mon = HealthMonitor(action="rollback", registry=reg,
                            tracer=Tracer()) if monitored else None
        cb = IntegrityCallback(store=store, rank=rank, world_size=2,
                               fingerprint_every=2, history=1000,
                               monitor=mon, registry=reg, tracer=Tracer(),
                               key_prefix=f"integrity{int(monitored)}")
        paddle.set_device("gpu")
        paddle.seed(11)
        model = paddle.Model(paddle.nn.Sequential(
            paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
            paddle.nn.Linear(8, 2)))
        model.prepare(paddle.optimizer.Momentum(
            learning_rate=0.1, parameters=model.parameters()),
            paddle.nn.CrossEntropyLoss())
        rec = FtLosses()
        cbs = [rec, cb, CheckpointCallback(
            os.path.join(tmp, f"int{int(monitored)}_{rank}"),
            every_n_steps=1)] + ([mon] if mon else [])
        with (injected_faults(FaultSpec(
                "hapi.step_params", "bitflip", occurrence=5,
                leaf="0.weight", bit=17)) if rank == 1
              else contextlib.nullcontext()):
            model.fit(Arrays(), batch_size=4, epochs=1, shuffle=False,
                      verbose=0, callbacks=cbs)
        out[rank] = (cb, rec.history,
                     {k: p.detach().clone()
                      for k, p in model.network.named_parameters()},
                     model.captures["train"])
    return out


def ft_integrity(torch, paddle, tmp):
    from paddle_tpu_torch.distributed.store import TCPStore

    store = TCPStore(is_master=True, world_size=1)
    det = ft_ranks(torch, paddle, tmp, False, store)
    ev = det[1][0].events[0] if det[1][0].events else {}
    print(f"[phase 19c] TestCrossRankDivergence's protocol on the card, "
          f"detect only: rank 0 events {det[0][0].events}; rank 1 "
          f"{ev.get('kind')} at global step {ev.get('global_step')}, "
          f"divergent ranks {ev.get('divergent_ranks')}, first divergent "
          f"leaf {ev.get('first_divergent_leaf')} (the JAX package's on "
          f"this protocol: {{1: 'params/0.bias'}})")
    check(det[0][0].events == [] and ev.get("divergent_ranks") == [1]
          and ev.get("global_step") == 6
          and ev.get("first_divergent_leaf") == {1: "params/0.bias"},
          f"19c: detection {ev}")
    rep = ft_ranks(torch, paddle, tmp, True, store)
    cb1, l1, p1, cap1 = rep[1]
    _, l0, p0, cap0 = rep[0]
    same = all(torch.equal(p0[k], p1[k]) for k in p0)
    print(f"[phase 19c] with HealthMonitor(rollback): rank 1 repaired "
          f"({len(l1)} steps: steps 5 and 6 replayed after the rewind to "
          f"step 4), divergence active {cb1.divergence_active}, its final "
          f"parameters bitwise equal to rank 0's: {same}; replayed tail "
          f"equal {l1[6:] == l0[4:]}; train_batch captures {cap0} / {cap1}")
    check(same and l1[6:] == l0[4:] and len(l1) == 10
          and not cb1.divergence_active and cap0 == 1 and cap1 == 1,
          "19c: the repair did not reconverge bitwise")


def ft_engine(torch, distributed, tmp):
    """Phase 19 (d): HybridEngine at the 1.3B widths on
    ``FT_ENGINE_LAYERS`` layers, phase 7's EngineConfig, bf16 with the
    fp32 master and Adam slots: 6 steps uninterrupted; 3, an async save,
    a new engine, 3 more; and an in-place rewind of the live engine to
    step 3, 3 more.  Losses and state bitwise; one capture each."""
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.observability import default_registry
    from paddle_tpu_torch.resilience import CheckpointManager

    cfg = dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"],
                              num_layers=FT_ENGINE_LAYERS)
    B, S = FT_ENGINE_BATCH
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], 1)

    def engine():
        gc.collect()
        torch.cuda.empty_cache()
        return distributed.HybridEngine(
            cfg, device="cuda",
            engine_cfg=distributed.EngineConfig(accum_steps=1))

    def steps(eng, params, opt, n):
        out, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = eng.step(params, opt, tokens, labels)
            out.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        return params, opt, out, ms

    def state(eng, params, opt):
        return {k: t.detach().clone() for k, t in ck.tree_items(
            ck.engine_tree(eng, params, opt))}

    def same(a, b):
        return [k for k in a if not torch.equal(
            a[k].view(torch.uint8) if a[k].dtype == torch.bfloat16
            else a[k], b[k].view(torch.uint8)
            if b[k].dtype == torch.bfloat16 else b[k])]

    eng = engine()
    params, opt = eng.init(seed=0)
    n_params = sum(t.numel() for _, t in ck.tree_items(params))
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      ck.tree_items(ck.engine_tree(eng, params, opt)))
    _, _, ref, _ = steps(eng, params, opt, 6)
    ref_state = state(eng, params, opt)
    del eng, params, opt

    # three steps, an async save, three more on a new engine
    watchdog().reset()
    eng = engine()
    params, opt = eng.init(seed=0)
    params, opt, l03, ms_before = steps(eng, params, opt, 3)
    sync_dir = os.path.join(tmp, "eng_sync")
    t0 = time.perf_counter()
    CheckpointManager(sync_dir).save(ck.engine_tree(eng, params, opt),
                                     step=3, extra={"kind": "hybrid_engine"})
    sync_s = time.perf_counter() - t0
    shutil.rmtree(sync_dir, ignore_errors=True)
    mgr = CheckpointManager(os.path.join(tmp, "eng"), async_save=True)
    hist = default_registry().histogram(
        "checkpoint_save_seconds", labelnames=("mode",))
    bg_before = hist.labels(mode="background").sum
    t0 = time.perf_counter()
    path = mgr.save(ck.engine_tree(eng, params, opt), step=3,
                    extra={"kind": "hybrid_engine"})
    stall_s = time.perf_counter() - t0
    params, opt, l_after, ms_after = steps(eng, params, opt, 1)
    mgr.wait()
    bg_s = hist.labels(mode="background").sum - bg_before
    # a second async save, into the pinned buffers the first allocated
    t0 = time.perf_counter()
    mgr.save(ck.engine_tree(eng, params, opt), step=4,
             extra={"kind": "hybrid_engine"})
    stall2_s = time.perf_counter() - t0
    mgr.wait()
    eng_a, params_a, opt_a = eng, params, opt
    eng = engine()
    t0 = time.perf_counter()
    params, opt = ck.load_engine_state(path, eng)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(opt["step"] == 3, f"19d: restored step {opt['step']}")
    for k in fa.launches:
        fa.launches[k] = 0
    params, opt, l36, _ = steps(eng, params, opt, 3)
    launches = dict(fa.launches)
    new_state = state(eng, params, opt)
    diff = same(ref_state, new_state)
    print(f"[phase 19d] HybridEngine gpt3-1.3b widths x{FT_ENGINE_LAYERS} "
          f"layers, bf16 with fp32 master and Adam, batch {B} x {S}, remat "
          f"dots: {n_params / 1e6:.1f} M parameters, {state_bytes / 1e9:.3f} "
          f"GB of state; losses uninterrupted " + " ".join(
              f"{x:.6f}" for x in ref) + "; 3 + save + new engine + 3 "
          + " ".join(f"{x:.6f}" for x in l03 + l36)
          + f"; state leaves differing {len(diff)}; flash launches in the 3 "
          f"resumed steps {launches}")
    check(l03 + l36 == ref and l_after == ref[3:4] and not diff,
          f"19d: the resumed engine differs (losses {l03 + l36} vs {ref}, "
          f"{diff[:4]})")
    check(launches["fwd"] == 3 * 2 * FT_ENGINE_LAYERS
          and launches["bwd"] == 3 * FT_ENGINE_LAYERS,
          f"19d: flash launches {launches}")
    del eng, params, opt
    # the live engine (a) rewound in place to step 3, three steps again
    eng, params, opt = eng_a, params_a, opt_a
    builds = watchdog().report()["hybrid_engine::step"]["compiles"]
    t0 = time.perf_counter()
    ck.load_engine_state(path, eng, into=(params, opt))
    torch.cuda.synchronize()
    inplace_s = time.perf_counter() - t0
    params, opt, l_re, _ = steps(eng, params, opt, 3)
    diff = same(ref_state, state(eng, params, opt))
    builds_after = watchdog().report()["hybrid_engine::step"]["compiles"]
    print(f"[phase 19d] in-place rewind of the live engine to step 3 and 3 "
          f"steps: losses " + " ".join(f"{x:.6f}" for x in l_re)
          + f", state leaves differing {len(diff)}, captures "
          f"{eng.captures}, watchdog builds {builds} -> {builds_after}")
    check(l_re == ref[3:] and not diff and eng.captures == 1
          and builds_after == builds,
          f"19d: the in-place rewind differs ({l_re} vs {ref[3:]}, "
          f"{diff[:4]}, captures {eng.captures})")
    gb = state_bytes / 1e9
    print(f"[phase 19d] checkpoint of {state_bytes} bytes ({gb:.3f} GB): "
          f"sync save {sync_s:.3f} s; async save's training-thread stall "
          f"{stall_s:.3f} s the first time (the pinned buffers allocated; "
          f"{gb / stall_s:.2f} GB/s), {stall2_s:.3f} s the second (the "
          f"device->host copy into them, {gb / stall2_s:.2f} GB/s); the "
          f"first one's background write "
          f"{bg_s:.3f} s; restore into a new engine {restore_s:.3f} s, in "
          f"place {inplace_s:.3f} s; step ms before the save "
          + " ".join(f"{x:.1f}" for x in ms_before) + ", the step after "
          f"it (the write in flight) {ms_after[0]:.1f}; {card_line()}")
    del eng, params, opt, eng_a, params_a, opt_a, ref_state, new_state
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd": launches["fwd"], "bwd": launches["bwd"]}


def crc_digests_equal_zlib(torch):
    """Phase 19 (f), first: the device digests of leaves of every kind
    the sentinel meets (fp32, bf16 under the '<V2' header, int64, a 0-d
    leaf, an empty one, odd byte counts, a non-contiguous view, a leaf
    of several 256 KiB blocks) equal ``zlib``'s of the same bytes and the
    plain version's, leaf for leaf, from one launch."""
    import zlib

    from paddle_tpu_torch.kernels import crc32
    from paddle_tpu_torch.resilience import integrity

    g = torch.Generator(device="cuda").manual_seed(19)
    leaves = [torch.randn(1024, 1024, generator=g, device="cuda"),
              torch.randn(513, 77, generator=g, device="cuda").bfloat16(),
              torch.randint(0, 1 << 40, (12345,), generator=g,
                            device="cuda"),
              torch.tensor(3.5, device="cuda"),
              torch.tensor(7, device="cuda"),
              torch.zeros(0, 4, device="cuda"),
              torch.randint(0, 255, (1 << 20 | 7,), dtype=torch.uint8,
                            generator=g, device="cuda"),
              torch.randn(30, 50, generator=g, device="cuda")[:, 3:41]]
    heads = [integrity._header_crc(t) for t in leaves]
    before = crc32.crc32_leaves.launches
    got = crc32.crc32_leaves(leaves, heads)
    check(crc32.crc32_leaves.launches == before + 1,
          "19f: the digests took more than one launch")
    host = [t.cpu() for t in leaves]
    want = [integrity._leaf_crc(t) for t in host]
    plain = crc32.crc32_leaves(host, heads)
    bad = [i for i, (a, b, c) in enumerate(zip(got, want, plain))
           if not a == b == c]
    check(not bad, f"19f: device digests differ from zlib at leaves {bad}")
    # zlib over the raw bytes, header first, as the JAX package digests
    b16 = host[1].view(torch.int16).numpy()
    check(got[1] == zlib.crc32(b16.tobytes(), zlib.crc32(
        f"<V2:{b16.shape}".encode())), "19f: bf16 digest")
    print(f"[phase 19f] crc32 kernel: {len(leaves)} leaves (fp32, bf16, "
          f"int64, 0-d fp32 and int64, empty, 1 MiB + 7 bytes, a strided "
          f"view) in one launch, every digest equal to zlib's and the plain "
          f"version's")
    return 0


def crc_row(torch, leaves):
    """The crc32 kernel's numbers at a leaf set: the kernel alone (both
    passes, replayed from a CUDA graph, so the host's launch cost is not
    timed), the whole ``crc32_leaves`` call (CUDA events around calls
    that each end in their read back), the plain version (host copy +
    numpy), the bound from the bytes read."""
    from paddle_tpu_torch.kernels import crc32
    from paddle_tpu_torch.resilience import integrity

    heads = [integrity._header_crc(t) for t in leaves]
    launch, keep = crc32._prepare(leaves, heads)
    n0 = crc32.crc32_leaves.launches
    ms = graph_ms(torch, launch)          # the device's time, no host's
    call_ms = time_ms(torch, lambda: crc32.crc32_leaves(leaves, heads), 20)
    crc32.crc32_leaves.launches = n0      # timing launches do not count
    t0 = time.perf_counter()
    crc32.crc32_leaves([t.detach().cpu() for t in leaves], heads)
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    del keep
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "bytes": nbytes, "leaves": len(leaves)}


def ft_sentinel(torch, paddle):
    """Phase 19 (f): the sentinel's cost against its documented 3 %
    bound, by bench.py's ``bench_integrity`` protocol (a fingerprint
    every N = 25 steps and a replay every M = 100, amortized over the
    median step): the MLP at hidden 1024, batch 128 — checked against
    ``SENTINEL_BOUND`` — and ResNet-50 at batch 32 (bf16 O1), printed.
    The fingerprint is the device CRC32 (one launch and one sync a tree).
    Returns the crc32 kernel's row, timed at the MLP's parameters."""
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    crc_digests_equal_zlib(torch)

    def measure(model, x, y, amp):
        ctx = (lambda: paddle.amp.auto_cast(dtype="bfloat16")) if amp \
            else contextlib.nullcontext

        def step():
            with ctx():
                return model.train_batch(x, y)

        # medians of many calls: each is host-bound and well under a
        # millisecond on the MLP, so one scheduler hiccup in a short run
        # of calls can move a median of few
        for _ in range(3):
            step()
        ts = []
        for _ in range(40):
            t0 = time.perf_counter()
            step()
            ts.append(time.perf_counter() - t0)
        step_s = float(np.median(ts))
        tree = {"params": dict(model.network.named_parameters())}
        tree_fingerprint(tree)
        fp = []
        for _ in range(25):
            t0 = time.perf_counter()
            tree_fingerprint(tree)
            fp.append(time.perf_counter() - t0)
        snap = model.train_state_snapshot()
        rp = []
        # a warm replay, then the median of SENTINEL_REPLAYS: single
        # replays of a CUDA graph stall for 4-10 ms on a shared host, in
        # plain PyTorch too (chip_probe.py witness), and a median of few
        # cannot outvote two of them
        for _ in range(SENTINEL_REPLAYS + 1):
            t0 = time.perf_counter()
            with ctx():
                model.replay_train_batch(snap, (x, y))
            rp.append(time.perf_counter() - t0)
        fp_s, rp_s = float(np.median(fp)), float(np.median(rp[1:]))
        n, m = FT_SENTINEL
        return step_s, fp_s, rp_s, (fp_s / n + rp_s / m) / step_s, rp[1:]

    paddle.set_device("gpu")
    paddle.seed(0)
    h = 1024
    nn = paddle.nn
    mlp = paddle.Model(nn.Sequential(nn.Linear(h, h), nn.ReLU(),
                                     nn.Linear(h, h), nn.ReLU(),
                                     nn.Linear(h, 10)))
    mlp.prepare(paddle.optimizer.Momentum(
        learning_rate=0.01, parameters=mlp.parameters()),
        nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    x = rng.randn(128, h).astype(np.float32)
    y = rng.randint(0, 10, (128,)).astype(np.int64)
    mlp_name = "MLP hidden 1024, batch 128, fp32"
    res = {mlp_name: measure(mlp, x, y, False)}
    row = crc_row(torch, list(mlp.network.parameters()))
    del mlp
    model = resnet_model(paddle, 0.01)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        32, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.RandomState(1).randint(
        0, 1000, (32,))).cuda()
    n_bytes = sum(p.numel() * 4 for p in model.parameters())
    res[f"ResNet-50, batch 32, bf16 O1 ({n_bytes / 1e6:.1f} MB of fp32 "
        f"parameters)"] = measure(model, x, y, True)
    row["resnet50"] = crc_row(torch, list(model.network.parameters()))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name, (step_s, fp_s, rp_s, ratio, rps) in res.items():
        checked = name == mlp_name
        print(f"[phase 19f] {name}: every replay's ms: " + ", ".join(
            f"{t * 1e3:.3f}" for t in rps))
        print(f"[phase 19f] sentinel on {name}: step {step_s * 1e3:.3f} ms, "
              f"fingerprint {fp_s * 1e3:.3f} ms, replay {rp_s * 1e3:.3f} "
              f"ms (median of {len(rps)}); amortized over N = "
              f"{FT_SENTINEL[0]}, M = "
              f"{FT_SENTINEL[1]}: {ratio:.4f} of step time against the "
              f"documented bound {SENTINEL_BOUND} "
              f"({'checked' if checked else 'printed'})")
        if checked:
            check(ratio < SENTINEL_BOUND,
                  f"19f: the sentinel costs {ratio:.4f} of the MLP's step")
    for tag, r in (("MLP", row), ("ResNet-50", row["resnet50"])):
        print(f"[phase 19f] crc32 kernel on the {tag}'s parameters "
              f"({r['leaves']} leaves, {r['bytes'] / 1e6:.1f} MB): "
              f"{r['ms']:.4f} ms on the device (bound {r['bound_ms']:.4f} "
              f"ms from bytes), {r['call_ms']:.4f} ms the whole call, plain "
              f"version {r['plain_ms']:.2f} ms")
    return row


def ft_kernels(torch, fa, ra):
    """Phase 19 (g): dQ of the bf16 backward 20 times at each phase 5
    shape (causal D = 128 and 256, non-causal [32, 12, 512, 64]) and a
    ring pair at phase 8's per-rank shape, full and diagonal: every
    repeat bitwise equal to the first, the first at the plain version's
    tolerance.  Returns the whole call's ms by case."""
    out = {}
    for B, H, S, D, causal in ((8, 16, 2048, 128, True),
                               (8, 16, 2048, 256, True),
                               (32, 12, 512, 64, False)):
        g = torch.Generator(device="cuda").manual_seed(190 + D)
        q, k, v, do = (torch.randn((B, H, S, D), generator=g,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        scale = 1.0 / np.sqrt(D)
        ref, lse = fa._flash_fwd_ref(q, k, v, scale, causal)
        delta = fa._delta(ref, do)
        first = fa._bwd_sm90(q, k, v, do, lse, delta, scale, causal)
        rq = fa._bwd_dq_ref(q, k, v, do, lse, delta, scale, causal)
        err = max_err(torch, first[0], rq)
        check(torch.allclose(first[0].float(), rq.float(),
                             **TOL_FLASH["bfloat16"]),
              f"19g: dq != plain at {[B, H, S, D]}: {err:.3g}")
        del ref, rq
        reps = sum(all(torch.equal(a, b) for a, b in zip(first, fa._bwd_sm90(
            q, k, v, do, lse, delta, scale, causal))) for _ in range(20))
        ms = time_ms(torch, lambda: fa._bwd_sm90(q, k, v, do, lse, delta,
                                                 scale, causal), 10)
        tag = f"{[B, H, S, D]} {'causal' if causal else 'non-causal'}"
        out[tag] = ms
        print(f"[phase 19g] flash backward at {tag}: dq, dk, dv bitwise "
              f"equal over {reps}/20 repeats; dq max abs err {err:.3g} vs "
              f"plain; whole call {ms:.4f} ms")
        check(reps == 20, f"19g: {20 - reps} repeats differ at {tag}")
        del q, k, v, do, lse, delta, first
        torch.cuda.empty_cache()
    for causal in (False, True):
        c = ring_pair_case(torch, fa, 8, 16, 512, 128, torch.bfloat16,
                           seed=5)
        first, _, call = ring_pair_run(torch, ra, c, causal)
        first = [t.clone() for t in first]
        reps = 0
        for _ in range(20):
            got, _, _ = ring_pair_run(torch, ra, c, causal)
            reps += all(torch.equal(a, b) for a, b in zip(first, got))
        k, v = c["pairs"][causal]
        want = [s + d for s, d in zip(c["start"], ra._pair_bwd_ref(
            c["q"], k, v, c["do"], c["lse"], c["delta"], c["scale"],
            causal))]
        err = max(max_err(torch, a, b) for a, b in zip(first, want))
        ok = all(torch.allclose(a, b, **TOL_FLASH["bfloat16"])
                 for a, b in zip(first, want))
        ms = time_ms(torch, call, 10)
        tag = f"ring pair [8, 16, 512, 128] {'diagonal' if causal else 'full'}"
        out[tag] = ms
        print(f"[phase 19g] {tag}: sums bitwise equal over {reps}/20 "
              f"repeats; max abs err {err:.3g} vs start + plain; {ms:.4f} ms "
              f"a pair")
        check(reps == 20 and ok, f"19g: {tag}: {reps}/20, err {err:.3g}")
        del c
        torch.cuda.empty_cache()
    return out


def ft_nondeterministic_ops(torch, paddle, distributed):
    """One eager step of each training path of phase 19 (hapi ResNet-50
    bf16 O1 at batch 32, ``HybridEngine`` at the 1.3B widths on 4
    layers) under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the ops torch names as nondeterministic.  Printed;
    the replays and resumes of phase 19 decide."""
    import warnings

    from paddle_tpu_torch.models import GPT_CONFIGS

    named = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            paddle.set_device("gpu")
            model = resnet_model(paddle, 0.01)
            x = torch.from_numpy(np.random.RandomState(0).rand(
                32, 3, 224, 224).astype(np.float32)).cuda()
            y = torch.from_numpy(np.random.RandomState(1).randint(
                0, 1000, (32,))).cuda()
            with eager_route(torch, model), \
                    paddle.amp.auto_cast(dtype="bfloat16"):
                model.train_batch(x, y)
            torch.cuda.synchronize()
            named["hapi ResNet-50"] = sorted(
                {str(w.message).split("\n")[0][:160] for w in caught})
            del model
            caught.clear()
            cfg = dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"],
                                      num_layers=FT_ENGINE_LAYERS)
            eng = distributed.HybridEngine(cfg, device="cuda")
            params, opt = eng.init(seed=0)
            tokens = np.random.default_rng(19).integers(
                0, cfg.vocab_size, FT_ENGINE_BATCH).astype(np.int64)
            with eager_route(torch, eng):
                eng.step(params, opt, tokens, tokens)
            torch.cuda.synchronize()
            named["HybridEngine"] = sorted(
                {str(w.message).split("\n")[0][:160] for w in caught})
            del eng, params, opt
    finally:
        torch.use_deterministic_algorithms(False)
        gc.collect()
        torch.cuda.empty_cache()
    for path, ops in named.items():
        print(f"[phase 19] one eager step of {path} under "
              f"use_deterministic_algorithms(warn_only): torch names "
              f"{len(ops)} op(s){': ' + '; '.join(ops) if ops else ''}")


def phase_fault_tolerance(torch, fa, ra, distributed):
    """Phase 19: fault-tolerant training on the card."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import crc32

    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        ft_nondeterministic_ops(torch, paddle, distributed)
        t0 = time.perf_counter()
        crc32.crc32_leaves.launches = 0
        ref = ft_uninterrupted(torch, paddle, tmp)
        crc_launches = crc32.crc32_leaves.launches
        print(f"[phase 19a] crc32 launches in the uninterrupted fit: "
              f"{crc_launches} (one a fingerprint or state digest)")
        check(crc_launches > 0, "19a: the fingerprints did not run the "
                                "crc32 kernel")
        ft_supervised(torch, ref, tmp)
        print(f"[phase 19a] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ft_rollback(torch, paddle, tmp)
        ft_integrity(torch, paddle, tmp)
        print(f"[phase 19b-c] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = ft_engine(torch, distributed, tmp)
        print(f"[phase 19d] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        crc = ft_sentinel(torch, paddle)
        crc["launches"] = crc_launches
        kernels = ft_kernels(torch, fa, ra)
        print(f"[phase 19f-g] {time.perf_counter() - t0:.1f} s; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, kernels, crc


# ------------------------------ the op corpus and a Paddle program (20)


# the port on the card against the port on the CPU, both fp32 with TF32
# off: CUDA's math library and cuBLAS/cuDNN/cuSOLVER sum and round in
# other orders than the CPU's (the CPU tests hold the port to JAX at
# 1e-5, linear algebra at 1e-4)
CARD_TOL = dict(atol=1e-4, rtol=1e-4)
CARD_TOL_LINALG = dict(atol=1e-3, rtol=1e-3)
PROGRAM_LAYERS, PROGRAM_BATCH = 2, 2     # GPT-3 1.3B widths, depth cut


def card_decompositions(torch, ops):
    """qr, svd, eigh on the card: reconstruction and orthogonality."""
    g = torch.Generator(device="cuda").manual_seed(20)
    a = torch.randn(6, 4, generator=g, device="cuda")
    spd = a.T @ a + 4 * torch.eye(4, device="cuda")
    q, r = ops.qr(a)
    u, sv, vh = ops.svd(a)
    w, v = ops.eigh(spd)
    eye = torch.eye(4, device="cuda")
    ok = (torch.allclose(q @ r, a, **CARD_TOL_LINALG)
          and torch.allclose(q.T @ q, eye, **CARD_TOL_LINALG)
          and torch.allclose((u * sv) @ vh, a, **CARD_TOL_LINALG)
          and torch.allclose(u.T @ u, eye, **CARD_TOL_LINALG)
          and torch.allclose((v * w) @ v.T, spd, **CARD_TOL_LINALG)
          and torch.allclose(v.T @ v, eye, **CARD_TOL_LINALG))
    check(ok, "20a: a decomposition on the card does not reconstruct")


def card_random_ops(torch, paddle, names):
    """Each random op on the card: its draws are on the card, fixed by
    ``paddle.seed``, changed by another seed."""
    ops = paddle.ops
    p = torch.full((64,), 0.5, device="cuda")
    calls = {
        "uniform": lambda: ops.uniform([64]), "rand": lambda: ops.rand([64]),
        "randn": lambda: ops.randn([64]),
        "standard_normal": lambda: ops.standard_normal([64]),
        "normal": lambda: ops.normal(1.0, 2.0, [64]),
        "randint": lambda: ops.randint(0, 1000, [64]),
        "randperm": lambda: ops.randperm(64),
        "bernoulli": lambda: ops.bernoulli(p),
        "poisson": lambda: ops.poisson(p * 8),
        "exponential": lambda: ops.exponential(p),
        "multinomial": lambda: ops.multinomial(p, 32),
        "gumbel_softmax": lambda: ops.gumbel_softmax(p.reshape(8, 8)),
    }
    check(set(calls) == set(names), f"20a: random ops {sorted(names)}")
    for name, call in calls.items():
        paddle.seed(3)
        a = call()
        paddle.seed(3)
        b = call()
        paddle.seed(4)
        c = call()
        check(a.is_cuda and torch.equal(a, b) and not torch.equal(a, c),
              f"20a: {name} is not seeded on the card")


def phase_ops_on_card(torch, paddle):
    """Phase 20 (a): every op of the port's registry on the card against
    the port on the CPU, from ``tests/torch_op_cases.py`` (the CPU
    conformance test's cases): outputs and, where differentiable,
    gradients at ``CARD_TOL`` (``CARD_TOL_LINALG`` for the cases the CPU
    test holds at 1e-4).  The decompositions are held by reconstruction,
    the random ops to seeded reproducibility on the card."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_op_cases as oc

    from paddle_tpu_torch.core.dispatch import get_op, list_ops

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ran, failed = set(), []
    try:
        for case in oc.CASES:
            paddle.set_device("cpu")
            want = oc.run_port(case, paddle.ops, get_op, "cpu")
            paddle.set_device("gpu")
            got = oc.run_port(case, paddle.ops, get_op, "cuda")
            tol = CARD_TOL_LINALG if case.tol is oc.LOOSE else CARD_TOL
            try:
                oc.close(got[0], want[0], tol, f"{case.id} output")
                if want[1] is not None:
                    oc.close(got[1], want[1], tol, f"{case.id} gradient")
            except AssertionError as e:
                failed.append(f"{case.id}: {str(e).strip()[:400]}")
            ran.add(case.name)
        card_decompositions(torch, paddle.ops)
        ran |= oc.SPECIAL
        card_random_ops(torch, paddle, oc.RANDOM)
        ran |= oc.RANDOM
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    names = set(list_ops())
    skipped = sorted(names - ran)
    print(f"[phase 20a] {len(ran & names)} of the {len(names)} registered "
          f"ops run on the card ({len(oc.CASES)} cases against the CPU at "
          f"{CARD_TOL}, linear algebra at {CARD_TOL_LINALG}; qr, svd, eigh "
          f"by reconstruction; the {len(oc.RANDOM)} random ops by seeded "
          f"reproducibility, their bits being the device's); skipped: "
          f"{skipped or 'none'}")
    for line in failed:
        print(f"[phase 20a] FAILED {line}")
    check(not failed and not skipped,
          f"20a: {len(failed)} case(s) differ, {len(skipped)} op(s) not run")
    return len(ran & names)


def phase_paddle_program(torch, paddle, fa, gpt_init, gpt_loss, cfg):
    """Phase 20 (b): the Paddle-style GPT of ``models/paddle_gpt.py``
    (the top-level surface only) at GPT-3 1.3B's widths, depth cut to
    ``PROGRAM_LAYERS``, batch ``PROGRAM_BATCH`` x 2048, from a
    ``gpt_init`` tree: an fp32 forward and backward against ``gpt_loss``
    on the same tree (loss and every gradient at ``TOL["float32"]``),
    then 3 AdamW steps under bf16 ``auto_cast`` with the flash launches
    counted; the loss falls."""
    from paddle_tpu_torch.models import paddle_gpt as prog

    c = dataclasses.replace(cfg, num_layers=PROGRAM_LAYERS, dtype="float32",
                            remat="nothing")
    params = gpt_init(c, torch.Generator(device="cuda").manual_seed(20),
                      device="cuda")
    tokens = np.random.default_rng(20).integers(
        0, c.vocab_size, (PROGRAM_BATCH, c.max_seq_len)).astype(np.int64)
    labels = prog.next_token_labels(tokens)
    paddle.set_device("gpu")
    paddle.seed(20)
    model = prog.build_gpt(paddle, c.vocab_size, c.hidden, c.num_heads,
                           c.ffn_hidden, c.num_layers, c.max_seq_len)
    missing, unexpected = model.set_state_dict(
        prog.gpt_state_from_params(params, c.num_layers))
    check(not missing and not unexpected, f"20b: {missing} {unexpected}")
    x, y = paddle.to_tensor(tokens), paddle.to_tensor(labels)
    zero_counts(fa)
    loss = prog.loss_fn(paddle, model, x, y)
    loss.backward()
    fp32_launches = dict(fa.launches)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in prog.gpt_state_from_params(
                  params, c.num_layers).items()}
    tree = {"wte": leaves["wte.weight"], "wpe": leaves["wpe.weight"],
            "lnf_g": leaves["lnf.weight"], "lnf_b": leaves["lnf.bias"],
            "blocks": {key: torch.stack([leaves[f"blocks.{i}.{name}"]
                                         for i in range(c.num_layers)])
                       for name, key in prog._BLOCK_KEYS.items()}}
    ref = gpt_loss(c, tree, torch.from_numpy(tokens).cuda())
    names = list(leaves)
    grads = torch.autograd.grad(ref, [leaves[k] for k in names])
    own = dict(model.named_parameters())
    worst, bad = 0.0, []
    for k, g in zip(names, grads):
        got = own[k].grad
        worst = max(worst, max_err(torch, got, g))
        if not torch.allclose(got, g, **TOL["float32"]):
            bad.append(k)
    loss_err = abs(loss.item() - ref.item())
    print(f"[phase 20b] Paddle-style GPT ({c.num_layers} layers at GPT-3 "
          f"1.3B widths, batch {PROGRAM_BATCH} x {c.max_seq_len}), fp32 "
          f"step 0: loss {loss.item():.6f} vs gpt_loss {ref.item():.6f} "
          f"(|diff| {loss_err:.3g}); {len(names)} gradients, largest "
          f"difference {worst:.3g}, outside {TOL['float32']}: {bad or 'none'}"
          f"; flash launches {fp32_launches}")
    check(loss_err <= TOL["float32"]["atol"] + TOL["float32"]["rtol"] *
          abs(ref.item()) and not bad, "20b: the program differs from "
                                       "gpt_loss")
    check(fp32_launches["fwd"] > 0 and fp32_launches["bwd"] > 0,
          "20b: the fp32 step did not run the flash kernels")
    del tree, leaves, grads, ref, loss
    for p in model.parameters():
        p.clear_grad()
    torch.cuda.synchronize()
    zero_counts(fa)
    t0 = time.perf_counter()
    losses = prog.train(paddle, model, tokens, labels, steps=3,
                        amp_dtype="bfloat16")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    launches = dict(fa.launches)
    print(f"[phase 20b] 3 AdamW steps under bf16 auto_cast: losses "
          f"{[round(v, 5) for v in losses]}, {ms:.1f} ms a step (the first "
          f"step's allocations included), flash launches {launches} "
          f"({c.num_layers} forward and {c.num_layers} backward a step); "
          f"{card_line()}")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)),
          "20b: the loss did not fall")
    check(launches["fwd"] == 3 * c.num_layers and
          launches["bwd"] == 3 * c.num_layers,
          f"20b: flash launches {launches}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


DATA_FIT = (1280, 128)             # phase 21 (a): FakeImageNet size, batch
DATA_WORKERS = (0, 8)              # (a): the two loaders compared
DATA_CHECKED = 5                   # (a): leading batches held bitwise
DATA_EPOCHS = 2                    # (a): imgs/s over the last epoch
# (b): PTB "large" (Zaremba et al. 2014; PaddlePaddle's ptb_lm example)
PTB = dict(vocab=10000, embed=1500, hidden=1500, layers=2, steps=35,
           batch=20, dropout=0.65)
PTB_TRAIN_STEPS = 20
FUSED_BERT = dict(layers=12, d_model=768, nhead=12, ffn=3072,
                  batch=(32, 512))         # (c): BERT-base widths
FUSED_STEPS = 3
CARD_CPU_TOL = dict(atol=1e-4, rtol=1e-4)  # (d), (e): card vs the CPU


class SampleSeeded:
    """A map-style dataset whose item ``i`` is built under numpy's global
    seed ``seed * 1_000_003 + i``, so a random transform draws the same
    for a sample whichever process builds it: (a)'s two loaders then
    deliver the same bits (the loader itself keeps numpy's global state
    as the JAX package does, one stream a process)."""

    def __init__(self, base, seed):
        self.base, self.seed = base, seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        np.random.seed((self.seed * 1_000_003 + i) % 2 ** 32)
        return self.base[i]


def smi_compute_pids():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return {int(p) for p in out.split() if p.strip().isdigit()}


def shm_segments():
    """The shared-memory segments made for this process's loaders."""
    from paddle_tpu_torch.io.multiprocess import segment_prefix

    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(segment_prefix()))


class StepClock:
    """Host time at the end of every training step of a ``fit``."""

    def __init__(self, paddle):
        outer = self

        class CB(paddle.hapi.Callback):
            def on_train_batch_end(self, step, logs=None):
                outer.ends.append(time.perf_counter())

            def on_epoch_begin(self, epoch, logs=None):
                outer.epoch_starts.append(time.perf_counter())

        self.ends, self.epoch_starts = [], []
        self.callback = CB()


def data_pipeline(torch, paddle):
    """Phase 21 (a): ResNet-50 (bf16 O1, Momentum) trained by ``fit`` from
    a DataLoader over ``FakeImageNet`` through Resize(256) -> CenterCrop
    -> flip -> Normalize, at 0 and at 8 worker processes.  Returns the
    model of the 8-worker run (for (f))."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.observability import GoodputMonitor
    from paddle_tpu_torch.vision import datasets, transforms as T

    n, B = DATA_FIT
    paddle.set_device("gpu")
    t0 = time.perf_counter()
    base = datasets.FakeImageNet(size=n, transform=T.Compose([
        T.Resize(256), T.CenterCrop(224), T.RandomHorizontalFlip(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])]))
    ds = SampleSeeded(base, 21)
    made = time.perf_counter() - t0
    shm_before = shm_segments()

    probe_dir = tempfile.mkdtemp(prefix="workers_")

    def probe(worker_id):
        """In each worker: torch's bad-fork guard is set (it refuses to
        initialise CUDA in a forked child) and no CUDA state was made."""
        with open(os.path.join(probe_dir, str(worker_id)), "w") as f:
            json.dump({"pid": os.getpid(),
                       "bad_fork": torch.cuda._is_in_bad_fork(),
                       "cuda_initialized": torch.cuda.is_initialized()}, f)

    def loader(workers):
        np.random.seed(21)          # the sampler's permutation
        return DataLoader(ds, batch_size=B, shuffle=True, drop_last=True,
                          num_workers=workers, timeout=300,
                          worker_init_fn=probe)

    firsts, runs, model = {}, {}, None
    for workers in DATA_WORKERS:
        dl = loader(workers)
        it = iter(dl)
        got = []
        t0 = time.perf_counter()
        for i in range(DATA_CHECKED):
            x, y = next(it)
            if i == 0:
                first_ms = (time.perf_counter() - t0) * 1e3
            check(x.is_cuda and y.is_cuda and tuple(x.shape) ==
                  (B, 3, 224, 224), f"21a: batch {tuple(x.shape)} on "
                  f"{x.device}")
            got.append((x.clone(), y.clone()))
        if workers:
            pids = dl._workers.worker_pids
            listed = smi_compute_pids()
            seen = [json.load(open(os.path.join(probe_dir, f)))
                    for f in sorted(os.listdir(probe_dir))]
            check(not set(pids) & listed,
                  f"21a: a worker holds a CUDA context: {listed & set(pids)}")
            check(len(seen) == workers and all(
                w["bad_fork"] and not w["cuda_initialized"] for w in seen),
                f"21a: workers' CUDA state {seen}")
            print(f"[phase 21a] {workers} workers (pids {pids}): each "
                  f"reports torch's bad-fork guard set and no CUDA state "
                  f"initialised; nvidia-smi lists compute processes "
                  f"{sorted(listed)} (this process {os.getpid()} "
                  f"{'listed' if os.getpid() in listed else 'not listed'}"
                  f"): no worker among them")
        it.close()
        firsts[workers] = got
        gc.collect()
        torch.cuda.empty_cache()
        model = resnet_model(paddle, 0.01)
        clock = StepClock(paddle)
        goodput = GoodputMonitor(flops_per_step=resnet_flops(
            torch, model.network, B))
        watchdog().reset()
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(dtype="bfloat16"):
            model.fit(loader(workers), epochs=DATA_EPOCHS, verbose=0,
                      callbacks=[clock.callback, goodput])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = goodput.report()
        shares = {k: v / rep["total_seconds"]
                  for k, v in rep["phases_seconds"].items()}
        steps = n // B
        last = clock.ends[-steps:]
        # the last epoch's steady steps: its first two also wait for the
        # workers to start and for the first batches
        ips = ((steps - 2) * B) / (last[-1] - last[1])
        # the whole fit's rate: every epoch's forks and first batch, and
        # the capture, included
        fit_ips = DATA_EPOCHS * steps * B / wall
        start_s = last[0] - clock.epoch_starts[-1]
        captured = check_captured_once(model, "hapi::train_step",
                                       f"21a {workers} workers")
        runs[workers] = (ips, shares, fit_ips)
        print(f"[phase 21a] num_workers={workers}: whole fit {fit_ips:.1f} "
              f"imgs/s ({DATA_EPOCHS} x {steps * B} images over the fit's "
              f"wall time); steady {ips:.1f} imgs/s over "
              f"steps 3-{steps} of epoch {DATA_EPOCHS} (batch {B}), leaving "
              f"out the epoch's start; the "
              f"epoch's first step ended {start_s:.2f} s after its start; "
              f"the first batch of a fresh iterator {first_ms:.0f} ms; fit "
              f"{wall:.1f} s for {DATA_EPOCHS} epochs; goodput shares "
              + ", ".join(
                  f"{k} {shares[k]:.4f}" for k in
                  ("compute", "data_wait", "compile", "checkpoint", "eval"))
              + f" of {rep['total_seconds']:.2f} s; {captured}; "
              f"{card_line()}")
        if workers != DATA_WORKERS[-1]:
            del model
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(firsts[DATA_WORKERS[0]],
                               firsts[DATA_WORKERS[-1]]))
    left = sorted(set(shm_segments()) - set(shm_before))
    print(f"[phase 21a] FakeImageNet({n}) made in {made:.1f} s; the first "
          f"{DATA_CHECKED} batches at {DATA_WORKERS[0]} and "
          f"{DATA_WORKERS[-1]} workers bitwise equal: {same}; shared-memory "
          f"segments left: {len(left)}; data_wait share "
          f"{runs[DATA_WORKERS[0]][1]['data_wait']:.4f} -> "
          f"{runs[DATA_WORKERS[-1]][1]['data_wait']:.4f}, whole-fit imgs/s "
          f"{runs[DATA_WORKERS[0]][2]:.1f} -> {runs[DATA_WORKERS[-1]][2]:.1f}"
          f", steady imgs/s "
          f"{runs[DATA_WORKERS[0]][0]:.1f} -> {runs[DATA_WORKERS[-1]][0]:.1f}")
    check(same, "21a: batches differ between 0 and 8 workers")
    shutil.rmtree(probe_dir, ignore_errors=True)
    check(not left, f"21a: shared-memory segments left: {left}")
    del firsts
    return model


def ptb_corpus(path, vocab, tokens, seed=21):
    """A synthetic PTB-layout text file: one line holding every word of a
    ``vocab - 1``-word vocabulary (so ``Imikolov`` builds ``vocab`` ids
    with ``<unk>``), then Zipf-distributed lines of 5 to 40 words."""
    rng = np.random.RandomState(seed)
    words = np.array([f"w{i}" for i in range(vocab - 1)])
    p = 1.0 / np.arange(1, vocab)
    p /= p.sum()
    lines = [" ".join(rng.permutation(words))]
    n = vocab - 1
    while n < tokens:
        k = int(rng.randint(5, 41))
        lines.append(" ".join(words[rng.choice(vocab - 1, k, p=p)]))
        n += k
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def ptb_model(paddle, seed):
    c = PTB

    class PTBLM(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = paddle.nn.Embedding(c["vocab"], c["embed"])
            self.lstm = paddle.nn.LSTM(c["embed"], c["hidden"],
                                       num_layers=c["layers"],
                                       dropout=c["dropout"])
            self.drop = paddle.nn.Dropout(c["dropout"])
            self.fc = paddle.nn.Linear(c["hidden"], c["vocab"])

        def forward(self, x):
            out, _ = self.lstm(self.drop(self.embedding(x)))
            return self.fc(self.drop(out))

    class SeqLoss(paddle.nn.Layer):
        def forward(self, logits, y):
            return paddle.nn.functional.cross_entropy(
                logits.reshape(-1, c["vocab"]), y.reshape(-1))

    paddle.seed(seed)
    model = paddle.Model(PTBLM())
    model.prepare(paddle.optimizer.SGD(
        learning_rate=1.0, parameters=model.parameters(),
        grad_clip=paddle.optimizer.ClipGradByGlobalNorm(5.0)), SeqLoss())
    return model


def ptb_lstm(torch, paddle):
    """Phase 21 (b): the PTB-large LSTM language model, ``PTB_TRAIN_STEPS``
    ``train_batch`` steps on the captured graph and the same on the eager
    route, from one seed and the same batches.  Returns ms/step."""
    from paddle_tpu_torch.text import Imikolov

    c = PTB
    B, S = c["batch"], c["steps"]
    need = PTB_TRAIN_STEPS * S + 1
    tmp = tempfile.mkdtemp(prefix="ptb_")
    try:
        path = os.path.join(tmp, "ptb.train.txt")
        ptb_corpus(path, c["vocab"], B * need + 2000)
        ds = Imikolov(data_file=path, data_type="SEQ")
        check(len(ds.word_idx) == c["vocab"],
              f"21b: vocabulary {len(ds.word_idx)}")
        stream = np.concatenate([ds[i] for i in range(len(ds))])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    data = torch.from_numpy(stream[:B * need].reshape(B, need)).cuda()
    batches = [(data[:, i * S:(i + 1) * S].contiguous(),
                data[:, i * S + 1:(i + 1) * S + 1].contiguous())
               for i in range(PTB_TRAIN_STEPS)]
    paddle.set_device("gpu")
    res = {}
    for route in ("graph", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        model = ptb_model(paddle, 21)
        watchdog().reset()
        ctx = (eager_route(torch, model) if route == "eager"
               else contextlib.nullcontext())
        losses, times = [], []
        with ctx:
            for x, y in batches:
                t0 = time.perf_counter()
                losses.append(float(model.train_batch(x, y)[0]))
                times.append(time.perf_counter() - t0)
        ms = float(np.mean(times[2:])) * 1e3
        extra = (check_captured_once(model, "hapi::train_step", "21b")
                 if route == "graph" else "no capture")
        res[route] = (losses, ms)
        print(f"[phase 21b] PTB-large LSTM LM (vocab {c['vocab']}, embed "
              f"{c['embed']}, {c['layers']} x LSTM {c['hidden']}, {S} steps, "
              f"batch {B}, dropout {c['dropout']}, fp32), {route} route: "
              f"{ms:.2f} ms/step over steps 3-{PTB_TRAIN_STEPS} (host clock, "
              f"float(loss) each step); losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}; {extra}; {card_line()}")
        del model
    (gl, gms), (el, ems) = res["graph"], res["eager"]
    diff = max(abs(a - b) for a, b in zip(gl, el))
    print(f"[phase 21b] step-1 loss graph {gl[0]:.7f} eager {el[0]:.7f} "
          f"(|diff| {abs(gl[0] - el[0]):.3g}, checked at 1e-6); largest "
          f"difference over the {PTB_TRAIN_STEPS} steps {diff:.3g}; "
          f"graph {gms:.2f} vs eager {ems:.2f} ms/step")
    check(abs(gl[0] - el[0]) <= 1e-6, "21b: step-1 loss graph != eager")
    check(all(np.isfinite(gl)) and np.mean(gl[-5:]) < np.mean(gl[:5]),
          "21b: the loss did not fall")
    return gms, ems


def fused_from_encoder(torch, layer, fused):
    """Load an ``nn.TransformerEncoderLayer``'s weights into a
    ``FusedTransformerEncoderLayer`` (q, k, v packed head-major)."""
    a, f, ffn = layer.self_attn, fused.fused_attn, fused.ffn
    with torch.no_grad():
        f.qkv_weight.copy_(torch.cat([a.q_proj.weight, a.k_proj.weight,
                                      a.v_proj.weight], 1))
        f.qkv_bias.copy_(torch.cat([a.q_proj.bias, a.k_proj.bias,
                                    a.v_proj.bias]))
        f.linear_weight.copy_(a.out_proj.weight)
        f.linear_bias.copy_(a.out_proj.bias)
        f.ln_scale.copy_(layer.norm1.weight)
        f.ln_bias.copy_(layer.norm1.bias)
        ffn.w1.copy_(layer.linear1.weight)
        ffn.b1.copy_(layer.linear1.bias)
        ffn.w2.copy_(layer.linear2.weight)
        ffn.b2.copy_(layer.linear2.bias)
        ffn.ln_scale.copy_(layer.norm2.weight)
        ffn.ln_bias.copy_(layer.norm2.bias)
    return fused


def fused_encoder(torch, paddle, fa):
    """Phase 21 (c): 12 ``incubate.nn.FusedTransformerEncoderLayer``s at
    BERT-base widths, bf16 auto_cast, attention dropout 0, trained with
    AdamW; then one fp32 layer against ``nn.TransformerEncoderLayer`` with
    the same weights.  Returns the flash launches of the timed steps."""
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    c = FUSED_BERT
    B, S = c["batch"]
    E = c["d_model"]
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    paddle.seed(21)
    layers = paddle.nn.LayerList([FusedTransformerEncoderLayer(
        E, c["nhead"], c["ffn"], dropout_rate=0.1, activation="gelu",
        attn_dropout_rate=0.0) for _ in range(c["layers"])])
    x = torch.randn(B, S, E, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(21))
    opt = paddle.optimizer.AdamW(1e-4, parameters=layers.parameters())

    def step():
        with paddle.amp.auto_cast():
            h = x
            for layer in layers:
                h = layer(h)
            loss = h.float().square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for _ in range(2):              # warm-up: the allocator, AdamW's slots
        step()
    torch.cuda.synchronize()
    for k in fa.launches:
        fa.launches[k] = 0
    t0 = time.perf_counter()
    for _ in range(FUSED_STEPS):
        loss = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / FUSED_STEPS * 1e3
    launches = dict(fa.launches)
    want = c["layers"] * FUSED_STEPS
    print(f"[phase 21c] fused encoder {c['layers']} x FusedTransformer"
          f"EncoderLayer({E}, {c['nhead']} heads, FFN {c['ffn']}) at {B} x "
          f"{S}, bf16 auto_cast, AdamW: {ms:.1f} ms/step over "
          f"{FUSED_STEPS} steps (host clock, synchronised), flash launches "
          f"{launches} (want {want} forward and {want} backward), loss "
          f"{float(loss):.5f}; {card_line()}")
    check(launches == {"fwd": want, "bwd": want},
          f"21c: flash launches {launches}")
    del layers, opt
    gc.collect()
    torch.cuda.empty_cache()
    # one fp32 layer, eval, against the unfused layer with its weights
    paddle.seed(22)
    ref = paddle.nn.TransformerEncoderLayer(
        E, c["nhead"], c["ffn"], dropout=0.1, activation="gelu",
        attn_dropout=0.0)
    fused = fused_from_encoder(torch, ref, FusedTransformerEncoderLayer(
        E, c["nhead"], c["ffn"], dropout_rate=0.1, activation="gelu",
        attn_dropout_rate=0.0))
    ref.eval()
    fused.eval()
    xs = x[:4].float()
    with torch.no_grad():
        got, want_out = fused(xs), ref(xs)
    err = max_err(torch, got, want_out)
    print(f"[phase 21c] one fp32 layer at 4 x {S}, eval: fused vs "
          f"nn.TransformerEncoderLayer max abs err {err:.3g} (atol "
          f"{TOL_FLASH['float32']['atol']}, rtol "
          f"{TOL_FLASH['float32']['rtol']})")
    check(torch.allclose(got, want_out, **TOL_FLASH["float32"]),
          f"21c: fused layer != unfused: {err:.3g}")
    del x, ref, fused
    return launches


def card_vs_cpu(torch, name, fn, args, iters=10, tol=CARD_CPU_TOL,
                exact=False):
    """``fn`` on the card's ``args`` and on their CPU copies: equal at
    ``tol`` (``exact``: equal), and the card's ms a call."""
    cpu = [a.cpu() if isinstance(a, torch.Tensor)
           else ("cpu" if a == "cuda" else a) for a in args]
    got = fn(*args)
    want = fn(*cpu)
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    errs = []
    for g, w in zip(gots, wants):
        check(g.is_cuda, f"21: {name} left the card")
        g = g.cpu()
        if exact:
            check(torch.equal(g, w), f"21: {name} differs from the CPU")
            errs.append(0.0)
        else:
            gd, wd = torch.view_as_real(g) if g.is_complex() else g, \
                torch.view_as_real(w) if w.is_complex() else w
            errs.append(max_err(torch, gd, wd))
            check(torch.allclose(gd.float(), wd.float(), **tol),
                  f"21: {name} differs from the CPU by {errs[-1]:.3g}")
    ms = time_ms(torch, lambda: fn(*args), iters, warmup=2)
    return ms, max(errs)


def detection_ops(torch, paddle):
    """Phase 21 (d): detector-sized vision ops, card vs CPU."""
    from paddle_tpu_torch.vision import detection_ops as det, ops as vops

    g = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    feat = torch.randn(2, 256, 200, 304, device="cuda", generator=g)
    xy = torch.rand(1024, 2, device="cuda", generator=g) * \
        torch.tensor([1200.0, 760.0], device="cuda")
    wh = torch.rand(1024, 2, device="cuda", generator=g) * 200 + 4
    rois = torch.cat([xy, xy + wh], 1)
    bn = torch.tensor([512, 512], device="cuda")
    out["roi_align [2,256,200,304] x 1024 RoIs, 7x7, sampling 2"] = \
        card_vs_cpu(torch, "roi_align", lambda f, r, b: det.roi_align(
            f, r, b, output_size=7, spatial_scale=0.25, sampling_ratio=2),
            [feat, rois, bn], iters=5)
    del feat
    bxy = torch.rand(2000, 2, device="cuda", generator=g) * 600
    bwh = torch.rand(2000, 2, device="cuda", generator=g) * 120 + 8
    boxes = torch.cat([bxy, bxy + bwh], 1)
    scores = torch.rand(2000, device="cuda", generator=g)
    out["nms 2000 boxes at IoU 0.7"] = card_vs_cpu(
        torch, "nms", lambda b, s: vops.nms(b, 0.7, scores=s),
        [boxes, scores], exact=True)
    kept = vops.nms(boxes, 0.7, scores=scores)
    yolo = torch.randn(8, 255, 76, 76, device="cuda", generator=g)
    im = torch.full((8, 2), 608.0, device="cuda")
    anchors = [10, 13, 16, 30, 33, 23]
    out["yolo_box [8,255,76,76], 80 classes, 608"] = card_vs_cpu(
        torch, "yolo_box", lambda x, s: det.yolo_box(
            x, s, anchors, 80, conf_thresh=0.01, downsample_ratio=8),
        [yolo, im], tol=dict(atol=1e-3, rtol=1e-5))
    out["prior_box SSD-300 38x38"] = card_vs_cpu(
        torch, "prior_box", lambda dev: det.prior_box(
            (38, 38), (300, 300), [30.0], [60.0], aspect_ratios=(2.0,),
            flip=True, clip=True, steps=(8.0, 8.0), device=dev),
        ["cuda"])
    prior = torch.rand(2000, 4, device="cuda", generator=g).sort(1).values
    deltas = torch.randn(2000, 4, device="cuda", generator=g) * 0.2
    out["box_coder decode 2000 x 4"] = card_vs_cpu(
        torch, "box_coder", lambda p, d: det.box_coder(
            p, d, [0.1, 0.1, 0.2, 0.2], code_type="decode_center_size"),
        [prior, deltas])
    for k, (ms, err) in out.items():
        print(f"[phase 21d] {k}: {ms:.3f} ms a call on the card, max abs "
              f"err vs the CPU {err:.3g}")
    print(f"[phase 21d] nms kept {len(kept)} of 2000, indices equal to the "
          f"CPU's; {card_line()}")
    return out


def domain_ops(torch, paddle):
    """Phase 21 (e): signal, fft, sparse and the distributions, card vs
    CPU."""
    from paddle_tpu_torch import distribution as D, fft, signal, sparse

    g = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    audio = torch.randn(16, 160000, device="cuda", generator=g)
    win = torch.hann_window(512, device="cuda")
    out["stft [16,160000] n_fft 512 hop 160"] = card_vs_cpu(
        torch, "stft", lambda a, w: signal.stft(a, 512, 160, window=w),
        [audio, win], iters=5)
    spec = signal.stft(audio, 512, 160, window=win)
    out["istft of it"] = card_vs_cpu(
        torch, "istft", lambda s, w: signal.istft(s, 512, 160, window=w,
                                                  length=160000),
        [spec, win], iters=5)
    back = signal.istft(spec, 512, 160, window=win, length=160000)
    trip = max_err(torch, back, audio)
    check(trip <= 1e-4, f"21e: stft round trip off by {trip:.3g}")
    del spec, back, audio
    img = torch.randn(64, 512, 512, device="cuda", generator=g)
    out["fft2 [64,512,512] (ortho)"] = card_vs_cpu(
        torch, "fft2", lambda a: fft.fft2(a, norm="ortho"), [img], iters=5)
    del img
    n, nnz = 4096, int(4096 * 4096 * 0.01)
    idx = torch.randint(0, n, (2, nnz), device="cuda", generator=g)
    vals = torch.randn(nnz, device="cuda", generator=g)
    dense = torch.randn(n, 512, device="cuda", generator=g)
    out["sparse COO 4096^2 at 1% x [4096,512]"] = card_vs_cpu(
        torch, "sparse.matmul", lambda i, v, d: sparse.matmul(
            sparse.sparse_coo_tensor(i, v, (n, n)), d), [idx, vals, dense],
        iters=5)
    M = 1 << 20

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device="cuda", generator=g) * (hi - lo) + lo

    dists = {
        "Normal": ((torch.randn(M, device="cuda", generator=g),
                    u(M, lo=0.5, hi=2.0)), torch.randn(M, device="cuda",
                                                       generator=g)),
        "Uniform": ((u(M, lo=-2, hi=-1), u(M, lo=1, hi=2)),
                    u(M, lo=-1.5, hi=1.5)),
        "Categorical": ((torch.randn(M, 10, device="cuda", generator=g),),
                        torch.randint(0, 10, (M,), device="cuda",
                                      generator=g)),
        "Bernoulli": ((u(M, lo=0.05, hi=0.95),),
                      (u(M) < 0.5).float()),
        "Beta": ((u(M, lo=0.5, hi=4), u(M, lo=0.5, hi=12)),
                 u(M, lo=0.02, hi=0.98)),
        "Dirichlet": ((u(M, 5, lo=0.3, hi=3),),
                      torch.softmax(torch.randn(M, 5, device="cuda",
                                                generator=g), -1)),
    }
    for name, (ps, v) in dists.items():
        cls = getattr(D, name)
        other = tuple(p.flip(0) for p in ps)
        fns = {"log_prob": lambda v, *p: cls(*p).log_prob(v)}
        if name not in ("Beta", "Dirichlet"):
            fns["entropy"] = lambda v, *p: cls(*p).entropy()
            fns["kl_divergence"] = lambda v, *p: D.kl_divergence(
                cls(*p[:len(ps)]), cls(*p[len(ps):]))
        for what, fn in fns.items():
            args = [v, *ps] + (list(other) if what == "kl_divergence" else [])
            if name == "Uniform" and what == "kl_divergence":
                fn = (lambda f: lambda v, *p: torch.nan_to_num(
                    f(v, *p), posinf=0.0))(fn)
            if name == "Uniform" and what == "log_prob":
                fn = (lambda f: lambda v, *p: torch.nan_to_num(
                    f(v, *p), neginf=0.0))(fn)
            out[f"{name}.{what} at batch 1M"] = card_vs_cpu(
                torch, f"{name}.{what}", fn, args, iters=5)
    for k, (ms, err) in out.items():
        print(f"[phase 21e] {k}: {ms:.3f} ms a call on the card, max abs "
              f"err vs the CPU {err:.3g}")
    print(f"[phase 21e] stft -> istft round trip max abs err {trip:.3g} "
          f"(checked at 1e-4); {card_line()}")
    return out


def save_load(torch, paddle, model):
    """Phase 21 (f): ``paddle.save`` / ``paddle.load`` of (a)'s ResNet-50
    state dict and its optimizer's state (the Momentum slots the captured
    train step updates), on the card."""
    paddle.set_device("gpu")
    tmp = tempfile.mkdtemp(prefix="save_")
    try:
        res = {}
        for name, tree in (("state dict", model.network.state_dict()),
                           ("optimizer state", model._opt_state)):
            path = os.path.join(tmp, name.replace(" ", "_"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paddle.save(tree, path)
            t1 = time.perf_counter()
            back = paddle.load(path)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            want = dict(_flat_tensors(tree))
            got = dict(_flat_tensors(back))
            check(sorted(got) == sorted(want),
                  f"21f: {name} keys differ after the round trip")
            for k, t in want.items():
                check(got[k].is_cuda, f"21f: {name} {k} not on the card")
                check(got[k].dtype == t.dtype and torch.equal(got[k], t),
                      f"21f: {name} {k} not bitwise after the round trip")
            check(want, f"21f: no tensor in the {name}")
            res[name] = (len(want), os.path.getsize(path), t1 - t0, t2 - t1)
            print(f"[phase 21f] paddle.save / paddle.load of ResNet-50's "
                  f"{name}: {len(want)} tensors, "
                  f"{os.path.getsize(path) / 2**20:.1f} MiB, save {(t1 - t0) * 1e3:.0f} ms, load to the card "
                  f"{(t2 - t1) * 1e3:.0f} ms; every tensor bitwise and on "
                  f"cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def phase_domain(torch, paddle, fa):
    """Phase 21: the data pipeline and the domain libraries on the card.
    Returns (c)'s flash launches."""
    parts = {}
    t0 = time.perf_counter()
    model = data_pipeline(torch, paddle)
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_load(torch, paddle, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    parts["f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptb_lstm(torch, paddle)
    parts["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = fused_encoder(torch, paddle, fa)
    parts["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    detection_ops(torch, paddle)
    parts["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    domain_ops(torch, paddle)
    parts["e"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print("[phase 21] part seconds: " + ", ".join(
        f"({k}) {v:.1f}" for k, v in sorted(parts.items())))
    return launches


# ------------------------------------------- worlds of ranks (phase 22)

#: phase 22's cases (a)-(e), each a grid over the one world of
#: ``HYBRID_RANKS`` ranks: the mesh, the model's depth and its global
#: batch at GPT-3 1.3B's widths, every case cut to 4 layers: (a) and
#: (b) from 24 when phase 24 joined the script (its time limit); (c)-(e)
#: since every sep or ep rank holds the whole dense state (phase 10's
#: and 13's cells)
HYBRID = {
    "a": dict(axes=dict(dp=2, mp=2), layers=4, batch=(4, 2048)),
    "b": dict(axes=dict(sharding=4), layers=4, batch=(4, 2048)),
    "c": dict(axes=dict(sep=4), layers=4, batch=(8, 2048), ring=True),
    "d": dict(axes=dict(sep=2, dp=2), layers=4, batch=(8, 2048)),
    "e": dict(axes=dict(ep=4), layers=4, batch=(8, 2048), moe=True,
              limits=(2e-3, 2e-2)),
}
HYBRID_RANKS = 4
HYBRID_STEPS = 2                   # a case's steps: 1 warm, 1 timed (cut
#                                    from 3 when phase 25 joined)
HYBRID_TINY_BATCH = (4, 512)       # the fp32 check at tiny widths
MOE_NO_DROP = 4.0                  # (e): C = n·4·2/8 = n, nothing drops
MOE_RING = dict(layers=4, check=(1, 2048), train=(2, 2048), sep=4)  # (f)
MLP_DP = dict(hidden=1024, batch=128, steps=3)                       # (g)
#: bf16 at full width, a world against the one-process engine over the
#: same steps: each step's loss (relative) and each leaf's step-1
#: gradient norm (relative to the leaf's norm); the largest readings of
#: (a)-(d) were 9.2e-5 and 9.8e-4.  (e) trains without the aux loss at
#: full width: over ep the aux is each rank's E·Σ f·p averaged
#: (_aux_mean, as the JAX engine), a different function from the one
#: process's whole-batch aux (its tiny check keeps the aux).  Its own
#: limits (``limits``): the expert matmuls round differently at a
#: rank's shapes, and a rounding flips near-tied routes (counted), each
#: changing its token's path wholesale: readings 7.2e-4 and 8.9e-3
HYBRID_LOSS_REL = 2e-4
HYBRID_GRAD_REL = 3e-3


def hybrid_cfg(case, tiny=False):
    """Case ``case``'s model config: GPT-3 1.3B at the case's depth
    (bf16, remat "dots", dropout 0), or ``tiny`` in fp32 at 512
    positions."""
    from paddle_tpu_torch.models import GPT_CONFIGS

    c = HYBRID[case]
    kw = dict(seq_parallel="ring" if c.get("ring") else "ulysses")
    if c.get("moe"):
        kw.update(moe_experts=4 if tiny else MOE_EXPERTS,
                  moe_capacity_factor=MOE_NO_DROP)
        if not tiny:
            kw.update(moe_aux_weight=0.0)
    if tiny:
        return dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32",
                                   max_seq_len=512, **kw)
    return dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"],
                               num_layers=c["layers"], **kw)


def hybrid_batch(cfg, B, S, seed=22):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    return tokens, np.concatenate([tokens[:, 1:], np.full((B, 1), -100)],
                                  1)


def grad_norms(torch, eng):
    """Each leaf's gradient norm at ``eng``'s next step, as the step
    hands its gradients to the update (before the clip), into the dict
    returned: a leaf's disjoint parts (ZeRO chunks and slices over
    sharding, pp-, mp- and ep-split leaves) summed over the ranks that
    hold them, as the clip sums them (``HybridEngine.leaf_sq``)."""
    got, apply = {}, eng._apply

    def spy(paths, leaves, grads, *rest):
        del eng._apply
        got.update(zip(paths, eng.leaf_sq(paths, grads).sqrt().tolist()))
        return apply(paths, leaves, grads, *rest)

    eng._apply = spy
    return got


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def route_spy(moe, layers):
    """``moe_route`` watched for the duration: ``seen["drops"]`` counts
    the dropped (token, choice) pairs and the pairs, ``seen["experts"]``
    holds the top-2 experts of the first ``layers`` routings (the first
    step's forward, layer by layer) as lists."""
    route, seen = moe.moe_route, {"drops": [0, 0], "experts": []}

    def spy(logits, **kw):
        r = route(logits, **kw)
        seen["drops"][0] += int((~r.keep).sum())
        seen["drops"][1] += r.keep.numel()
        if len(seen["experts"]) < layers:
            seen["experts"].append(r.expert.tolist())
        return r

    moe.moe_route = spy
    try:
        yield seen
    finally:
        moe.moe_route = route


#: the one-process engine each case is held to (the one-card ring at
#: sep 4 for (c), as phase 10's); (a) and (b) share one
HYBRID_ORACLES = {"ab": "a", "c": "c", "d": "d", "e": "e"}


def hybrid_oracle(torch, case):
    """Case ``case``'s oracle in this process, eager: each step's loss,
    each leaf's step-1 gradient norm, the peak, and (MoE) the experts of
    step 1's routings."""
    import importlib

    from paddle_tpu_torch import distributed

    moe = importlib.import_module("paddle_tpu_torch.distributed.moe")
    c = HYBRID[case]
    cfg = hybrid_cfg(case)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = distributed.HybridEngine(cfg, sep=4 if c.get("ring") else 1)
    params, opt = eng.init(seed=0)
    norms, losses = grad_norms(torch, eng), []
    batch = hybrid_batch(cfg, *c["batch"])
    with eager_route(torch, eng), route_spy(moe, cfg.num_layers) as seen:
        for _ in range(HYBRID_STEPS):
            params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
            losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    del eng, params, opt
    free_cuda(torch)
    return {"losses": losses, "grad_norms": norms, "peak": peak,
            "experts": seen["experts"]}


def _tiny_check(torch, distributed, case, rank):
    """(a)-(e) at tiny widths in fp32 (TF32 off): the world's engine on
    the case's mesh against the one-rank engine (rank 0 runs it), 3
    steps from the same params; the world's gathered params at the end."""
    from paddle_tpu_torch.models import params_to_numpy

    cfg = hybrid_cfg(case, tiny=True)
    batch = hybrid_batch(cfg, *HYBRID_TINY_BATCH, seed=5)
    one = None
    if rank == 0:
        eng = distributed.HybridEngine(cfg)
        p, o = eng.init(seed=0)
        losses = []
        for _ in range(3):
            p, o, loss = eng.step(p, o, *batch, lr=1e-3)
            losses.append(float(loss))
        one = (losses, params_to_numpy(p))
    eng = distributed.HybridEngine(cfg, **HYBRID[case]["axes"])
    p, o = eng.init(seed=0)
    losses = []
    for _ in range(3):
        p, o, loss = eng.step(p, o, *batch, lr=1e-3)
        losses.append(float(loss))
    full = params_to_numpy(eng.gather_params(p))
    if one is None:
        return None

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v})
        return out

    got = flat(full)
    err = max(float(np.abs(got[k] - v).max())
              for k, v in flat(one[1]).items())
    dl = max(abs(a - b) - 1e-4 * abs(b) for a, b in zip(losses, one[0]))
    return {"losses": losses, "one_rank": one[0], "loss_excess": dl,
            "param_err": err}


def _world_case(torch, distributed, case, rank):
    """One rank's share of case ``case`` at full width: ``HYBRID_STEPS``
    steps, the last ones timed, with the step-1 gradient norms."""
    import importlib

    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    moe = importlib.import_module("paddle_tpu_torch.distributed.moe")
    c = HYBRID[case]
    cfg = hybrid_cfg(case)
    torch.cuda.synchronize()
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = distributed.HybridEngine(cfg, **c["axes"])
    params, opt = eng.init(seed=0)
    batch = hybrid_batch(cfg, *c["batch"])
    norms, losses, times = grad_norms(torch, eng), [], []
    with route_spy(moe, cfg.num_layers) as seen:
        for i in range(HYBRID_STEPS):
            if i == 1:
                zero_counts(fa)
                ra.launches["pair_bwd"] = 0
                collective.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
    timed = HYBRID_STEPS - 1
    stats = collective.collective_stats()
    res = {
        "rank": rank, "coords": eng.coords, "losses": losses,
        "grad_norms": norms, "ms": 1e3 * sum(times[1:]) / timed,
        "peak": torch.cuda.max_memory_allocated(),
        "launches": {"fwd": fa.launches["fwd"] / timed,
                     "bwd": fa.launches["bwd"] / timed,
                     "pair_bwd": ra.launches["pair_bwd"] / timed},
        "collective_s": sum(stats["seconds"].values()) / timed,
        "bytes": {k: v / timed for k, v in stats["bytes"].items()},
        "staged": {k: v / timed for k, v in stats["staged_bytes"].items()},
        "calls": {k: v / timed for k, v in stats["calls"].items()},
        "transport": env.transport(), "digest": tree_fingerprint(params),
        "drops": seen["drops"], "experts": seen["experts"]}
    del eng, params, opt
    free_cuda(torch)
    return res


def child_hybrid(cases, out):
    """``chip_smoke.py --child hybrid CASES OUT``, one rank of phase 22's
    world (the launcher's contract): once the oracles are done (the file
    ``PHASE22_GO`` names exists), each case's tiny fp32 check and its
    full-width steps, each on an engine of the case's grid over this
    world; writes ``OUT.r<rank>.json``."""
    import torch

    from paddle_tpu_torch import distributed

    distributed.init_parallel_env()
    rank = distributed.get_rank()
    prepare(torch)
    stamps = {"ready": time.time()}
    wait_go()
    stamps["go"] = time.time()
    res = {}
    for case in cases:
        t0 = time.time()
        tiny = _tiny_check(torch, distributed, case, rank)
        res[case] = _world_case(torch, distributed, case, rank)
        res[case].update(tiny=tiny, seconds=time.time() - t0)
    with open(f"{out}.r{rank}.json", "w") as f:
        json.dump({"cases": res, "stamps": stamps}, f)
    return 0


def wait_go(limit_s=900):
    """Wait for the file ``PHASE22_GO`` names: this world's turn."""
    go, end = os.environ["PHASE22_GO"], time.time() + limit_s
    while not os.path.exists(go):
        if time.time() > end:
            raise TimeoutError(f"no {go} after {limit_s} s")
        time.sleep(0.05)


@contextlib.contextmanager
def hybrid_world(cases, n, tmp, child="hybrid", env=None):
    """Launch ``n`` ranks of ``chip_smoke.py --child CHILD CASES`` through
    the port's launcher (gloo: the ranks share this card); yields a
    function that waits for them and returns the ranks' JSON results.  A
    failing rank fails the phase; on the way out the launcher ends any
    rank still running."""
    out = os.path.join(tmp, f"{child}_{cases}")
    logs = os.path.join(tmp, f"logs_{child}_{cases}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(n), "--backend", "gloo", "--log_dir",
         logs, os.path.abspath(__file__), "--child", child, cases, out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})))

    def join(timeout=900):
        rc = proc.wait(timeout=timeout)
        if rc:
            for i in range(n):
                path = os.path.join(logs, f"workerlog.{i}")
                if os.path.exists(path):
                    print(f"--- rank {i} ---\n" + open(path).read()[-3000:])
        check(rc == 0, f"{child} ({cases}): the world of {n} ranks exited "
                       f"{rc}")
        return [json.load(open(f"{out}.r{i}.json")) for i in range(n)]

    try:
        yield join
    finally:
        if proc.poll() is None:         # the launcher ends its ranks
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _replica_key(coords):
    """Ranks whose params must be bitwise equal share this key: every
    axis but mp is a replica axis (ZeRO-2 gathers whole params; over ep
    the leaves but the experts')."""
    return coords["mp"]


def hybrid_readings(ranks, oracle):
    """A case's readings against its oracle: the worst relative loss
    difference at each step over the ranks, and the worst leaf's
    relative step-1 gradient-norm difference (rank 0's norms: every
    rank sums a leaf's parts to the same norm)."""
    steps = [max(abs(r["losses"][i] - l) / abs(l) for r in ranks)
             for i, l in enumerate(oracle["losses"])]
    got, want = ranks[0]["grad_norms"], oracle["grad_norms"]
    check(sorted(got) == sorted(want) and got,
          f"22: the world's gradient leaves {sorted(got)[:4]} are not the "
          f"oracle's {sorted(want)[:4]}")
    worst = max(want, key=lambda k: abs(got[k] - want[k]) / want[k])
    return steps, worst, abs(got[worst] - want[worst]) / want[worst]


def route_flips(ranks, oracle, axes):
    """Tokens whose step-1 top-2 experts differ between the world and
    the oracle, summed over the layers, and the tokens: a rank routes
    the rows of its data block (over dp, sharding, ep, in that order)."""
    zr, ep = axes.get("sharding", 1), axes.get("ep", 1)
    diff = n = 0
    for r in ranks:
        k = r["coords"]
        d = (k["dp"] * zr + k["sharding"]) * ep + k["ep"]
        for mine, whole in zip(r["experts"], oracle["experts"]):
            mine = np.asarray(mine)
            want = np.asarray(whole)[d * len(mine):(d + 1) * len(mine)]
            diff += int((mine != want).any(axis=1).sum())
            n += len(mine)
    return diff, n


def hybrid_case(case, ranks, oracle, wall):
    c = HYBRID[case]
    tiny = ranks[0]["tiny"]
    L = c["layers"]
    loss_rel, grad_rel = c.get("limits", (HYBRID_LOSS_REL, HYBRID_GRAD_REL))
    steps, worst, gerr = hybrid_readings(ranks, oracle)
    flips = (" routes that differ from the one process's at step 1: "
             "{} of {} tokens;".format(*route_flips(ranks, oracle,
                                                      c["axes"]))
             if c.get("moe") else "")
    r0 = ranks[0]
    print(f"[phase 22 ({case})] {c['axes']}, {L} layers, global batch "
          f"{c['batch'][0]} x {c['batch'][1]}: losses "
          f"{[round(x, 5) for x in r0['losses']]} (one process "
          f"{[round(x, 5) for x in oracle['losses']]}; relative "
          f"differences by step {[f'{x:.2e}' for x in steps]}, limit "
          f"{loss_rel:g}); step-1 gradient norms: worst leaf {worst} "
          f"{r0['grad_norms'][worst]:.6g} vs {oracle['grad_norms'][worst]:.6g}"
          f" ({gerr:.2e} relative, limit {grad_rel:g}, "
          f"{len(oracle['grad_norms'])} leaves);{flips} ms/step "
          f"{[round(r['ms'], 1) for r in ranks]} (host clock, "
          f"{HYBRID_STEPS - 1} timed steps); peak GiB a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} (one process "
          f"{oracle['peak'] / 2**30:.2f}); collective share "
          f"{[round(r['collective_s'] * 1e3 / r['ms'], 3) for r in ranks]};"
          f" MB a step by axis (rank 0) "
          f"{ {k: round(v / 2**20, 1) for k, v in r0['bytes'].items()} },"
          f" staged {sum(r0['staged'].values()) / 2**20:.1f} MB; launches a "
          f"rank a step {[r['launches'] for r in ranks]}; tiny fp32: loss "
          f"excess {tiny['loss_excess']:.2e}, params {tiny['param_err']:.2e};"
          f" {max(r['seconds'] for r in ranks):.1f} s in the world of "
          f"{wall:.1f} s; transport: {r0['transport']}")
    # the JAX tests' tolerances (tests/test_hybrid_engine.py); over ep the
    # MoE aux loss is each rank's E·Σ f·p averaged (_aux_mean), not the
    # whole batch's, so (e) takes tests/test_moe.py's ep tolerances
    loss_tol, param_tol = (2e-3, 5e-3) if c.get("moe") else (2e-4, 1e-4)
    check(tiny["loss_excess"] <= loss_tol and tiny["param_err"] <= param_tol,
          f"22 ({case}) tiny fp32: losses {tiny['losses']} vs the one-rank "
          f"{tiny['one_rank']}, params off by {tiny['param_err']}")
    check(max(steps) <= loss_rel,
          f"22 ({case}): losses off the one-process engine's by {steps}")
    check(gerr <= grad_rel,
          f"22 ({case}): the step-1 gradient norm of {worst} off the "
          f"one-process engine's by {gerr:.3g}")
    for r in ranks:
        check(r["losses"][-1] < r["losses"][0],
              f"22 ({case}): losses {r['losses']} do not fall")
        if c.get("ring"):
            live = r["coords"]["sep"] + 1
            want = {"fwd": 2 * live * L, "bwd": 0, "pair_bwd": live * L}
        else:
            want = {"fwd": 2 * L, "bwd": L, "pair_bwd": 0}
        check(r["launches"] == want,
              f"22 ({case}) rank {r['rank']}: launches a step "
              f"{r['launches']}, expected {want}")
    groups = {}
    for r in ranks:
        groups.setdefault(_replica_key(r["coords"]), []).append(r)
    for key, members in groups.items():
        for m in members[1:]:
            differ = [k for k in m["digest"]
                      if m["digest"][k] != members[0]["digest"][k]]
            if c.get("moe"):
                differ = [k for k in differ if not any(
                    w in k for w in ("up_", "down_"))]
            check(not differ, f"22 ({case}): replicas {members[0]['rank']} "
                              f"and {m['rank']} differ at {differ[:4]}")
    if c.get("moe"):
        dropped = sum(r["drops"][0] for r in ranks)
        check(dropped == 0, f"22 ({case}): {dropped} choices dropped")
    summary = {"ms": max(r["ms"] for r in ranks),
               "peak_gib": [round(r["peak"] / 2**30, 2) for r in ranks],
               "one_process_gib": round(oracle["peak"] / 2**30, 2)}
    return {k: sum(r["launches"][k] for r in ranks) * (HYBRID_STEPS - 1)
            for k in ("fwd", "bwd", "pair_bwd")}, summary


def hybrid_cases(torch, cases, tmp):
    """(a)-(e) in one world of ``HYBRID_RANKS`` ranks; the oracles run
    in this process while the ranks start (the ranks wait for them)."""
    go = os.path.join(tmp, "oracles.json")
    oracles, t0 = {}, time.perf_counter()

    def run_oracles():
        for key, case in HYBRID_ORACLES.items():
            if any(k in cases for k in key):
                res = hybrid_oracle(torch, case)
                oracles.update({k: res for k in key})
        with open(go + ".tmp", "w") as f:
            json.dump(time.perf_counter() - t0, f)
        os.replace(go + ".tmp", go)

    with hybrid_world(cases, HYBRID_RANKS, tmp,
                      env={"PHASE22_GO": go}) as join:
        run_oracles()
        ranks = join()
    wall = time.perf_counter() - t0
    ready = max(r["stamps"]["ready"] for r in ranks)
    gone = max(r["stamps"]["go"] for r in ranks)
    print(f"[phase 22 ({cases})] one world of {HYBRID_RANKS} ranks, "
          f"{wall:.1f} s: the oracles took {json.load(open(go)):.1f} s "
          f"beside the ranks' start-up, the ranks waited "
          f"{max(0.0, gone - ready):.1f} s for them")
    launches, summary = {}, {}
    for case in cases:
        launches[case], summary[case] = hybrid_case(
            case, [r["cases"][case] for r in ranks], oracles[case], wall)
    return launches, summary


#: (f): the bf16 loss and gradients on the kernels against the plain pair
#: versions with the routes pinned (relative to the loss and to each
#: leaf's largest gradient); readings 2.3e-5 and 1.7e-2
MOE_RING_LOSS_REL = 1e-4
MOE_RING_GRAD_REL = 5e-2


def pinned_routes(torch, route, recorded, flips):
    """A stand-in for ``moe_route`` that routes each call as ``recorded``
    (the next route of an earlier run, in call order) routed it: the
    experts, slots and keep masks pinned, the gate weights and the aux
    loss from this call's own logits.  ``flips`` counts the tokens whose
    own top-2 choices differ from the pinned ones, and the tokens."""
    F = torch.nn.functional
    it = iter(recorded)

    def pinned(logits, **kw):
        want = next(it)
        own = route(logits, **kw)
        flips[0] += int((own.expert != want.expert).any(dim=1).sum())
        flips[1] += own.expert.shape[0]
        probs = torch.softmax(logits.float(), dim=-1)
        gates = probs.gather(1, want.expert)
        if kw.get("normalize_top_k", True) and gates.shape[1] > 1:
            gates = gates / gates.sum(dim=1, keepdim=True)
        E = logits.shape[1]
        f = F.one_hot(want.expert[:, 0], E).float().mean(dim=0)
        return dataclasses.replace(
            want, weight=gates, aux=E * torch.sum(f * probs.mean(dim=0)))

    return pinned


def hybrid_moe_ring(torch, fa, ra):
    """22 (f): phase 13's MoE at 1.3B widths, 4 layers, at sep 4 on the
    one-card ring in this process (each shard gated on its own): one
    bf16 loss and every gradient on the kernels against the plain pair
    versions, the plain run routed as the kernel run routed (a rounding
    of the attention flips near-tied routes, and a flipped route changes
    the gradients wholesale; the flips the plain run would have made are
    counted), then bf16 steps with the drops of each shard."""
    import importlib

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.models.gpt import _flat_items

    moe = importlib.import_module("paddle_tpu_torch.distributed.moe")
    cfg = dataclasses.replace(moe_config(GPT_CONFIGS["gpt3-1.3b"]),
                              num_layers=MOE_RING["layers"],
                              seq_parallel="ring")
    free_cuda(torch)
    eng = distributed.HybridEngine(cfg, sep=MOE_RING["sep"])
    params, _ = eng.init(seed=0)
    items = list(_flat_items(params))
    leaves = [t for _, t in items]
    for t in leaves:
        t.requires_grad_(True)
    tokens, labels = (torch.from_numpy(a).cuda() for a in hybrid_batch(
        cfg, *MOE_RING["check"]))
    route, routes, flips = moe.moe_route, [], [0, 0]

    def record(logits, **kw):
        r = route(logits, **kw)
        routes.append(r)
        return r

    def loss_grads(router):
        moe.moe_route = router
        try:
            loss = eng._local_loss(params, tokens, labels)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        finally:
            moe.moe_route = route

    zero_counts(fa)
    ra.launches["pair_bwd"] = 0
    kl, kg = loss_grads(record)
    kernel_launches = dict(fa.launches, pair_bwd=ra.launches["pair_bwd"])
    fwd, bwd = ra._pair_fwd, ra._pair_bwd

    def plain_bwd(q, k, v, do, lse, delta, scale, causal, dq, dk, dv):
        for acc, t in zip((dq, dk, dv), ra._pair_bwd_ref(
                q, k, v, do, lse, delta, scale, causal)):
            acc += t

    ra._pair_fwd = lambda q, k, v, s, c: ra._pair_fwd_ref(q, k, v, s, c)
    ra._pair_bwd = plain_bwd
    try:
        pl, pg = loss_grads(pinned_routes(torch, route, routes, flips))
    finally:
        ra._pair_fwd, ra._pair_bwd = fwd, bwd
    rel = abs(float(kl) - float(pl)) / abs(float(pl))
    errs = {k: float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for (k, _), a, b in zip(items, kg, pg)}
    worst = max(errs, key=errs.get)
    gerr = errs[worst]
    n_routes = len(routes)
    del kg, pg, eng, params, leaves, items, routes
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = distributed.HybridEngine(cfg, sep=MOE_RING["sep"])
    params, opt = eng.init(seed=0)
    B, S = MOE_RING["train"]
    batch = hybrid_batch(cfg, B, S)
    per_shard = []

    def spy(logits, **kw):
        r = route(logits, **kw)
        per_shard.append(r.keep)
        return r

    times, losses = [], []
    moe.moe_route = spy
    zero_counts(fa)
    ra.launches["pair_bwd"] = 0
    try:
        with eager_route(torch, eng):
            for i in range(HYBRID_STEPS):
                per_shard.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
                losses.append(float(loss))
                times.append(time.perf_counter() - t0)
    finally:
        moe.moe_route = route
    steps_launches = dict(fa.launches, pair_bwd=ra.launches["pair_bwd"])
    sep, L = MOE_RING["sep"], cfg.num_layers
    want = {n: k * L * HYBRID_STEPS for n, k in train_launches(sep).items()}
    # the first forward of each layer (the remat re-runs it) routes the
    # four shards in order
    drops = [[int((~k).sum()) for k in per_shard[l * sep:(l + 1) * sep]]
             for l in range(L)]
    ms = 1e3 * sum(times[1:]) / (HYBRID_STEPS - 1)
    print(f"[phase 22 (f)] MoE {MOE_EXPERTS} experts top-2 at 1.3B widths, "
          f"{L} layers, sep {sep} on the one-card ring: kernels vs plain at "
          f"{MOE_RING['check']}, bf16, the plain run routed as the kernel "
          f"run ({n_routes} routings): loss {float(kl):.5f} vs "
          f"{float(pl):.5f} ({rel:.2e} relative, limit "
          f"{MOE_RING_LOSS_REL:g}), grads within {gerr:.2e} of their "
          f"largest (worst {worst}; limit {MOE_RING_GRAD_REL:g}); the plain "
          f"run's own routes would differ for {flips[0]} of {flips[1]} "
          f"tokens; kernel launches of that forward+backward "
          f"{kernel_launches}; bf16 {B} x {S}: losses "
          f"{[round(x, 4) for x in losses]}, launches over the "
          f"{HYBRID_STEPS} steps {steps_launches}, {ms:.1f} ms/step (eager "
          f"route, host clock), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; dropped "
          f"(token, choice) pairs a layer by shard {drops}")
    check(kernel_launches["pair_bwd"] > 0,
          f"22 (f): no ring-pair launch in the check {kernel_launches}")
    check(rel <= MOE_RING_LOSS_REL and gerr <= MOE_RING_GRAD_REL,
          f"22 (f): kernels vs plain (bf16, routes pinned): loss "
          f"{float(kl)} vs {float(pl)}, grads off by {gerr:.3g} of their "
          f"largest at {worst}")
    check(steps_launches == want, f"22 (f): launches over the bf16 steps "
                                  f"{steps_launches}, expected {want}")
    check(losses[-1] < losses[0], f"22 (f): losses {losses} do not fall")
    return steps_launches


def child_hybrid_mlp(case, out):
    """22 (g), one rank: the ``bench_integrity`` MLP (hidden 1024, batch
    128, fp32, Momentum) through ``fleet.init(dp_degree=2)``,
    ``DataParallel`` and ``fleet.distributed_optimizer``; rank 0 also
    trains it alone on the whole batch."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective, env, fleet
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    prepare(torch)
    s = fleet.DistributedStrategy()
    s.hybrid_configs["dp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    rank, n = fleet.fleet.worker_index(), fleet.fleet.worker_num()
    paddle.set_device("gpu")
    wait_go()
    H, B = MLP_DP["hidden"], MLP_DP["batch"]
    rng = np.random.RandomState(0)
    x = rng.randn(B, H).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.int64)

    def mlp():
        paddle.seed(0)
        nn = paddle.nn
        return nn.Sequential(nn.Linear(H, H), nn.ReLU(), nn.Linear(H, H),
                             nn.ReLU(), nn.Linear(H, 10))

    def train(model, opt, xs, ys, sync=None):
        xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
        times = []
        for _ in range(MLP_DP["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = torch.nn.functional.cross_entropy(model(xs), ys)
            loss.backward()
            if sync:
                sync()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    torch.cuda.reset_peak_memory_stats()
    model = fleet.distributed_model(mlp())
    opt = fleet.distributed_optimizer(paddle.optimizer.Momentum(
        learning_rate=0.01, parameters=model.parameters()))
    b = B // n
    collective.reset_collective_stats()
    times = train(model, opt, x[rank * b:(rank + 1) * b],
                  y[rank * b:(rank + 1) * b], model.apply_collective_grads)
    params = [p.detach() for p in model.parameters()]
    res = {"rank": rank, "ms": 1e3 * sum(times[1:]) / (len(times) - 1),
           "peak": torch.cuda.max_memory_allocated(),
           "digest": tree_fingerprint({str(i): p for i, p in
                                       enumerate(params)}),
           # over every step, the first's gloo set-up included
           "collective_share": sum(collective.collective_stats()[
               "seconds"].values()) / sum(times),
           "transport": env.transport()}
    if rank == 0:
        alone = mlp()
        aopt = paddle.optimizer.Momentum(learning_rate=0.01,
                                         parameters=alone.parameters())
        train(alone, aopt, x, y)
        res["err_vs_one"] = max(float((a - b).abs().max()) for a, b in zip(
            params, alone.parameters()))
    res["tracker"] = tracker_on_rank()
    with open(f"{out}.r{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def hybrid_mlp(ranks):
    check(ranks[0]["digest"] == ranks[1]["digest"],
          "22 (g): the two ranks' params differ")
    check(ranks[0]["err_vs_one"] <= 1e-5,
          f"22 (g): params off the one-rank run by {ranks[0]['err_vs_one']}")
    print(f"[phase 22 (g)] MLP hidden {MLP_DP['hidden']}, batch "
          f"{MLP_DP['batch']}, fp32, Momentum, fleet dp 2 (DataParallel + "
          f"distributed_optimizer): params bitwise equal across the ranks, "
          f"within {ranks[0]['err_vs_one']:.2e} of one rank on the whole "
          f"batch after {MLP_DP['steps']} steps; ms/step "
          f"{[round(r['ms'], 3) for r in ranks]} (steps 2-3), collective "
          f"share over the 3 steps "
          f"{[round(r['collective_share'], 3) for r in ranks]}, "
          f"peak MiB {[round(r['peak'] / 2**20, 1) for r in ranks]}; "
          f"transport: {ranks[0]['transport']}")


def phase_hybrid(torch, fa, ra, cases="abcdefg"):
    """Phase 22: worlds of ranks on the one card (see the docstring).
    Returns the launches and (g)'s ranks' phase 26 (b) results (None
    without (g))."""
    free_cuda(torch)
    tmp = tempfile.mkdtemp(prefix="phase22_")
    launches, summary, tracker = {}, {}, None
    try:
        with contextlib.ExitStack() as stack:
            # (g)'s 2 ranks start beside (a)-(e)'s and wait for their turn
            mlp_go = os.path.join(tmp, "mlp_go")
            mlp = stack.enter_context(hybrid_world(
                "g", 2, tmp, child="hybrid_mlp",
                env={"PHASE22_GO": mlp_go})) if "g" in cases else None
            world = "".join(c for c in cases if c in HYBRID)
            if world:
                t0 = time.perf_counter()
                done, summary = hybrid_cases(torch, world, tmp)
                launches.update(done)
                print(f"[phase 22 ({world})] {time.perf_counter() - t0:.1f} s")
            if "f" in cases:
                t0 = time.perf_counter()
                launches["f"] = hybrid_moe_ring(torch, fa, ra)
                print(f"[phase 22 (f)] {time.perf_counter() - t0:.1f} s")
            if mlp is not None:
                t0 = time.perf_counter()
                open(mlp_go, "w").close()
                ranks = mlp()
                hybrid_mlp(ranks)
                tracker = [r["tracker"] for r in ranks]
                print(f"[phase 22 (g)] {time.perf_counter() - t0:.1f} s "
                      f"(its start-up beside (a)-(e))")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[phase 22] peak GiB a rank beside the one-process engine's: " +
          "; ".join(f"({c}) {v['peak_gib']} vs {v['one_process_gib']}"
                    for c, v in summary.items()))
    return launches, tracker


# ------------------------------------ the rest of the worlds (phase 23)

#: phase 23's training cases, each a grid over the one world of
#: ``HYBRID_RANKS`` ranks at GPT-3 1.3B's widths: (a) and (b) the
#: pipeline on all 24 layers (at 8 the embedding's state, not the
#: microbatches' activations, sets stage 0's peak, and (b)'s memory
#: check needs the latter), one microbatch a row of the global batch;
#: (c) and (d) ZeRO-3 cut to 8 layers (the depth keeps gloo's gathers of
#: whole layers within the phase's time)
WORLDS = {
    "a": dict(axes=dict(pp=4), layers=24, batch=(8, 2048),
              ec=dict(num_microbatches=8, pipeline_schedule="1f1b")),
    "b": dict(axes=dict(pp=4), layers=24, batch=(8, 2048),
              ec=dict(num_microbatches=8, pipeline_schedule="gpipe")),
    "c": dict(axes=dict(sharding=4), layers=8, batch=(4, 2048),
              ec=dict(zero_stage=3)),
    "d": dict(axes=dict(pp=2, sharding=2), layers=8, batch=(4, 2048),
              ec=dict(zero_stage=3, num_microbatches=2)),
}
WORLD_STEPS = 2                    # (a)-(d): 1 warm, 1 timed (cut from 3)
WORLD_TINY = dict(batch=(4, 512), micro={"a": 4, "b": 4, "d": 2})
#: (b): the peak of each schedule at 4 microbatches (global batch 4 x
#: 2048, the microbatch unchanged), one step each, beside 8's
WORLD_MEM_MICRO = 4
#: (f): (a)'s world cut to 4 layers, one a stage (8 until phase 25
#: joined the script; the save writes each rank's windows of the params
#: and the fp32 canonical optimizer state)
WORLD_CKPT = dict(layers=4, batch=(8, 2048),
                  ec=dict(num_microbatches=8, pipeline_schedule="1f1b"))
WORLD_SERVE_MP = (2, 4)            # (e)
#: (e)'s 1.3B depth: 4 of the 24 layers (cut from 24 when phase 24 joined
#: the script and from 8 when phase 25 did, to keep it inside its time
#: limit: two staged all-reduces a layer a step set (e)'s time)
WORLD_SERVE_LAYERS = 4
#: (e): the logits of an mp world against the one-process engine's on
#: the rows of the same history (every step), relative to the row's
#: largest logit: bf16 at 1.3B widths (the row products' partial sums
#: are rounded to bf16 before the all-reduce), fp32 at ``tiny``; a
#: control step with one rank's pages wrong must land above it
WORLD_LOGITS_REL = {"1.3b": 5e-2, "tiny": 1e-4}
WORLD_MLP = dict(hidden=1024, batch=128, steps=3, micro=4)    # (g)
#: (g)'s hapi world at GPT-3 1.3B widths: the Paddle-style GPT of
#: ``models/paddle_gpt.py`` cut to 4 layers (the phase's time), fp32,
#: ``rows`` x ``seq`` tokens (one row a dp rank), AdamW, ``steps`` steps
#: (the first untimed) at dp 2 x mp 2 with ``HAPI_GPT_RULES``, then one
#: ``eval_batch`` and one ``predict_batch``; against the one-process hapi
#: fit of the same model on the same rows (``HYBRID_LOSS_REL``)
WORLD_HAPI_GPT = dict(layers=4, rows=2, seq=512, steps=3, lr=1e-4)
HAPI_GPT_RULES = ((r"qkv\.weight$", (None, "mp")),
                  (r"up\.weight$", (None, "mp")),
                  (r"proj\.weight$", ("mp", None)),
                  (r"down\.weight$", ("mp", None)))
#: (a)-(d), (f): every step's loss and each leaf's step-1 gradient norm
#: against the one-process engine, relative: phase 22's limits (2e-4,
#: 3e-3) tightened to this phase's first readings (at most 8.8e-6 and
#: 2.6e-4) with a margin of four to six
WORLD_LOSS_REL = 5e-5
WORLD_GRAD_REL = 1e-3
WORLD_CASES = "abcdefg"
WORLD_DEVICE = "cuda"              # the oracles' device


def world_cfg(layers, tiny=False):
    from paddle_tpu_torch.models import GPT_CONFIGS

    if tiny:
        return dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32",
                                   max_seq_len=512)
    return dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"], num_layers=layers)


def world_serve_cfgs():
    """(e)'s two sizes: 1.3B widths at ``WORLD_SERVE_LAYERS`` in bf16, and
    ``tiny`` in fp32 (its positions long enough for the mix's 1056
    tokens)."""
    from paddle_tpu_torch.models import GPT_CONFIGS

    return {"1.3b": world_cfg(WORLD_SERVE_LAYERS),
            "tiny": dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32",
                                        max_seq_len=2048)}


def world_launches(case, coords, L):
    """Flash launches a step on the rank at ``coords`` by the schedule:
    remat "dots" re-runs each layer's forward in the backward; a 1F1B
    stage runs a microbatch's forward twice (its forward tick without a
    graph, then again at its backward tick) unless it is the last."""
    c = WORLDS[case]
    pp = c["axes"].get("pp", 1)
    Lr = L // pp
    if pp == 1:
        return {"fwd": 2 * Lr, "bwd": Lr}
    M = c["ec"]["num_microbatches"]
    last = coords["pp"] == pp - 1
    runs = 2 if (c["ec"].get("pipeline_schedule", "1f1b") == "gpipe"
                 or last) else 3
    return {"fwd": M * runs * Lr, "bwd": M * Lr}


def world_oracle(torch, layers, batch):
    """The one-process engine (eager) on ``layers`` of GPT-3 1.3B at the
    global ``batch``: each step's loss, each leaf's step-1 gradient norm
    and the peak."""
    from paddle_tpu_torch import distributed

    cfg = world_cfg(layers)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = distributed.HybridEngine(cfg, device=WORLD_DEVICE)
    params, opt = eng.init(seed=0)
    norms, losses = grad_norms(torch, eng), []
    tokens = hybrid_batch(cfg, *batch)
    with eager_route(torch, eng):
        for _ in range(WORLD_STEPS):
            params, opt, loss = eng.step(params, opt, *tokens, lr=1e-4)
            losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    del eng, params, opt
    free_cuda(torch)
    return {"losses": losses, "grad_norms": norms, "peak": peak}


def serve_oracle(torch, serving, cfg, path):
    """(e)'s one-process engine (its captured step) at ``cfg`` on phase
    4's mix: the tokens; every step's logits, row by row
    (``logits_log``), saved to ``path`` for the mp ranks to hold theirs
    against."""
    from paddle_tpu_torch.models import gpt_init

    params = gpt_init(cfg, torch.Generator(
        device=WORLD_DEVICE).manual_seed(0), device=WORLD_DEVICE)
    eng = serving.Engine(cfg, params, page_size=16, num_pages=2048,
                         max_batch_size=8, chunk_len=64,
                         device=WORLD_DEVICE)
    log = logits_log(eng)
    _, prompts = serving_prompts(cfg.vocab_size)
    reqs = serve_requests(eng, serving, prompts)
    rows = log["rows"]
    np.savez(path, keys=np.asarray(list(rows), np.int64),
             logits=np.stack([r[3] for r in rows.values()]))
    out = {"tokens": [r.output for r in reqs], "rows": len(rows)}
    del eng, params, log
    free_cuda(torch)
    return out


def logits_log(eng, control=None):
    """Every step's logits, row by row, keyed by the row's whole token
    history (its request's first ``context len`` tokens: their count and
    CRC32), so that two engines' rows with the same history pair up
    whatever tokens each sampled before: ``log["rows"]`` ``{key: (step,
    query len, context len, logits)}``.  ``control(run, args, live,
    clean)`` runs once, on the first step with a row that reads pages an
    earlier step wrote; what it returns lands in ``log["control"]``."""
    import zlib

    run, log = eng._run_step, {"rows": {}}

    def spy(tokens, rows, slots, qlens, ctxs, tables):
        logits = run(tokens, rows, slots, qlens, ctxs, tables)
        live = np.nonzero(qlens > 0)[0]
        clean = np.array(logits[live], copy=True)
        for n, i in enumerate(live):
            h = np.asarray(eng._slots[i].tokens[:ctxs[i]], np.int64)
            key = (len(h), zlib.crc32(h.tobytes()))
            log["rows"][key] = (eng.steps, int(qlens[i]), int(ctxs[i]),
                                clean[n])
        if control is not None and "control" not in log and \
                np.any(ctxs[live] > qlens[live]):
            log["control"] = control(
                run, (tokens, rows, slots, qlens, ctxs, tables), live,
                clean)
            logits[live] = clean
        return logits

    eng._run_step = spy
    return log


def logits_agreement(log, oracle_path):
    """The rows of ``log`` whose history the oracle's log holds too,
    each held against the oracle's row relative to that row's largest
    logit: the worst and the count, over all rows, step 1's, the rows
    that read pages of earlier steps, and the one-token rows."""
    z = np.load(oracle_path)
    idx = {tuple(k): n for n, k in enumerate(z["keys"].tolist())}
    want_all = z["logits"]
    worst = dict.fromkeys(("all", "step1", "later", "one_token"), 0.0)
    count = dict.fromkeys(worst, 0)
    for key, (step, q, ctx, got) in log["rows"].items():
        n = idx.get(key)
        if n is None:
            continue
        want = want_all[n]
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        for k, on in (("all", True), ("step1", step == 1),
                      ("later", ctx > q), ("one_token", q == 1)):
            if on:
                count[k] += 1
                worst[k] = max(worst[k], rel)
    return {"worst": worst, "count": count, "rows": len(log["rows"])}


def _timed_steps(torch, eng, params, opt, batch, steps, fa):
    """``steps`` engine steps, the launch counts and collectives reset
    after the first: (params, opt, losses, ms of the timed steps)."""
    from paddle_tpu_torch.distributed import collective

    losses, times = [], []
    for i in range(steps):
        if i == 1:
            zero_counts(fa)
            collective.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return params, opt, losses, 1e3 * sum(times[1:]) / max(1, steps - 1)


def _rank_stats(ms, timed=1):
    from paddle_tpu_torch.distributed import collective, env

    stats = collective.collective_stats()
    return {"collective_s": sum(stats["seconds"].values()) / timed,
            "bytes": {str(k): v / timed for k, v in stats["bytes"].items()},
            "staged": sum(stats["staged_bytes"].values()) / timed,
            "transport": env.transport(), "ms": ms}


def _train_world_case(torch, distributed, case, rank):
    """One rank's share of (a)-(d) at full width: the tiny fp32 check
    first, then ``WORLD_STEPS`` steps (the last timed) with the step-1
    gradient norms, and (b) the peaks at ``WORLD_MEM_MICRO``
    microbatches on both schedules, (c) the peak of the same grid at
    ZeRO-2."""
    from paddle_tpu_torch.distributed import EngineConfig
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.resilience.integrity import shard_fingerprint

    c = WORLDS[case]
    res = {"tiny": _tiny_world(torch, distributed, case, rank)}
    cfg = world_cfg(c["layers"])
    torch.cuda.synchronize()
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = distributed.HybridEngine(cfg, **c["axes"],
                                   engine_cfg=EngineConfig(**c["ec"]))
    params, opt = eng.init(seed=0)
    batch = hybrid_batch(cfg, *c["batch"])
    norms = grad_norms(torch, eng)
    params, opt, losses, ms = _timed_steps(torch, eng, params, opt, batch,
                                           WORLD_STEPS, fa)
    res.update(_rank_stats(ms), rank=rank, coords=eng.coords,
               losses=losses, grad_norms=norms,
               peak=torch.cuda.max_memory_allocated(),
               launches={"fwd": fa.launches["fwd"],
                         "bwd": fa.launches["bwd"]},
               live_peak=getattr(eng, "pipeline_stats", {}).get(
                   "live_peak"),
               digest=shard_fingerprint(eng.shard_views(params)))
    del eng, params, opt
    free_cuda(torch)
    extra = []
    if case == "b":
        # each schedule's peak at half the microbatches of the same size
        for sched in ("1f1b", "gpipe"):
            extra.append((f"peak_{sched}_{WORLD_MEM_MICRO}", dict(
                c["ec"], num_microbatches=WORLD_MEM_MICRO,
                pipeline_schedule=sched), (WORLD_MEM_MICRO, c["batch"][1])))
    if case == "c":
        extra.append(("peak_zero2", dict(zero_stage=2), c["batch"]))
    for key, ec, shape in extra:
        torch.cuda.reset_peak_memory_stats()
        eng = distributed.HybridEngine(cfg, **c["axes"],
                                       engine_cfg=EngineConfig(**ec))
        params, opt = eng.init(seed=0)
        eng.step(params, opt, *hybrid_batch(cfg, *shape), lr=1e-4)
        torch.cuda.synchronize()
        res[key] = torch.cuda.max_memory_allocated()
        del eng, params, opt
        free_cuda(torch)
    return res


def _tiny_world(torch, distributed, case, rank):
    """Case ``case``'s grid at tiny widths in fp32 (TF32 off) against the
    one-rank engine (rank 0 runs it): 3 steps from the same params, the
    world's gathered params at the end."""
    from paddle_tpu_torch.distributed import EngineConfig, env
    from paddle_tpu_torch.models import params_to_numpy

    cfg = world_cfg(0, tiny=True)
    batch = hybrid_batch(cfg, *WORLD_TINY["batch"], seed=5)
    one = None
    if rank == 0:
        eng = distributed.HybridEngine(cfg, device=env.current_device())
        p, o = eng.init(seed=0)
        losses = []
        for _ in range(3):
            p, o, loss = eng.step(p, o, *batch, lr=1e-3)
            losses.append(float(loss))
        one = (losses, params_to_numpy(p))
    ec = dict(WORLDS[case]["ec"])
    if "num_microbatches" in ec:
        ec["num_microbatches"] = WORLD_TINY["micro"][case]
    eng = distributed.HybridEngine(cfg, **WORLDS[case]["axes"],
                                   engine_cfg=EngineConfig(**ec))
    p, o = eng.init(seed=0)
    losses = []
    for _ in range(3):
        p, o, loss = eng.step(p, o, *batch, lr=1e-3)
        losses.append(float(loss))
    full = params_to_numpy(eng.gather_params(p))
    if one is None:
        return None
    got, want = dict(_flat_np(full)), dict(_flat_np(one[1]))
    err = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
    dl = max(abs(a - b) - 1e-4 * abs(b) for a, b in zip(losses, one[0]))
    return {"losses": losses, "one_rank": one[0], "loss_excess": dl,
            "param_err": err}


def _flat_np(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_np(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _ckpt_world_case(torch, distributed, tmp, rank):
    """(f): (a)'s pp = 4 1F1B world at ``WORLD_CKPT``'s depth, 2 steps,
    ``save_engine_state`` (each rank its windows), the uninterrupted
    step 3; a dp 2 x mp 2 engine loads and takes step 3; a fresh pp = 4
    engine loads and takes step 3 (bitwise); then one bit flipped in
    rank 1's shard of the dp 2 x mp 2 engine: with two holders of the
    window, both are named and nothing is copied."""
    from paddle_tpu_torch.distributed import EngineConfig, checkpoint
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.resilience import integrity

    cfg = world_cfg(WORLD_CKPT["layers"])
    batch = hybrid_batch(cfg, *WORLD_CKPT["batch"])
    path = os.path.join(tmp, "ckpt")
    res = {}

    def engine(axes, ec):
        return distributed.HybridEngine(cfg, **axes,
                                        engine_cfg=EngineConfig(**ec))

    free_cuda(torch)
    eng = engine(dict(pp=4), WORLD_CKPT["ec"])
    params, opt = eng.init(seed=0)
    params, opt, _, _ = _timed_steps(torch, eng, params, opt, batch, 2, fa)
    collective.barrier()
    t0 = time.perf_counter()
    checkpoint.save_engine_state(path, eng, params, opt)
    collective.barrier()
    res["save_s"] = time.perf_counter() - t0
    with open(os.path.join(path, f"manifest.{rank}.json")) as f:
        res["windows"] = {l["path"]: [s["index"] for s in l["shards"]]
                          for l in json.load(f)["leaves"]}
    norms = grad_norms(torch, eng)
    params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
    res.update(loss=float(loss), grad_norms=norms,
               digest=integrity.shard_fingerprint(eng.shard_views(params)))
    del eng, params, opt
    free_cuda(torch)
    for key, axes, ec in (("dpmp", dict(dp=2, mp=2), {}),
                          ("pp4", dict(pp=4), WORLD_CKPT["ec"])):
        eng = engine(axes, ec)
        t0 = time.perf_counter()
        params, opt = checkpoint.load_engine_state(path, eng)
        collective.barrier()
        load_s = time.perf_counter() - t0
        norms = grad_norms(torch, eng)
        params, opt, loss = eng.step(params, opt, *batch, lr=1e-4)
        res[key] = {"loss": float(loss), "grad_norms": norms,
                    "load_s": load_s, "step0": opt["step"] - 1,
                    "digest": integrity.shard_fingerprint(
                        eng.shard_views(params))}
        if key == "dpmp":
            # ranks 1 and 3 hold the same window: a flip on the lower one
            # leaves no majority, so both are named and nothing is copied
            views = eng.shard_views(params)
            if rank == 1:
                bits = params["blocks"]["qkv_w"].detach().view(-1).view(
                    torch.int16)
                bits[12345] ^= 1 << 9
            before, _ = integrity.cross_rank_windows(views)
            repaired = integrity.repair_windows(views, before)
            after, _ = integrity.cross_rank_windows(views)
            res[key].update(flip_before=before, repaired=repaired,
                            flip_after=after,
                            flip_digest=integrity.shard_fingerprint(views))
        del eng, params, opt
        free_cuda(torch)
    return res


def wrong_pages_control(eng, pa, wrong, extra):
    """``logits_log``'s control: the step again with this rank's
    attention reading each row's pages through the next row's page table
    where ``wrong`` (the last mp rank), then clean once more, which
    rewrites this step's pages as they were.  The two runs' steps and
    launches add to ``extra`` (they are not the main path's).  Returns
    the wrong run's and the clean rerun's distance from the step, each
    relative to the row's largest logit."""

    def control(run, args, live, clean):
        real = pa.ragged_paged_attention
        n0 = real.launches

        def wrong_tables(q, kp, vp, tables, *a, **k):
            return real(q, kp, vp, tables.roll(1, dims=0), *a, **k)

        # the kernel's wrapper counts on the module's name: the count
        # runs on while the name is the wrong one, and goes back after
        wrong_tables.launches = real.launches
        if wrong:
            pa.ragged_paged_attention = wrong_tables
        try:
            bad = np.array(run(*args)[live], copy=True)
        finally:
            if wrong:
                real.launches = wrong_tables.launches
            pa.ragged_paged_attention = real
        again = np.array(run(*args)[live], copy=True)
        extra["steps"] += 2
        extra["launches"] += real.launches - n0
        scale = np.abs(clean).max(axis=1)
        return {"rel": float((np.abs(bad - clean).max(axis=1)
                              / scale).max()),
                "restored": float((np.abs(again - clean).max(axis=1)
                                   / scale).max()),
                "bitwise": bool(np.array_equal(again, clean)),
                "step": eng.steps - 2}

    return control


def _serve_world_case(torch, rank):
    """(e): ``Engine(mesh=build_mesh(mp=k))`` for each k of
    ``WORLD_SERVE_MP`` on phase 4's mix (ranks past k only make the
    mesh's groups), at 1.3B widths in bf16 and at ``tiny`` in fp32: the
    tokens, every step's logits held against the oracle's rows of the
    same history (rank 0), a control step with one rank's pages
    deliberately wrong, the ragged launches, tok/s, TTFT and the
    collectives' share."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import gpt_init

    out = {}
    for size, cfg in world_serve_cfgs().items():
        _, prompts = serving_prompts(cfg.vocab_size)
        for mp in WORLD_SERVE_MP:
            mesh = mesh_mod.build_mesh(mp=mp)
            if rank >= mp:
                continue
            free_cuda(torch)
            torch.cuda.reset_peak_memory_stats()
            dev = env.current_device()
            params = gpt_init(cfg, torch.Generator(device=dev).manual_seed(
                0), device=dev)
            eng = serving.Engine(cfg, params, page_size=16, num_pages=2048,
                                 max_batch_size=8, chunk_len=64, mesh=mesh)
            del params
            extra = {"steps": 0, "launches": 0}
            log = logits_log(eng, wrong_pages_control(
                eng, pa, rank == mp - 1, extra))
            pa.ragged_paged_attention.launches = 0
            collective.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = serve_requests(eng, serving, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            snap = eng.metrics.snapshot()
            stats = collective.collective_stats()
            out[f"{size}/{mp}"] = {
                "tokens": [r.output for r in reqs],
                "steps": eng.steps - extra["steps"],
                "launches": pa.ragged_paged_attention.launches
                - extra["launches"],
                "pool": list(eng.cache.k_pages.shape),
                "wall": wall, "ttft": snap["ttft_s"],
                "gen": sum(len(r.output) for r in reqs),
                "collective_s": sum(stats["seconds"].values()),
                "peak": torch.cuda.max_memory_allocated(),
                "finished": all(r.state == serving.RequestState.FINISHED
                                for r in reqs),
                "control": log.get("control"),
                "logits": logits_agreement(log, os.path.join(
                    os.environ["PHASE23_TMP"], f"e_oracle_{size}.npz"))
                if rank == 0 else None}
            del eng, log
            free_cuda(torch)
    return out


def _mlp_world_case(torch, rank, store_port):
    """(g): the sentinel's MLP (hidden 1024, batch 128, fp32) through
    ``hapi.Model.prepare(device_mesh="auto")`` on the 4 ranks (then a bit
    flipped on rank 1, named and repaired from the majority), and over
    dp 2 x mp 2 with a column-row pair of split linears, a 4-stage
    ``PipelineLayer`` of the same MLP through ``fleet.distributed_model``,
    and ``PipelineStageExecutor`` on ranks 0 and 1 over a ``TCPStore``;
    rank 0 runs each one-process reference."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet_executor import (
        MessageBus, PipelineStageExecutor)
    from paddle_tpu_torch.distributed.pp_layers import (LayerDesc,
                                                        PipelineEngine,
                                                        PipelineLayer)
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.distributed.mesh import P, build_mesh
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.resilience import integrity
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    paddle.set_device("gpu")
    H, B, steps = WORLD_MLP["hidden"], WORLD_MLP["batch"], WORLD_MLP["steps"]
    nn = paddle.nn
    rng = np.random.RandomState(0)
    x = rng.randn(B, H).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.int64)

    def layers():
        return [nn.Linear(H, H), nn.ReLU(), nn.Linear(H, H), nn.ReLU(),
                nn.Linear(H, 10)]

    def hapi_fit(mesh, rules=()):
        paddle.seed(0)
        net = nn.Sequential(*layers())
        model = Model(net)
        model.prepare(paddle.optimizer.Momentum(
            learning_rate=0.01, parameters=net.parameters()),
            nn.CrossEntropyLoss(), device_mesh=mesh, sharding_rules=rules)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.train_batch(x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # between steps a split parameter holds this rank's window: the
        # whole ones are gathered (a parameter held whole stays the live
        # tensor, which (g)'s flip writes into)
        with model.whole_parameters():
            params = [p.detach() for p in net.parameters()]
        return params, times, model

    res = {"rank": rank}
    collective.reset_collective_stats()
    params, times, model = hapi_fit("auto")
    res["hapi"] = {"digest": tree_fingerprint(
        {str(i): p for i, p in enumerate(params)}),
        "ms": 1e3 * sum(times[1:]) / (steps - 1),
        "collective_share": sum(collective.collective_stats()[
            "seconds"].values()) / sum(times)}
    # four replicas of every window: a bit flipped on rank 1 is named
    # beside the majority {0, 2, 3} and copied back from rank 0
    views = model.shard_views()
    if rank == 1:
        params[0].view(-1).view(torch.int32)[777] ^= 1 << 20
    before, _ = integrity.cross_rank_windows(views)
    repaired = integrity.repair_windows(views, before)
    after, _ = integrity.cross_rank_windows(views)
    res["hapi"]["flip"] = {
        "before": before, "repaired": repaired, "after": after,
        "digest": tree_fingerprint({str(i): p
                                    for i, p in enumerate(params)})}
    # dp 2 x mp 2, the first weight split by columns and the second by
    # rows: the products of both run split over mp
    pair = [(r"^0\.weight$", P(None, "mp")), (r"^2\.weight$", P("mp", None))]
    tp, _, tmodel = hapi_fit(build_mesh(dp=2, mp=2), pair)
    res["hapi_mp"] = {"digest": tree_fingerprint(
        {str(i): p for i, p in enumerate(tp)}),
        "split": sorted(kind for kind, _, _ in tmodel._tp.values())}
    if rank == 0:
        alone, _, _ = hapi_fit(None)
        res["hapi"]["err_vs_one"] = max(float((a - b).abs().max())
                                        for a, b in zip(params, alone))
        res["hapi_mp"]["err_vs_one"] = max(float((a - b).abs().max())
                                           for a, b in zip(tp, alone))
    # the 4-stage pipeline through fleet, from the same weights
    paddle.seed(1)
    state = [{k: v.detach().cpu().numpy() for k, v in l.named_parameters()}
             for l in layers()]
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = 4
    s.pipeline_configs["accumulate_steps"] = WORLD_MLP["micro"]
    fleet.init(is_collective=True, strategy=s)
    descs = [LayerDesc(nn.Linear, H, H), LayerDesc(nn.ReLU),
             LayerDesc(nn.Linear, H, H), LayerDesc(nn.ReLU),
             LayerDesc(nn.Linear, H, 10)]
    eng = fleet.distributed_model(PipelineLayer(
        descs, loss_fn=nn.CrossEntropyLoss(),
        topology=fleet.get_hybrid_communicate_group()))
    eng.load_state(state)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, l = eng.train_batch(x, y, lr=0.01)
        losses.append(float(l))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the sequential layer list in this process, from the same weights
    one = PipelineEngine(PipelineLayer(descs, num_stages=1,
                                       loss_fn=nn.CrossEntropyLoss()),
                         num_microbatches=WORLD_MLP["micro"])
    one.load_state(state)
    want = [float(one.train_batch(x, y, lr=0.01)[1]) for _ in range(steps)]
    ref_state = one.state()
    res["pipeline"] = {
        "losses": losses, "one": want, "type": type(eng).__name__,
        "ms": 1e3 * sum(times[1:]) / (steps - 1),
        "param_err": max([float((v - ref_state[i][k]).abs().max())
                          for i, d in enumerate(eng.state())
                          for k, v in d.items()] or [0.0])}
    # the host-actor pipeline on ranks 0 and 1 over the store
    if rank <= 1:
        store = TCPStore("127.0.0.1", store_port, is_master=rank == 0,
                         world_size=2)
        bus = MessageBus(store)
        g = np.random.RandomState(3)
        w0 = torch.from_numpy((g.randn(H, H) * 0.02).astype(np.float32))
        w1 = torch.from_numpy((g.randn(H, 1) * 0.02).astype(np.float32))
        data = [torch.from_numpy(g.randn(32, H).astype(np.float32))
                for _ in range(4)]
        target = [torch.from_numpy(g.randn(32, 1).astype(np.float32))
                  for _ in range(4)]

        def stage0(p, xx):
            return torch.tanh(xx @ p[0])

        def loss_fn(p, xx, yy):
            return ((xx @ p[0] - yy) ** 2).mean()

        if rank == 0:
            ex = PipelineStageExecutor(stage0, [w0.cuda().clone()], 0, 2,
                                       bus, lr=0.05)
            for _ in range(steps):
                ex.train_batch(data)
            # the same two stages in this process
            a = w0.cuda().clone().requires_grad_(True)
            b = w1.cuda().clone().requires_grad_(True)
            per = []
            for _ in range(steps):
                ga, gb, ls = 0, 0, []
                for d, t in zip(data, target):
                    l = loss_fn([b], stage0([a], d.cuda()), t.cuda())
                    da, db = torch.autograd.grad(l, [a, b])
                    ga, gb = ga + da / 4, gb + db / 4
                    ls.append(float(l))
                with torch.no_grad():
                    a -= 0.05 * ga
                    b -= 0.05 * gb
                per.append(float(np.mean(ls)))
            res["executor"] = {"one": per, "w0_err": float(
                (ex.params[0] - a).abs().max())}
        else:
            ex = PipelineStageExecutor(None, [w1.cuda().clone()], 1, 2,
                                       bus, loss_fn=loss_fn, lr=0.05)
            losses, times = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                losses.append(ex.train_batch(None, labels=target))
                times.append(time.perf_counter() - t0)
            res["executor"] = {"losses": losses, "ms": 1e3 * sum(
                times[1:]) / (steps - 1)}
    return res


def hapi_gpt_fit(torch, mesh, tmp, tag):
    """(g)'s hapi fit of the Paddle-style GPT (``WORLD_HAPI_GPT``) on the
    card, in one process (``mesh`` None: the captured step) or on this
    rank of a dp 2 x mp 2 world: each step's loss, ms (host clock to a
    synchronize), peak ``max_memory_allocated`` and flash launches; the
    parameter and gradient bytes inside the step and the peak at the end
    of the backward, before the update (hooks on the network's forward
    and on each parameter's gradient; a captured step's replays run no
    hook, and their graph's pool is not allocated anew, so a replay's
    peak is the state it holds between steps); the collectives'
    seconds; the eval loss and the flash launches of ``eval_batch`` and
    ``predict_batch``.  Every ``PRED_STRIDE``-th position of the
    predictions goes to ``tmp/g_<tag>.npz``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.mesh import P
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init
    from paddle_tpu_torch.models import paddle_gpt as prog

    g = WORLD_HAPI_GPT
    cfg = dataclasses.replace(GPT_CONFIGS["gpt3-1.3b"],
                              num_layers=g["layers"], dtype="float32")
    paddle.set_device("gpu")
    free_cuda(torch)
    net = prog.build_gpt(paddle, cfg.vocab_size, cfg.hidden, cfg.num_heads,
                         cfg.ffn_hidden, cfg.num_layers, cfg.max_seq_len)
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(22),
                      device="cuda")
    net.set_state_dict(prog.gpt_state_from_params(params, cfg.num_layers))
    del params
    tokens = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (g["rows"], g["seq"])).astype(np.int64)
    labels = prog.next_token_labels(tokens)
    whole = sum(p.numel() * p.element_size() for p in net.parameters())
    seen = {}

    def at_forward(module, args):
        seen["params"] = sum(p.numel() * p.element_size()
                             for p in module.parameters())

    def at_grad(grad):
        seen["grads"] = seen.get("grads", 0) + grad.numel() * \
            grad.element_size()
        seen["backward_peak"] = torch.cuda.max_memory_allocated()

    net.register_forward_pre_hook(at_forward)
    for p in net.parameters():
        p.register_hook(at_grad)

    def loss(out, y):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(out, [-1, cfg.vocab_size]),
            paddle.reshape(y, [-1]), ignore_index=-100)

    model = Model(net)
    model.prepare(paddle.optimizer.AdamW(learning_rate=g["lr"],
                                         weight_decay=0.01,
                                         parameters=net.parameters()),
                  loss, device_mesh=mesh,
                  sharding_rules=[(pat, P(*spec))
                                  for pat, spec in HAPI_GPT_RULES])
    res = {"losses": [], "ms": [], "peak": [], "launches": [],
           "collective_s": [], "whole": whole, "step_params": [],
           "step_grads": [], "backward_peak": []}
    for _ in range(g["steps"]):
        seen.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa)
        collective.reset_collective_stats()
        t0 = time.perf_counter()
        res["losses"].append(model.train_batch(tokens, labels)[0])
        torch.cuda.synchronize()
        res["ms"].append(1e3 * (time.perf_counter() - t0))
        res["peak"].append(torch.cuda.max_memory_allocated())
        res["launches"].append(dict(fa.launches))
        res["collective_s"].append(sum(collective.collective_stats()[
            "seconds"].values()))
        for k in ("step_params", "step_grads", "backward_peak"):
            res[k].append(seen.get(k.replace("step_", "")))
    res["held"] = model.param_bytes()
    zero_counts(fa)
    res["eval"] = model.eval_batch(tokens, labels)[0]
    res["eval_launches"] = dict(fa.launches)
    zero_counts(fa)
    pred = model.predict_batch(tokens)
    res["predict_launches"] = dict(fa.launches)
    res["predict_shape"] = list(pred.shape)
    if tmp is not None:
        np.savez(os.path.join(tmp, f"g_{tag}.npz"),
                 logits=pred[:, ::PRED_STRIDE])
    del model, net, pred
    free_cuda(torch)
    return res


#: (g): the predictions compared at every 64th position of each row
PRED_STRIDE = 64


def child_worlds(cases, out):
    """``chip_smoke.py --child worlds CASES OUT``, one rank of phase 23's
    world: once the oracles are done, each case of CASES in turn;
    writes ``OUT.r<rank>.json``."""
    import torch

    from paddle_tpu_torch import distributed

    distributed.init_parallel_env()
    rank = distributed.get_rank()
    prepare(torch)
    stamps = {"ready": time.time()}
    wait_go()
    stamps["go"] = time.time()
    res, seconds = {}, {}
    tmp = os.environ["PHASE23_TMP"]
    for case in cases:
        t0 = time.time()
        if case in WORLDS:
            res[case] = _train_world_case(torch, distributed, case, rank)
        elif case == "e":
            res[case] = {str(k): v for k, v in
                         _serve_world_case(torch, rank).items()}
        elif case == "f":
            res[case] = _ckpt_world_case(torch, distributed, tmp, rank)
        elif case == "g":
            res[case] = _mlp_world_case(
                torch, rank, int(os.environ["PHASE23_STORE_PORT"]))
            from paddle_tpu_torch.distributed.mesh import build_mesh

            res[case]["gpt"] = hapi_gpt_fit(
                torch, build_mesh(dp=2, mp=2), tmp if rank == 0 else None,
                "world")
        seconds[case] = time.time() - t0
    with open(f"{out}.r{rank}.json", "w") as f:
        json.dump({"cases": res, "stamps": stamps, "seconds": seconds}, f,
                  default=_jsonable)
    return 0


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return str(x)


def world_train_case(case, ranks, oracle):
    """The checks and the line of one of (a)-(d)."""
    from paddle_tpu_torch.resilience.integrity import compare_windows

    c = WORLDS[case]
    L = c["layers"]
    r0 = ranks[0]
    steps, worst, gerr = hybrid_readings(ranks, oracle)
    tiny = r0["tiny"]
    print(f"[phase 23 ({case})] {c['axes']} {c['ec']}, {L} layers, global "
          f"batch {c['batch'][0]} x {c['batch'][1]}: losses "
          f"{[round(x, 5) for x in r0['losses']]} (one process "
          f"{[round(x, 5) for x in oracle['losses']]}; relative "
          f"differences by step {[f'{x:.2e}' for x in steps]}, limit "
          f"{WORLD_LOSS_REL:g}); step-1 gradient norms: worst leaf {worst}"
          f" ({gerr:.2e} relative, limit {WORLD_GRAD_REL:g}); ms/step "
          f"{[round(r['ms'], 1) for r in ranks]} (host clock, "
          f"{WORLD_STEPS - 1} timed); peak GiB a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} (one process "
          f"{oracle['peak'] / 2**30:.2f}); saved stage inputs at most "
          f"{[r['live_peak'] for r in ranks]}; collective share "
          f"{[round(r['collective_s'] * 1e3 / r['ms'], 3) for r in ranks]};"
          f" MB a step by axis (rank 0) "
          f"{ {k: round(v / 2**20, 1) for k, v in r0['bytes'].items()} },"
          f" staged {r0['staged'] / 2**20:.1f} MB; flash launches a rank a "
          f"step {[r['launches'] for r in ranks]}; tiny fp32: loss excess "
          f"{tiny['loss_excess']:.2e}, params {tiny['param_err']:.2e}; "
          f"transport: {r0['transport']}")
    check(tiny["loss_excess"] <= 2e-4 and tiny["param_err"] <= 1e-4,
          f"23 ({case}) tiny fp32: losses {tiny['losses']} vs the one-rank "
          f"{tiny['one_rank']}, params off by {tiny['param_err']}")
    check(max(steps) <= WORLD_LOSS_REL,
          f"23 ({case}): losses off the one-process engine's by {steps}")
    check(gerr <= WORLD_GRAD_REL,
          f"23 ({case}): the step-1 gradient norm of {worst} off the "
          f"one-process engine's by {gerr:.3g}")
    for r in ranks:
        check(r["losses"][-1] < r["losses"][0],
              f"23 ({case}): losses {r['losses']} do not fall")
        want = world_launches(case, r["coords"], L)
        check(r["launches"] == want,
              f"23 ({case}) rank {r['rank']}: flash launches a step "
              f"{r['launches']}, expected {want}")
    diverged = compare_windows({r["rank"]: r["digest"] for r in ranks})
    check(not diverged, f"23 ({case}): replicas differ at {diverged[:3]}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ("fwd", "bwd")}


def world_memory(res, oracles):
    """(b): 1F1B's peak flat in the microbatches and GPipe's growing;
    (c): ZeRO-3's peak below ZeRO-2's."""
    a, b = res.get("a"), res.get("b")
    if a and b:
        m = WORLD_MEM_MICRO
        f8 = [r["peak"] for r in a]
        g8 = [r["peak"] for r in b]
        f4 = [r[f"peak_1f1b_{m}"] for r in b]
        g4 = [r[f"peak_gpipe_{m}"] for r in b]
        print(f"[phase 23 (b)] peak GiB a rank, 1F1B at {m} and 8 "
              f"microbatches {[round(x / 2**30, 2) for x in f4]} -> "
              f"{[round(x / 2**30, 2) for x in f8]}; GPipe "
              f"{[round(x / 2**30, 2) for x in g4]} -> "
              f"{[round(x / 2**30, 2) for x in g8]}")
        # stage 0 holds the most in flight on both schedules
        check(f8[0] < 1.1 * f4[0], f"23 (b): 1F1B's stage-0 peak grew "
                                   f"from {f4[0]} to {f8[0]}")
        check(g8[0] > f8[0] and g8[0] - g4[0] > 2 * (f8[0] - f4[0]),
              f"23 (b): GPipe's peak {g4[0]} -> {g8[0]} does not grow past "
              f"1F1B's {f4[0]} -> {f8[0]}")
    c = res.get("c")
    if c:
        z3 = [r["peak"] for r in c]
        z2 = [r["peak_zero2"] for r in c]
        print(f"[phase 23 (c)] peak GiB a rank at sharding 4: ZeRO-3 "
              f"{[round(x / 2**30, 2) for x in z3]}, ZeRO-2 "
              f"{[round(x / 2**30, 2) for x in z2]} (one process "
              f"{oracles['c']['peak'] / 2**30:.2f})")
        check(max(z3) < min(z2), f"23 (c): ZeRO-3's peaks {z3} not below "
                                 f"ZeRO-2's {z2}")


def world_ckpt(ranks, tmp):
    """(f)'s checks and line."""
    f = ranks
    union = {}
    for r in f:
        for path, wins in r["windows"].items():
            union.setdefault(path, []).extend(wins)
    import glob

    manifests = glob.glob(os.path.join(tmp, "ckpt", "manifest.*.json"))
    shapes = {}
    for m in manifests:
        with open(m) as fh:
            for leaf in json.load(fh)["leaves"]:
                shapes[leaf["path"]] = leaf["shape"]
    for path, wins in union.items():
        cover = np.zeros(shapes[path], np.int8)
        for w in wins:
            cover[tuple(slice(a, b) for a, b in w)] += 1
        check((cover == 1).all(), f"23 (f): {path}'s windows are not each "
                                  f"written once")
    base = f[0]
    dpmp = [r["dpmp"] for r in f]
    rel = max(abs(d["loss"] - base["loss"]) / abs(base["loss"])
              for d in dpmp)
    got, want = dpmp[0]["grad_norms"], base["grad_norms"]
    worst = max(want, key=lambda k: abs(got[k] - want[k]) / want[k])
    gerr = abs(got[worst] - want[worst]) / want[worst]
    bitwise = all(r["pp4"]["loss"] == r["loss"] and r["pp4"]["digest"]
                  == r["digest"] for r in f)
    flip = dpmp[0]["flip_before"]
    print(f"[phase 23 (f)] pp 4 1F1B, {WORLD_CKPT['layers']} layers, saved "
          f"after step 2 in {max(r['save_s'] for r in f):.1f} s "
          f"({len(union)} leaves, {sum(len(w) for w in union.values())} "
          f"windows, each written once); dp 2 x mp 2 loads in "
          f"{max(d['load_s'] for d in dpmp):.1f} s, step 3 loss "
          f"{dpmp[0]['loss']:.6f} vs {base['loss']:.6f} uninterrupted "
          f"({rel:.2e} relative), worst step-3 gradient norm {worst} "
          f"{gerr:.2e}; pp 4 resume bitwise: {bitwise}; bit flipped on "
          f"rank 1 (its window's replica on rank 3): named {flip}, "
          f"copied {[d['repaired'] for d in dpmp]}, after "
          f"{dpmp[0]['flip_after']}")
    check(all(d["step0"] == 2 for d in dpmp), "23 (f): not resumed at 2")
    check(rel <= WORLD_LOSS_REL and gerr <= WORLD_GRAD_REL,
          f"23 (f): the dp 2 x mp 2 resume off the uninterrupted step 3 by "
          f"{rel:.3g} (loss), {gerr:.3g} (gradient norm of {worst})")
    check(bitwise, "23 (f): the pp 4 resume is not bitwise")
    check([(d["rank"], d["leaf"], d["majority_ranks"]) for d in flip]
          == [(1, "blocks/qkv_w", []), (3, "blocks/qkv_w", [])],
          f"23 (f): the flipped bit was named as {flip}")
    check(all(d["repaired"] == [] and d["flip_after"] == flip
              for d in dpmp), "23 (f): a window without a majority was "
                              "copied")
    check(dpmp[3]["flip_digest"] == dpmp[3]["digest"],
          "23 (f): the healthy replica on rank 3 changed")


def world_serve(ranks, oracles):
    """(e)'s checks and lines."""
    launches = {}
    for size, cfg in world_serve_cfgs().items():
        oracle, limit = oracles[size], WORLD_LOGITS_REL[size]
        for mp in WORLD_SERVE_MP:
            rs = [r["e"][f"{size}/{mp}"] for r in ranks[:mp]]
            toks = rs[0]["tokens"]
            check(all(r["tokens"] == toks for r in rs),
                  f"23 (e) {size} mp {mp}: the ranks returned different "
                  f"tokens")
            check(all(r["finished"] for r in rs),
                  f"23 (e) {size} mp {mp}: a request did not finish")
            for r in rs:
                check(r["launches"] == cfg.num_layers * r["steps"],
                      f"23 (e) {size} mp {mp}: ragged launches "
                      f"{r['launches']} != {cfg.num_layers} x {r['steps']} "
                      f"steps")
                check(r["pool"][3] == cfg.num_heads // mp,
                      f"23 (e): pool {r['pool']}")
            agree, ctl = rs[0]["logits"], rs[0]["control"]
            worst, count = agree["worst"], agree["count"]
            same = sum(x == y for o, w in zip(toks, oracle["tokens"])
                       for x, y in zip(o, w))
            total = sum(len(w) for w in oracle["tokens"])
            ttft = rs[0]["ttft"]
            print(f"[phase 23 (e)] Engine(mesh=) {size} ({cfg.dtype}) at mp "
                  f"{mp}: {len(toks)} requests, {rs[0]['steps']} steps, "
                  f"{rs[0]['gen'] / rs[0]['wall']:.1f} generated tok/s, "
                  f"TTFT p50 {ttft['p50'] * 1e3:.1f} ms p95 "
                  f"{ttft['p95'] * 1e3:.1f} ms; logits of the rows whose "
                  f"history the one-process engine also ran, relative to "
                  f"the row's largest (limit {limit:g}): {count['all']} of "
                  f"{agree['rows']} rows, worst {worst['all']:.2e}; step 1 "
                  f"{count['step1']} rows {worst['step1']:.2e}; reading "
                  f"earlier steps' pages {count['later']} rows "
                  f"{worst['later']:.2e}; one-token rows "
                  f"{count['one_token']} {worst['one_token']:.2e}; control "
                  f"(step {ctl['step']}, mp rank {mp - 1} reading the next "
                  f"row's pages): {ctl['rel']:.2e}, its clean rerun "
                  f"{ctl['restored']:.2e} (bitwise {ctl['bitwise']}); greedy "
                  f"tokens equal to its {same}/{total}; tokens equal across "
                  f"the ranks; collective share "
                  f"{[round(r['collective_s'] / r['wall'], 3) for r in rs]}"
                  f"; ragged launches a rank {[r['launches'] for r in rs]}; "
                  f"pool a rank {rs[0]['pool']}; peak GiB "
                  f"{[round(r['peak'] / 2**30, 2) for r in rs]}")
            check(worst["all"] <= limit,
                  f"23 (e) {size} mp {mp}: logits off by {worst} of the "
                  f"largest")
            check(count["later"] > 0 and count["one_token"] > 0,
                  f"23 (e) {size} mp {mp}: no row past step 1 held "
                  f"({count})")
            check(ctl["rel"] > limit,
                  f"23 (e) {size} mp {mp}: one rank reading wrong pages "
                  f"moved the logits by only {ctl['rel']:.3g}, inside the "
                  f"limit")
            check(ctl["restored"] <= limit / 10,
                  f"23 (e) {size} mp {mp}: the control step's clean rerun "
                  f"is {ctl['restored']:.3g} off the step")
            tag = f"mp{mp}" if size == "1.3b" else f"{size}_mp{mp}"
            launches[tag] = sum(r["launches"] for r in rs)
    return launches


def world_mlp(ranks):
    """(g)'s checks and line."""
    g = [r["g"] for r in ranks]
    h = [r["hapi"] for r in g]
    check(all(x["digest"] == h[0]["digest"] for x in h),
          "23 (g): the hapi ranks' params differ")
    check(h[0]["err_vs_one"] <= 1e-5,
          f"23 (g): hapi params off one rank by {h[0]['err_vs_one']}")
    flip = h[0]["flip"]["before"]
    check(flip and {d["rank"] for d in flip} == {1} and all(
        d["majority_ranks"] == [0, 2, 3] for d in flip),
        f"23 (g): the flipped bit was named as {flip}")
    check(h[1]["flip"]["repaired"] and all(
        x["flip"]["after"] == [] and x["flip"]["digest"] == h[0]["digest"]
        for x in h), "23 (g): the flip was not repaired bitwise")
    t = [r["hapi_mp"] for r in g]
    check(all(x["digest"] == t[0]["digest"] for x in t),
          "23 (g): the dp 2 x mp 2 hapi ranks' params differ")
    check(t[0]["split"] == ["column", "row"] and
          t[0]["err_vs_one"] <= 1e-5,
          f"23 (g): dp 2 x mp 2 hapi: {t[0]['split']}, params off one rank "
          f"by {t[0]['err_vs_one']}")
    p = [r["pipeline"] for r in g]
    err = max(abs(a - b) for r in p for a, b in zip(r["losses"], r["one"]))
    perr = max(r["param_err"] for r in p)
    ex = g[1]["executor"]["losses"]
    eerr = max(abs(a - b) for a, b in zip(ex, g[0]["executor"]["one"]))
    print(f"[phase 23 (g)] hapi prepare(device_mesh='auto') on 4 ranks: "
          f"params bitwise equal, {h[0]['err_vs_one']:.2e} off one rank, "
          f"a bit flipped on rank 1 named {h[0]['flip']['before']} and "
          f"repaired {h[1]['flip']['repaired']}; dp 2 x mp 2 with "
          f"{g[0]['hapi_mp']['split']} linears split: params bitwise "
          f"equal, {g[0]['hapi_mp']['err_vs_one']:.2e} off one rank; "
          f"ms/step {[round(x['ms'], 2) for x in h]}, collective share "
          f"{[round(x['collective_share'], 3) for x in h]}; fleet "
          f"PipelineLayer on 4 stages ({p[0]['type']}): losses "
          f"{[round(x, 6) for x in p[0]['losses']]}, {err:.2e} off the "
          f"sequential list, params {perr:.2e}, ms/step "
          f"{[round(x['ms'], 2) for x in p]}; PipelineStageExecutor on 2 "
          f"processes: losses {[round(x, 6) for x in ex]}, {eerr:.2e} off "
          f"one process, stage-0 weight {g[0]['executor']['w0_err']:.2e}, "
          f"{g[1]['executor']['ms']:.2f} ms/step (host clock, the last "
          f"stage)")
    check(err <= 1e-5 and perr <= 1e-5,
          f"23 (g): the pipeline off the sequential list by {err}, {perr}")
    check(eerr <= 1e-5 and g[0]["executor"]["w0_err"] <= 1e-5,
          f"23 (g): the executor off one process by {eerr}")


def hapi_gpt_windows():
    """(g)'s parameter bytes a rank holds inside a step at dp 2 x mp 2,
    from the shapes: the whole model's less half of each weight the
    rules split (``qkv``, ``proj``, ``up``, ``down``: 12·D² a layer)."""
    from paddle_tpu_torch.models import GPT_CONFIGS

    c = GPT_CONFIGS["gpt3-1.3b"]
    D, F, L = c.hidden, c.ffn_hidden, WORLD_HAPI_GPT["layers"]
    split = L * (3 * D * D + D * D + 2 * D * F) * 4
    return split, split // 2


def world_hapi_gpt(ranks, one, tmp):
    """(g)'s hapi GPT world against its one-process fit: the losses and
    the eval loss within ``HYBRID_LOSS_REL``, the predictions, the
    bytes inside the step against the windows' sum from the shapes, the
    flash launches of every rank.  Returns the flash launches of the
    world's timed steps, summed over the ranks."""
    g = WORLD_HAPI_GPT
    L = g["layers"]
    split, saved = hapi_gpt_windows()
    whole = one["whole"]
    want = whole - saved
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["losses"], one["losses"]))
    ev = max(abs(r["eval"] - one["eval"]) / abs(one["eval"])
             for r in ranks)
    a = np.load(os.path.join(tmp, "g_world.npz"))["logits"]
    b = np.load(os.path.join(tmp, "g_one.npz"))["logits"]
    pred = float(np.abs(a - b).max() / np.abs(b).max())
    steady = lambda r, k: r[k][1:]   # noqa: E731  (the first step untimed)
    gib = lambda xs: [round(x / 2**30, 3) for x in xs]   # noqa: E731
    print(f"[phase 23 (g)] hapi over dp 2 x mp 2, the Paddle-style GPT at "
          f"GPT-3 1.3B widths on {L} layers, fp32, {g['rows']} x "
          f"{g['seq']} ({g['steps']} AdamW steps, qkv/up by columns, "
          f"proj/down by rows): losses {[round(x, 6) for x in ranks[0]['losses']]} "
          f"vs one process {[round(x, 6) for x in one['losses']]} "
          f"({rel:.2e} relative, limit {HYBRID_LOSS_REL:g}); eval "
          f"{ranks[0]['eval']:.6f} vs {one['eval']:.6f} ({ev:.2e}); "
          f"predictions {pred:.2e} of the largest logit; ms/step a rank "
          f"{[[round(x, 1) for x in steady(r, 'ms')] for r in ranks]} "
          f"(one process {[round(x, 1) for x in steady(one, 'ms')]}); "
          f"peak GiB a rank by step {[gib(r['peak']) for r in ranks]}, "
          f"at the end of the backward {[gib(r['backward_peak']) for r in ranks]} "
          f"(one process, eager / capture / replay {gib(one['peak'])}, "
          f"end of the eager backward {gib(one['backward_peak'][:1])}); "
          f"parameter + gradient bytes inside the step a rank "
          f"{[r['step_params'][-1] + r['step_grads'][-1] for r in ranks]} "
          f"(predicted {2 * want}, the whole model's {2 * whole}: "
          f"{2 * want / (2 * whole):.3f}); held between steps "
          f"{[r['held'] for r in ranks]}; collective share "
          f"{[round(sum(steady(r, 'collective_s')) * 1e3 / sum(steady(r, 'ms')), 3) for r in ranks]}; "
          f"flash launches a rank a step "
          f"{[r['launches'][-1] for r in ranks]}, eval "
          f"{ranks[0]['eval_launches']}, predict "
          f"{ranks[0]['predict_launches']}; {card_line()}")
    check(rel <= HYBRID_LOSS_REL and ev <= HYBRID_LOSS_REL,
          f"23 (g) hapi GPT: losses {rel:.3g}, eval {ev:.3g} off one "
          f"process")
    check(pred <= 1e-3, f"23 (g) hapi GPT: predictions {pred:.3g} off")
    for r in ranks:
        check(all(x == want for x in r["step_params"] + r["step_grads"]),
              f"23 (g) hapi GPT: bytes inside the steps {r['step_params']} "
              f"(params), {r['step_grads']} (grads), not the windows' "
              f"{want}")
        check(all(x["fwd"] == L and x["bwd"] == 2 * L
                  for x in r["launches"]),
              f"23 (g) hapi GPT: flash launches {r['launches']}, expected "
              f"{L} forward and {2 * L} backward (fp32) a step")
        check(r["eval_launches"]["fwd"] == L and
              r["predict_launches"]["fwd"] == L,
              f"23 (g) hapi GPT: eval / predict launches "
              f"{r['eval_launches']} {r['predict_launches']}")
        check(r["losses"][-1] < r["losses"][0],
              f"23 (g) hapi GPT: losses {r['losses']} do not fall")
    return {k: sum(r["launches"][i][k] for r in ranks
                   for i in range(1, g["steps"])) for k in ("fwd", "bwd")}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_worlds(torch, serving, cases=WORLD_CASES):
    """Phase 23: the pipeline, ZeRO-3, mp serving, sharded checkpoint
    windows, hapi and the pipeline layer API in one world of
    ``HYBRID_RANKS`` ranks on the one card; the oracles run in this
    process while the ranks start.  Returns each case's flash (and
    ragged) launches summed over the ranks."""
    free_cuda(torch)
    tmp = tempfile.mkdtemp(prefix="phase23_")
    go = os.path.join(tmp, "oracles.json")
    oracles, t0 = {}, time.perf_counter()
    try:
        env = {"PHASE22_GO": go, "PHASE23_TMP": tmp,
               "PHASE23_STORE_PORT": str(_free_port())}
        with hybrid_world(cases, HYBRID_RANKS, tmp, child="worlds",
                          env=env) as join:
            if "a" in cases or "b" in cases:
                oracles["a"] = oracles["b"] = world_oracle(
                    torch, WORLDS["a"]["layers"], WORLDS["a"]["batch"])
            if "c" in cases or "d" in cases:
                oracles["c"] = oracles["d"] = world_oracle(
                    torch, 8, WORLDS["c"]["batch"])
            if "g" in cases:
                oracles["g"] = hapi_gpt_fit(torch, None, tmp, "one")
            if "e" in cases:
                oracles["e"] = {size: serve_oracle(
                    torch, serving, cfg,
                    os.path.join(tmp, f"e_oracle_{size}.npz"))
                    for size, cfg in world_serve_cfgs().items()}
            with open(go + ".tmp", "w") as f:
                json.dump(time.perf_counter() - t0, f)
            os.replace(go + ".tmp", go)
            ranks = join(timeout=1200)
        wall = time.perf_counter() - t0
        ready = max(r["stamps"]["ready"] for r in ranks)
        gone = max(r["stamps"]["go"] for r in ranks)
        print(f"[phase 23] one world of {HYBRID_RANKS} ranks, {wall:.1f} s: "
              f"the oracles took {json.load(open(go)):.1f} s, the ranks "
              f"waited {max(0.0, gone - ready):.1f} s for them; seconds by "
              f"case (rank 0) " + ", ".join(
                  f"({k}) {v:.1f}" for k, v in ranks[0]["seconds"].items()))
        res = {c: [r["cases"][c] for r in ranks] for c in cases}
        launches = {}
        for case in cases:
            if case in WORLDS:
                launches[case] = world_train_case(case, res[case],
                                                  oracles[case])
        world_memory(res, oracles)
        if "e" in cases:
            launches["e"] = world_serve([r["cases"] for r in ranks],
                                        oracles["e"])
        if "f" in cases:
            world_ckpt(res["f"], tmp)
        if "g" in cases:
            world_mlp([r["cases"] for r in ranks])
            launches["g"] = world_hapi_gpt(
                [r["cases"]["g"]["gpt"] for r in ranks], oracles["g"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


#: phase 24, the rest of distributed training, on the one card (worlds
#: of rank processes over gloo, as in phases 22-23: not a forecast of
#: NCCL across cards).  (a) ``parallelize`` of the JAX test's GPT loss
#: at GPT-3 1.3B widths cut to 4 layers (gloo's time), bf16, dp 2 x mp 2
#: from its three annotations, 3 SGD steps, and ``tiny`` fp32; (e)
#: runs in (a)'s world.  (b) a supervised 2-rank dp world (the
#: launcher under ``TrainingSupervisor(elastic=, hosts=)``), GPT-3 1.3B
#: widths on 4 layers, 2 x 2048, a windowed checkpoint every 2 steps,
#: one host's heartbeat lost after step 4.  (c) phase 22 (g)'s MLP at
#: dp 2 under ``TrainingSupervisor(hang_watchdog=)``, one rank stalled
#: at ``collective.all_reduce`` in step 3.  (d) ``bench.py``'s
#: parameter-server configuration (``bench_ps``: 100,000 rows x 64,
#: batches of 4096, 2 servers) and a 2-trainer hogwild CTR step.
P24 = dict(
    device="cuda",
    # (a) at 2 layers (4 until phase 25 joined the script)
    ap=dict(base="gpt3-1.3b", layers=2, batch=(4, 2048), steps=3,
            lr=1e-2, axes={"dp": 2, "mp": 2}),
    ap_tiny=dict(base="tiny", layers=2, batch=(8, 128), steps=3, lr=1e-2),
    sup=dict(base="gpt3-1.3b", layers=2, batch=(2, 2048), steps=6,
             every=2, lose_at=4),
    mlp=dict(hidden=1024, batch=128, steps=6, stall_at=3),
    ps=dict(rows=100_000, dim=64, batch=4096, servers=2, ctr_steps=6,
            hot=8192, tower=256),
    # (c): a rank inside a collective that has not reached the wire is
    # named after 2 s without progress (a rank writing a checkpoint
    # while its peer waits on the wire has no collective in flight and
    # is not named, however long the write)
    stall_timeout=2.0, node_timeout=3.0, lost_for=0.5,
)
#: (a): the JAX test's three annotations (test_auto_parallel.py:175-179)
AP_ANN = {"0/blocks/qkv_w": (None, None, "mp"),
          "0/blocks/up_w": (None, None, "mp"), "1": ("dp",)}
#: (a): each step's loss and each leaf's step-1 gradient norm against
#: the one-process step, relative: phase 22's limits; ``tiny`` fp32 1e-4
P24_LOSS_REL, P24_GRAD_REL, P24_TINY_REL = 2e-4, 3e-3, 1e-4
#: (c): the recorder's documented bound (bench.py:1031-1040)
RECORDER_BOUND = 0.03
#: (d): a touched row against init + the sum of its pushes (fp32; the
#: order of the adds differs between the trainers)
PS_TOL = 1e-6


def p24_gpt_cfg(c):
    from paddle_tpu_torch.models import GPT_CONFIGS

    kw = dict(num_layers=c["layers"])
    if c["base"] == "tiny":
        kw["dtype"] = "float32"
    return dataclasses.replace(GPT_CONFIGS[c["base"]], **kw)


def p24_loss(cfg):
    """The JAX test's GPT ``loss`` (test_auto_parallel.py:175-179)."""
    import torch

    from paddle_tpu_torch.models.gpt import gpt_forward

    def loss(params, tokens):
        logits = gpt_forward(cfg, params, tokens)
        logp = torch.log_softmax(logits.float(), -1)
        tgt = torch.roll(tokens, -1, 1)
        return -torch.gather(logp, -1, tgt[..., None]).mean()
    return loss


def p24_step(cfg, lr):
    """One SGD step of ``p24_loss`` with its gradient: ``(new params,
    loss, each leaf's squared gradient norm)`` — what ``parallelize``
    traces, and what the one-process oracle calls as it is."""
    import torch
    from torch.utils import _pytree as pytree

    loss_fn = p24_loss(cfg)

    def step(params, tokens):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), tokens)
            grads = torch.autograd.grad(loss, leaves)
        new = [p - lr * g for p, g in zip(flat, grads)]
        gsq = torch.stack([g.float().square().sum() for g in grads])
        return pytree.tree_unflatten(new, spec), loss.detach(), gsq
    return step


def p24_tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)


def p24_params(torch, cfg, device):
    from paddle_tpu_torch.models import gpt_init

    return gpt_init(cfg, torch.Generator(device=device).manual_seed(24),
                    device=device)


def p24_paths(params):
    from torch.utils import _pytree as pytree

    from paddle_tpu_torch.distributed.auto_parallel.propagation import \
        _path_str

    return [_path_str(p) for p, _ in
            pytree.tree_flatten_with_path(params)[0]]


def p24_oracle(torch, c, device):
    """The one-process run of (a)'s step: each step's loss, each leaf's
    step-1 gradient norm, and the completed specs of the one-process
    propagator."""
    from torch.utils import _pytree as pytree

    from paddle_tpu_torch.distributed.auto_parallel import complete
    from paddle_tpu_torch.distributed.mesh import P

    cfg = p24_gpt_cfg(c)
    params = p24_params(torch, cfg, device)
    toks = [torch.from_numpy(p24_tokens(cfg, *c["batch"], 240 + i)).to(
        device) for i in range(c["steps"])]
    step = p24_step(cfg, c["lr"])
    ann = {k: P(*v) for k, v in AP_ANN.items()}
    specs = complete(p24_loss(cfg), (params, toks[0]), ann,
                     P24["ap"]["axes"])
    losses, norms = [], None
    with torch.no_grad():
        for t in toks:
            params, loss, gsq = step(params, t)
            losses.append(float(loss))
            if norms is None:
                norms = gsq.sqrt().tolist()
    flat = pytree.tree_flatten(specs[0], is_leaf=lambda s: isinstance(
        s, P))[0]
    del params
    return {"losses": losses, "grad_norms": norms,
            "specs": [list(s) for s in flat]}


def _p24_world_step(torch, c, mesh, device, fa):
    """(a) on this rank: ``parallelize`` the step, ``reshard`` the whole
    params into the windows, ``steps`` steps (the first one warm); the
    losses, step-1 gradient norms, specs, bytes, ms/step, the
    collectives' share and the flash launches a step."""
    from torch.utils import _pytree as pytree

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.auto_parallel import (parallelize,
                                                            reshard)
    from paddle_tpu_torch.distributed.mesh import P
    from paddle_tpu_torch.observability import default_registry, \
        default_tracer

    cfg = p24_gpt_cfg(c)
    params = p24_params(torch, cfg, device)
    toks = [torch.from_numpy(p24_tokens(cfg, *c["batch"], 240 + i)).to(
        device) for i in range(c["steps"])]
    ann = {k: P(*v) for k, v in AP_ANN.items()}
    step, specs = parallelize(p24_step(cfg, c["lr"]), mesh,
                              (params, toks[0]), ann, return_specs=True)
    whole = sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(params))
    sp = reshard(params, specs[0], mesh)
    del params
    local = sum(d.data.numel() * d.data.element_size()
                for d in pytree.tree_leaves(
                    sp, is_leaf=lambda d: hasattr(d, "full")))
    hist = default_registry().histogram(
        "training_step_seconds", "wall time of a training step")
    losses, norms, times, coll = [], None, [], []
    for i, t in enumerate(toks):
        if i == 1:
            zero_counts(fa)
        collective.reset_collective_stats()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with default_tracer().trace("auto_parallel::step", {"step": i}):
            sp, loss, gsq = step(sp, t)
            if device == "cuda":
                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist.observe(dt)
        times.append(dt)
        coll.append(sum(collective.collective_stats()["seconds"].values()))
        losses.append(float(loss.data))
        if norms is None:
            norms = gsq.data.float().sqrt().tolist()
    timed = max(1, len(toks) - 1)
    flat = pytree.tree_flatten(specs[0], is_leaf=lambda s: isinstance(
        s, P))[0]
    return {"losses": losses, "grad_norms": norms,
            "specs": [list(s) for s in flat], "paths": p24_paths(sp),
            "local_bytes": local, "whole_bytes": whole,
            "ms": 1e3 * sum(times[1:]) / timed,
            "collective_share": sum(coll[1:]) / max(1e-9, sum(times[1:])),
            "launches": {k: v / timed for k, v in fa.launches.items()},
            "stats": dict(step.stats), "whole_ops": dict(step.whole_ops)}


def _p24_metrics(store, rank, world, tmp):
    """(e) on this rank: publish the registry; rank 0 merges every
    rank's and exports the tracer's chrome timeline."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.observability import (ClusterAggregator,
                                                RankMetricsPublisher,
                                                default_tracer)

    RankMetricsPublisher(store, rank).publish()
    collective.barrier()
    if rank != 0:
        return None
    agg = ClusterAggregator(store, world, stale_after_s=120.0)
    text = agg.expose_prometheus()
    snap = agg.merged_snapshot(collect=False)
    path = default_tracer().export_chrome(os.path.join(tmp, "p24a.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    return {"text": text, "reporting": len(snap["ranks"]),
            "skew": snap["step_time_skew_seconds"],
            "spans": {"step": sum(n == "auto_parallel::step" for n in names),
                      "collective": sum(n.startswith("collective::")
                                        for n in names)}}


def child_p24(what, cfg_path, out, *extra):
    """``chip_smoke.py --child p24 WHAT CFG OUT``: one process of phase
    24 (``WHAT``: ``auto``, a rank of (a) and (e); ``sup_gpt`` /
    ``sup_mlp``, a rank of (b) / (c)'s trainer; ``agent``, (b)'s second
    host; ``ctr``, a trainer of (d)), configured by the JSON at CFG."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    fn = {"auto": _child_auto, "sup_gpt": _child_sup_gpt,
          "sup_mlp": _child_sup_mlp, "agent": _child_agent,
          "ctr": _child_ctr}[what]
    return fn(cfg, out, *extra)


def _store(cfg):
    from paddle_tpu_torch.distributed.store import TCPStore

    host, port = cfg["store"].rsplit(":", 1)
    return TCPStore(host=host, port=int(port), timeout=60.0)


def _child_auto(cfg, out):
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.kernels import flash_attention as fa

    distributed.init_parallel_env()
    rank, world = distributed.get_rank(), distributed.get_world_size()
    device = cfg["device"]
    if device == "cuda":
        prepare(torch)
    mesh = Mesh(dict(cfg["ap"]["axes"]))
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["tiny"] = _p24_world_step(torch, cfg["ap_tiny"], mesh, device, fa)
    res["full"] = _p24_world_step(torch, cfg["ap"], mesh, device, fa)
    res["metrics"] = _p24_metrics(_store(cfg), rank, world, cfg["tmp"])
    res["seconds"] = time.perf_counter() - t0
    with open(f"{out}.r{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _append(path, rec):
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _hold(cfg, step):
    """Attempt 0 of a supervised world waits after ``step`` until the
    phase has done its damage (the phase creates ``hold_done`` before
    the relaunch), so the fault lands at a known step."""
    if step != cfg.get("hold_at"):
        return
    done = os.path.join(cfg["dir"], "hold_done")
    while not os.path.exists(done):
        time.sleep(0.05)


def _child_sup_gpt(cfg, out):
    """(b)'s trainer, one rank: ``HybridEngine`` at dp 2 over the world,
    resumed from the newest complete windowed checkpoint under the
    supervisor's ``PADDLE_ELASTIC_RESUME_DIR``; rank 0 logs each step's
    loss; a windowed checkpoint every ``every`` steps."""
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import checkpoint, collective
    from paddle_tpu_torch.kernels import flash_attention as fa

    distributed.init_parallel_env()
    rank, world = distributed.get_rank(), distributed.get_world_size()
    if cfg["device"] == "cuda":
        prepare(torch)
    c = cfg["sup"]
    mcfg = p24_gpt_cfg(c)
    eng = distributed.HybridEngine(mcfg, dp=world, device=cfg["device"])
    ckdir = os.environ.get("PADDLE_ELASTIC_RESUME_DIR", cfg["dir"])
    done = sorted(int(d[5:]) for d in os.listdir(ckdir)
                  if d.startswith("step_") and os.path.exists(
                      os.path.join(ckdir, d, "COMPLETE")))
    if done:
        params, opt = checkpoint.load_engine_state(
            os.path.join(ckdir, f"step_{done[-1]}"), eng)
        start = done[-1]
    else:
        params, opt = eng.init(seed=0)
        start = 0
    zero_counts(fa)
    for s in range(start + 1, c["steps"] + 1):
        toks, labels = hybrid_batch(mcfg, *c["batch"], seed=2400 + s)
        params, opt, loss = eng.step(params, opt, toks, labels, lr=1e-4)
        if rank == 0:
            _append(out, {"step": s, "loss": float(loss), "resumed_from":
                          start, "t": time.time(), "launches": dict(
                              fa.launches)})
        if s % c["every"] == 0:
            path = os.path.join(ckdir, f"step_{s}")
            checkpoint.save_engine_state(path, eng, params, opt)
            collective.barrier()
            if rank == 0:
                open(os.path.join(path, "COMPLETE"), "w").close()
            collective.barrier()
        _hold(cfg, s)
    return 0


def _child_sup_mlp(cfg, out):
    """(c)'s trainer, one rank: phase 22 (g)'s MLP through fleet's
    ``DataParallel`` and ``distributed_optimizer``, a ``HangWatchdog``
    beating over the phase's store, a checkpoint every step (rank 0,
    atomically), resumed from the newest; with ``stall`` set, rank 1
    stalls at ``collective.all_reduce`` in step ``stall_at``.  Also times
    the recorder: the all-reduce of the step's gradients with and
    without ``record_collective``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.observability import (HangWatchdog,
                                                default_flight_recorder)
    from paddle_tpu_torch.resilience import FaultSpec, injected_faults
    from paddle_tpu_torch.resilience.atomic import atomic_write

    s_ = fleet.DistributedStrategy()
    s_.hybrid_configs["dp_degree"] = 2
    fleet.init(is_collective=True, strategy=s_)
    rank, n = fleet.fleet.worker_index(), fleet.fleet.worker_num()
    device = cfg["device"]
    paddle.set_device("gpu" if device == "cuda" else "cpu")
    c = cfg["mlp"]
    H, B = c["hidden"], c["batch"]
    # the ranks' own watchdogs fire (and bundle) before the supervisor's
    # observer ends the world; each process bundles into its own folder
    wd = HangWatchdog(_store(cfg), rank=rank, world_size=n,
                      recorder=default_flight_recorder(),
                      stall_timeout_s=0.75 * cfg["stall_timeout"],
                      interval_s=0.1, key_prefix=cfg["key"],
                      bundle_dir=os.path.join(cfg["dir"],
                                              f"r{rank}_{os.getpid()}"))
    wd.start(interval_s=0.1)
    paddle.seed(0)
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(H, H), nn.ReLU(), nn.Linear(H, H),
                        nn.ReLU(), nn.Linear(H, 10))
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(paddle.optimizer.Momentum(
        learning_rate=0.01, parameters=model.parameters()))
    ckdir = os.environ.get("PADDLE_ELASTIC_RESUME_DIR", cfg["dir"])
    done = sorted(int(f[5:-4]) for f in os.listdir(ckdir)
                  if f.startswith("step_") and f.endswith(".pkl"))
    start = 0
    if done:
        import pickle

        with open(os.path.join(ckdir, f"step_{done[-1]}.pkl"), "rb") as f:
            st = pickle.load(f)
        with torch.no_grad():
            for p, v in zip(net.parameters(), st["params"]):
                p.copy_(torch.from_numpy(v))
        opt.set_state_dict(st["opt"])
        start = done[-1]
    b = B // n
    times, records = [], 0
    for s in range(start + 1, c["steps"] + 1):
        rng = np.random.RandomState(100 + s)
        x = rng.randn(B, H).astype(np.float32)[rank * b:(rank + 1) * b]
        y = rng.randint(0, 10, (B,))[rank * b:(rank + 1) * b]
        xs = torch.from_numpy(x).to(device)
        ys = torch.from_numpy(y).to(device)
        marker = os.path.join(cfg["dir"], "stall_t")
        stall = cfg.get("stall") and rank == 1 and s == c["stall_at"] \
            and not os.path.exists(marker)       # once, not in a relaunch
        if stall:
            with open(marker, "w") as f:
                f.write(str(time.time()))
        faults = [FaultSpec("collective.all_reduce", "stall", occurrence=1,
                            stall_s=600.0)] if stall else []
        t0 = time.perf_counter()
        before = default_flight_recorder().summary()["completed"]
        with injected_faults(*faults):
            loss = torch.nn.functional.cross_entropy(model(xs), ys)
            loss.backward()
            model.apply_collective_grads()
            opt.step()
            opt.clear_grad()
        loss = collective.all_reduce(loss.detach().reshape(1)).item() / n
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        records += default_flight_recorder().summary()["completed"] - before
        if rank == 0:
            import pickle

            st = {"params": [p.detach().cpu().numpy()
                             for p in net.parameters()],
                  "opt": {k: (v.detach().cpu().numpy()
                              if hasattr(v, "detach") else v)
                          for k, v in opt.state_dict().items()}}
            with atomic_write(os.path.join(ckdir, f"step_{s}.pkl")) as f:
                pickle.dump(st, f)
            _append(out, {"step": s, "loss": loss, "resumed_from": start,
                          "t": time.time()})
        collective.barrier()
    res = {"ms": 1e3 * float(np.median(times)) if times else None}
    if cfg.get("time_recorder"):
        res.update(_recorder_cost(torch, collective, net))
        res["records_a_step"] = records / max(1, c["steps"] - start)
    wd.stop()
    if rank == 0:
        _append(out, {"done": res})
    return 0


def _recorder_cost(torch, collective, net, iters=2000, reps=5):
    """What ``record_collective`` adds to a call, the transport left out:
    ``all_reduce`` of the step's flat gradient over a group of this rank
    alone (the call records and returns) against its bare
    ``__wrapped__``, ``iters`` calls a timing, the median of ``reps``
    interleaved timings (a gloo all-reduce's own spread, ~1 ms on this
    host, would hide a cost of microseconds)."""
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    alone = collective.Group([collective.world_group().ranks[0]], None,
                             gid=-1)
    bare = collective.all_reduce.__wrapped__
    inst, raw = [], []
    for _ in range(reps):
        for fn, ts in ((collective.all_reduce, inst), (bare, raw)):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(flat, group=alone)
            ts.append((time.perf_counter() - t0) / iters)
    return {"ar_inst_us": 1e6 * float(np.median(inst)),
            "ar_bare_us": 1e6 * float(np.median(raw))}


def _child_agent(cfg, out, go=None):
    """(b)'s second host: registers ``host1`` (once the file ``go``
    exists, when given) and beats until killed."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    while go is not None and not os.path.exists(go):
        time.sleep(0.02)
    ElasticManager(_store(cfg), job_id=cfg["key"], np=2, host="host1",
                   heartbeat_interval=0.1,
                   node_timeout=cfg["node_timeout"]).register()
    with open(out, "w") as f:
        f.write(str(os.getpid()))
    while True:
        time.sleep(1.0)


def _child_ctr(cfg, out):
    """(d)'s trainer: ``SparseEmbedding`` over the phase's table, a dense
    tower on the card, ``ctr_steps`` hogwild steps; saves every push (its
    ids and the exact deltas) for the phase's checks."""
    import torch

    from paddle_tpu_torch.distributed.ps import (PSClient, SparseEmbedding,
                                                 SparseTable)

    c, rank = cfg["ps"], cfg["rank"]
    client = PSClient(cfg["endpoints"])
    table = SparseTable(client, cfg["table"], c["dim"], 0.01, 7)
    emb = SparseEmbedding(table, lr=0.05, device=cfg["device"])
    g = torch.Generator().manual_seed(rank)
    tower = torch.nn.Sequential(
        torch.nn.Linear(c["dim"], c["tower"]), torch.nn.ReLU(),
        torch.nn.Linear(c["tower"], 1)).to(cfg["device"])
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    opt = torch.optim.SGD(tower.parameters(), lr=0.05)
    rng = np.random.RandomState(1000 + rank)
    ids_all, deltas_all, times = [], [], []
    pushed = []
    orig_push = table.push

    def spy(ids, deltas):
        pushed.append((np.asarray(ids).copy(),
                       np.asarray(deltas, np.float32).copy()))
        return orig_push(ids, deltas)

    table.push = spy
    for _ in range(c["ctr_steps"]):
        # a hot corner of the table: the two trainers push the same rows
        ids = rng.randint(0, c["hot"], c["batch"])
        y = torch.from_numpy((ids % 3 == 0).astype(np.float32)).to(
            cfg["device"])
        t0 = time.perf_counter()
        rows = emb.forward(ids)
        logit = tower(rows)[:, 0]
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logit, y)
        loss.backward()
        emb.apply_grads()
        opt.step()
        opt.zero_grad()
        times.append(time.perf_counter() - t0)
    for ids, d in pushed:
        ids_all.append(ids)
        deltas_all.append(d)
    np.savez(out, ids=np.concatenate(ids_all),
             deltas=np.concatenate(deltas_all),
             sizes=np.array([len(i) for i in ids_all]),
             times=np.array(times), retries=np.array(client.cas_retries))
    return 0


def _launch_cmd(n, logs, *args, device=None):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), "--backend", "gloo", "--log_dir",
           logs]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    return cmd + [os.path.abspath(__file__), "--child", "p24", *args]


def _read_log(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def p24_auto(torch, cfg, tmp, store):
    """(a) and (e): a world of 4 ranks runs ``parallelize``; the oracles
    run in this process meanwhile."""
    import re
    cfg_path = os.path.join(tmp, "auto.json")
    out = os.path.join(tmp, "auto")
    logs = os.path.join(tmp, "logs_auto")
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, tmp=tmp), f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(_launch_cmd(4, logs, "auto", cfg_path, out,
                                        device=cfg["device"]),
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        oracle = {k: p24_oracle(torch, cfg[k], cfg["device"])
                  for k in ("ap_tiny", "ap")}
        free_cuda(torch) if cfg["device"] == "cuda" else None
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
    if rc:
        for i in range(4):
            path = os.path.join(logs, f"workerlog.{i}")
            if os.path.exists(path):
                print(f"--- rank {i} ---\n" + open(path).read()[-3000:])
    check(rc == 0, f"24 (a): the world of 4 ranks exited {rc}")
    ranks = [json.load(open(f"{out}.r{i}.json")) for i in range(4)]
    wall = time.perf_counter() - t0
    launches = {}
    for key, lim in (("ap_tiny", P24_TINY_REL), ("ap", P24_LOSS_REL)):
        o = oracle[key]
        res = [r["tiny" if key == "ap_tiny" else "full"] for r in ranks]
        c = cfg[key]
        m = p24_gpt_cfg(c)
        tag = f"{c['base']} widths, {m.num_layers} layers, {m.dtype}"
        for r in res:
            check(r["specs"] == o["specs"],
                  f"24 (a) {tag}: a rank's completed specs differ from the "
                  f"one-process propagator's")
        worst = max(_rel(a, b) for r in res
                    for a, b in zip(r["losses"], o["losses"]))
        gworst, gleaf = max((_rel(a, b), p) for r in res for a, b, p in zip(
            r["grad_norms"], o["grad_norms"], r["paths"]))
        split = {p: s for p, s in zip(res[0]["paths"], res[0]["specs"])
                 if any(s)}
        print(f"[phase 24 (a)] parallelize, {tag}, dp 2 x mp 2 from the "
              f"JAX test's three annotations, {c['steps']} SGD steps of "
              f"{c['batch'][0]} x {c['batch'][1]}: completed specs equal "
              f"to the one-process propagator's on every rank; split "
              f"leaves {split}")
        print(f"[phase 24 (a)] {tag}: losses {res[0]['losses']} against "
              f"one process {o['losses']}: worst relative {worst:.3g} "
              f"(checked at {lim}); step-1 gradient norms worst "
              f"{gworst:.3g} at {gleaf} (checked at "
              f"{P24_GRAD_REL if key == 'ap' else lim})")
        check(worst <= lim, f"24 (a) {tag}: loss off one process by "
                            f"{worst:.3g}")
        check(gworst <= (P24_GRAD_REL if key == "ap" else lim),
              f"24 (a) {tag}: step-1 gradient norm of {gleaf} off one "
              f"process by {gworst:.3g}")
        print(f"[phase 24 (a)] {tag}: parameter bytes a rank "
              f"{[r['local_bytes'] for r in res]} against "
              f"{res[0]['whole_bytes']} whole; ms/step "
              f"{[round(r['ms'], 1) for r in res]} (steps 2-"
              f"{c['steps']}), the collectives' share "
              f"{[round(r['collective_share'], 3) for r in res]}; "
              f"{res[0]['stats']['nodes']} operations a step, "
              f"{res[0]['stats']['partials']} partial sums all-reduced, "
              f"{res[0]['stats']['whole']} run whole "
              f"{res[0]['whole_ops']}; flash launches a rank a step "
              f"{[r['launches'] for r in res]} (one card shared by 4 "
              f"ranks over gloo: not a forecast of NCCL across cards; "
              f"{card_line()})")
        check(all(r["local_bytes"] < r["whole_bytes"] for r in res),
              f"24 (a) {tag}: a rank holds the whole parameters")
        if key == "ap" and cfg["device"] == "cuda":
            layers = c["layers"]
            for r in res:
                check(r["launches"] == {"fwd": layers, "bwd": layers},
                      f"24 (a): flash launches a rank a step "
                      f"{r['launches']}, expected {layers} / {layers}")
            launches = {k: sum(r["launches"][k] for r in res) *
                        (c["steps"] - 1) for k in ("fwd", "bwd")}
    m = ranks[0]["metrics"]
    text = m["text"]
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')
    bad = [l for l in text.splitlines() if l and not l.startswith("#")
           and not sample.match(l)]
    fleet_names = ("training_step_time_skew_seconds", "cluster_ranks")
    unlabelled = [l for l in text.splitlines() if l and not
                  l.startswith("#") and not l.startswith(fleet_names)
                  and 'rank="' not in l]
    print(f"[phase 24 (e)] ClusterAggregator over 4 ranks' "
          f"RankMetricsPublisher: {len(text.splitlines())} lines of "
          f"Prometheus text, {m['reporting']} ranks reporting, step-time "
          f"skew {m['skew']} s; the chrome export of (a)'s traces holds "
          f"{m['spans']['step']} step span(s) beside "
          f"{m['spans']['collective']} collective spans")
    check(not bad, f"24 (e): lines that do not parse: {bad[:3]}")
    check(not unlabelled, f"24 (e): series without a rank: "
                          f"{unlabelled[:3]}")
    check(m["reporting"] == 4, f"24 (e): {m['reporting']} ranks reporting")
    check(m["skew"] is not None and m["skew"] >= 0
          and "training_step_time_skew_seconds " in text,
          "24 (e): the fleet gauges report no skew")
    check(m["spans"]["step"] >= 1 and m["spans"]["collective"] >= 1,
          f"24 (e): the chrome export lacks step or collective spans "
          f"{m['spans']}")
    print(f"[phase 24 (a)] one world of 4 ranks, {wall:.1f} s")
    return launches


def timed_supervisor(stamps):
    """A ``TrainingSupervisor`` class whose membership loss, hang
    escalation, rendezvous and spawns are stamped into ``stamps``
    (seconds to detect, rendezvous s, restart s)."""
    from paddle_tpu_torch.resilience import TrainingSupervisor

    class Timed(TrainingSupervisor):
        def _membership_lost(self):
            dead = super()._membership_lost()
            if dead:
                stamps.setdefault("lost", time.time())
            return dead

        def _escalate_hang(self, child):
            stamps.setdefault("hang", time.time())
            return super()._escalate_hang(child)

        def _rendezvous(self):
            t0 = time.time()
            super()._rendezvous()
            stamps.setdefault("rendezvous", []).append(time.time() - t0)

        def _spawn(self, attempt):
            child = super()._spawn(attempt)
            stamps.setdefault("children", []).append(child)
            stamps.setdefault("spawned", []).append(time.time())
            return child
    return Timed


def _world_ref(cfg, what, tmp, tag, extra=None):
    """An unsupervised world of ``what`` (the uninterrupted reference):
    returns the Popen and its log path."""
    d = os.path.join(tmp, f"{tag}_ref")
    os.makedirs(d)
    cfg_path = os.path.join(tmp, f"{tag}_ref.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, dir=d, **(extra or {})), f)
    log = os.path.join(tmp, f"{tag}_ref.log")
    proc = subprocess.Popen(
        _launch_cmd(2, os.path.join(tmp, f"logs_{tag}_ref"), what, cfg_path,
                    log, device=cfg["device"]),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PADDLE_ELASTIC_RESUME_DIR=d))
    return proc, log


def _stop(proc):
    """End a process this phase started (a launcher ends its ranks on
    SIGTERM)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def start_host_agent(cfg, tmp):
    """(b)'s second host, started early (a process takes seconds to
    import): ``(its command, the process)``."""
    path = os.path.join(tmp, "agent.json")
    with open(path, "w") as f:
        json.dump(dict(cfg, key="p24b"), f)
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "p24",
           "agent", path, os.path.join(tmp, "agent.pid")]
    return cmd, subprocess.Popen(cmd)


def start_refs(cfg, tmp):
    """(b)'s and (c)'s uninterrupted reference worlds, started early
    (beside (a)): ``{case: (process, log)}``."""
    return {"b": _world_ref(cfg, "sup_gpt", tmp, "b"),
            "c": _world_ref(cfg, "sup_mlp", tmp, "c",
                            {"key": "p24cref", "time_recorder": True})}


def p24_supervised(torch, cfg, tmp, store, host_agent, refs):
    """(b) and (c), side by side: each a supervised 2-rank world; their
    uninterrupted references are ``refs`` (``start_refs``'s), their
    second host ``host_agent`` (``start_host_agent``'s)."""
    import threading

    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.observability import (HangWatchdog,
                                                default_registry)

    def restarts(reason):
        fam = default_registry().get("supervisor_restarts_total")
        return fam.labels(reason=reason).value if fam else 0

    before = {r: restarts(r) for r in ("lost_node", "hang")}
    c = cfg["sup"]
    # ---- (b): elastic membership ------------------------------------
    bdir = os.path.join(tmp, "b")
    os.makedirs(bdir)
    bcfg = dict(cfg, dir=bdir, hold_at=c["lose_at"], key="p24b")
    with open(os.path.join(tmp, "b.json"), "w") as f:
        json.dump(bcfg, f)
    blog = os.path.join(tmp, "b.log")
    agent_cmd, agent = host_agent
    # host1's replacement starts now (a process takes seconds to import,
    # longer beside the worlds' starts) and registers once let back in
    go = os.path.join(tmp, "agent.go")
    standby = subprocess.Popen(agent_cmd + [go])
    bstamps = {}
    bsup = timed_supervisor(bstamps)(
        _launch_cmd(2, os.path.join(tmp, "logs_b"), "sup_gpt",
                    os.path.join(tmp, "b.json"), blog,
                    device=cfg["device"]),
        checkpoint_dir=bdir, max_restarts=1, backoff_base=0.05,
        backoff_cap=0.1,
        elastic=ElasticManager(store, job_id="p24b", np=2, host="host0",
                               heartbeat_interval=0.1,
                               node_timeout=cfg["node_timeout"]),
        hosts=["host0", "host1"], membership_interval=0.1,
        rendezvous_timeout=120.0, term_grace_s=20.0)
    # ---- (c): the hang watchdog ---------------------------------------
    cdir = os.path.join(tmp, "c")
    os.makedirs(cdir)
    ccfg = dict(cfg, dir=cdir, stall=True, key="p24c")
    with open(os.path.join(tmp, "c.json"), "w") as f:
        json.dump(ccfg, f)
    clog = os.path.join(tmp, "c.log")
    observer = HangWatchdog(store, rank=None, world_size=2,
                            stall_timeout_s=cfg["stall_timeout"],
                            key_prefix="p24c", bundle_dir=cdir)
    cstamps = {}
    csup = timed_supervisor(cstamps)(
        _launch_cmd(2, os.path.join(tmp, "logs_c"), "sup_mlp",
                    os.path.join(tmp, "c.json"), clog,
                    device=cfg["device"]),
        checkpoint_dir=cdir, max_restarts=1, backoff_base=0.05,
        backoff_cap=0.1, membership_interval=0.1, term_grace_s=20.0,
        hang_watchdog=observer, on_hang="bundle+restart")
    results = {}

    done_at = {}

    def run(name, sup):
        try:
            results[name] = sup.run()
        except BaseException as e:       # reported below, not swallowed
            results[name] = e
        done_at[name] = time.time()

    t0 = time.time()
    threads = {n: threading.Thread(target=run, args=(n, s), daemon=True)
               for n, s in (("b", bsup), ("c", csup))}
    for t in threads.values():
        t.start()
    try:
        # (b)'s damage: once step lose_at is logged, host1's agent dies;
        # it comes back after lost_for seconds
        end = time.time() + 600
        saved = os.path.join(bdir, f"step_{c['lose_at']}", "COMPLETE")
        while not os.path.exists(saved):
            check(time.time() < end and threads["b"].is_alive(),
                  f"24 (b): step {c['lose_at']}'s checkpoint never "
                  f"completed ({results.get('b')})")
            time.sleep(0.1)
        os.kill(agent.pid, signal.SIGKILL)
        agent.wait()
        killed = time.time()
        agent = standby
        # the held world goes on only once the supervisor has ended it
        while "lost" not in bstamps and time.time() < end:
            time.sleep(0.05)
        first = bstamps["children"][0]
        while first.poll() is None and time.time() < end:
            time.sleep(0.05)
        open(os.path.join(bdir, "hold_done"), "w").close()
        time.sleep(cfg["lost_for"])
        back = time.time()
        open(go, "w").close()
        # (c)'s relaunch must not stall again
        while "hang" not in cstamps and threads["c"].is_alive() and \
                time.time() < end:
            time.sleep(0.05)
        for n in ("b", "c"):
            threads[n].join(timeout=max(1.0, end - time.time()))
        for n, (proc, _) in refs.items():
            rc = proc.wait(timeout=max(1.0, end - time.time()))
            check(rc == 0, f"24 ({n}): the reference world exited {rc}")
    finally:
        # every process this phase started, the supervised worlds' too
        children = bstamps.get("children", []) + cstamps.get("children", [])
        for proc in [agent, standby] + children + \
                [p for p, _ in refs.values()]:
            _stop(proc)
    wall = time.time() - t0
    print(f"[phase 24 (b), (c)] timeline, s from the start: (b) worlds "
          f"spawned at {[round(t - t0, 1) for t in bstamps['spawned']]}, "
          f"host1 killed at {killed - t0:.1f}, lost_node at "
          f"{bstamps['lost'] - t0:.1f}, host1 back at {back - t0:.1f}; "
          f"(c) worlds spawned at "
          f"{[round(t - t0, 1) for t in cstamps['spawned']]}, hang at "
          f"{cstamps.get('hang', t0) - t0:.1f}; supervisors done at "
          f"{ {n: round(t - t0, 1) for n, t in done_at.items()} }")
    for n in ("b", "c"):
        check(results.get(n) == 0, f"24 ({n}): the supervisor returned "
                                   f"{results.get(n)!r}")
    # ---- (b)'s readings -------------------------------------------------
    got, ref = _read_log(blog), _read_log(refs["b"][1])
    ref_loss = {r["step"]: r["loss"] for r in ref if "step" in r}
    resumed = [r for r in got if r.get("resumed_from")]
    check([r for _, r in bsup.restarts] == [1] and
          [x for x, _ in bsup.restarts] == ["lost_node"],
          f"24 (b): restarts {bsup.restarts}, expected one lost_node")
    check(resumed and resumed[0]["step"] == resumed[0]["resumed_from"] + 1
          and resumed[0]["resumed_from"] == c["lose_at"],
          f"24 (b): the relaunch resumed at {resumed[:1]}")
    diff = [r["step"] for r in got if r["loss"] != ref_loss.get(r["step"])]
    check(not diff, f"24 (b): losses at steps {diff} differ from the "
                    f"uninterrupted run's")
    last = resumed[-1]["launches"]
    steps_after = c["steps"] - c["lose_at"]
    detect = bstamps["lost"] - killed
    restart = resumed[0]["t"] - bstamps["lost"]
    print(f"[phase 24 (b)] TrainingSupervisor(elastic=ElasticManager, "
          f"hosts=[host0, host1]) over the launcher, {c['base']} widths on "
          f"{c['layers']} layers at dp 2, {c['batch'][0]} x "
          f"{c['batch'][1]}, a windowed checkpoint every {c['every']} "
          f"steps: host1's heartbeat stopped after step {c['lose_at']}; "
          f"lost_node seen in {detect:.2f} s (node timeout "
          f"{cfg['node_timeout']} s), the world terminated, rendezvous "
          f"{bstamps['rendezvous'][-1]:.2f} s (host1 back "
          f"{back - killed:.2f} s after the kill), first resumed step "
          f"{restart:.2f} s after the detection; resumed from step "
          f"{resumed[0]['resumed_from']}, steps "
          f"{[r['step'] for r in resumed]} bitwise equal to the "
          f"uninterrupted run ({[r['loss'] for r in resumed]}); "
          f"supervisor_restarts_total{{reason=lost_node}} "
          f"{restarts('lost_node') - before['lost_node']:+g}; flash "
          f"launches on rank 0 over the resumed steps {last} ({card_line()}"
          f"; not a forecast of NCCL across cards)")
    if cfg["device"] == "cuda":
        check(last == {"fwd": 2 * steps_after * c["layers"],
                       "bwd": steps_after * c["layers"]},
              f"24 (b): flash launches over the resumed steps {last}")
    # ---- (c)'s readings -------------------------------------------------
    got, ref = _read_log(clog), _read_log(refs["c"][1])
    ref_loss = {r["step"]: r["loss"] for r in ref if "step" in r}
    check([x for x, _ in csup.restarts] == ["hang"],
          f"24 (c): restarts {csup.restarts}, expected one hang")
    d = observer.last_desync or {}
    m = cfg["mlp"]
    check(d.get("lagging_rank") == 1 and d.get("op") == "all_reduce",
          f"24 (c): the watchdog named {d.get('lagging_rank')} / "
          f"{d.get('op')}, expected rank 1 in all_reduce")
    with open(os.path.join(cdir, "stall_t")) as f:
        stall_t = float(f.read())
    detect = cstamps["hang"] - stall_t
    b1 = {}
    for d1 in sorted(x for x in os.listdir(cdir) if x.startswith("r1_")):
        for name in sorted(os.listdir(os.path.join(cdir, d1))):
            with open(os.path.join(cdir, d1, name)) as f:
                got1 = json.load(f)
            if (got1.get("desync") or {}).get("lagging_rank") == 1:
                b1 = got1
    check(b1, "24 (c): rank 1 wrote no bundle naming itself")
    sup_bundle = [b for b in observer.bundles if "observer" in b]
    with open(sup_bundle[-1]) as f:
        bs = json.load(f)
    inflight = [(r["seq"], r["op"]) for r in b1["inflight"]]
    d1 = b1["desync"]
    check(b1["threads"] and bs["threads"],
          "24 (c): a bundle without thread stacks")
    check((d["divergent_seq"], "all_reduce") in inflight and
          d1["divergent_seq"] == d["divergent_seq"],
          f"24 (c): rank 1's bundle holds {inflight} (its own verdict seq "
          f"{d1['divergent_seq']}), not seq {d['divergent_seq']}")
    resumed = [r for r in got if r.get("resumed_from")]
    diff = [r["step"] for r in got if "step" in r
            and r["loss"] != ref_loss.get(r["step"])]
    check(resumed and resumed[0]["step"] == m["stall_at"],
          f"24 (c): the relaunch resumed at {resumed[:1]}")
    check(not diff, f"24 (c): losses at steps {diff} differ from the "
                    f"uninterrupted run's")
    done = [r["done"] for r in ref if "done" in r][0]
    calls = done["records_a_step"]
    over = max(0.0, done["ar_inst_us"] - done["ar_bare_us"]) * 1e-3
    ratio = over * calls / done["ms"]
    print(f"[phase 24 (c)] TrainingSupervisor(hang_watchdog=HangWatchdog "
          f"observer) over phase 22 (g)'s MLP at dp 2: rank 1 stalled at "
          f"collective.all_reduce in step {m['stall_at']}; named rank "
          f"{d['lagging_rank']} at seq {d['divergent_seq']} ({d['op']}) "
          f"{detect:.2f} s after the stall (stall timeout "
          f"{cfg['stall_timeout']} s); rank 1's bundle holds "
          f"{len(b1['threads'])} thread stacks and the in-flight "
          f"{inflight}, the supervisor's {len(bs['threads'])}; relaunched "
          f"and resumed from step {resumed[0]['resumed_from']}, steps "
          f"{[r['step'] for r in resumed]} bitwise equal to the "
          f"uninterrupted run; supervisor_restarts_total{{reason=hang}} "
          f"{restarts('hang') - before['hang']:+g}")
    print(f"[phase 24 (c)] the flight recorder's cost on the MLP world's "
          f"step ({done['ms']:.3f} ms median): a call {done['ar_inst_us']:.2f}"
          f" us recorded, {done['ar_bare_us']:.2f} us bare (all_reduce of "
          f"the step's gradients, transport left out); {calls:g} recorded "
          f"calls a step: {ratio:.4f} of the step against the JAX package's "
          f"documented bound {RECORDER_BOUND} ({card_line()})")
    check(ratio < RECORDER_BOUND, f"24 (c): the recorder costs {ratio:.4f} "
                                  f"of a step")
    print(f"[phase 24 (b), (c)] side by side, {wall:.1f} s")
    return {"fwd": last["fwd"], "bwd": last["bwd"]} if last else {}


def p24_ps(torch, cfg, tmp):
    """(d): ``bench_ps``'s configuration, then the hogwild CTR step."""
    from paddle_tpu_torch.distributed.ps import (PSClient, PSServer,
                                                 SparseTable)

    c = cfg["ps"]
    servers = [PSServer() for _ in range(c["servers"])]
    try:
        eps = [s.endpoint for s in servers]
        client = PSClient(eps)
        table = SparseTable(client, "bench", c["dim"], 0.01, 0)
        # bench_ps's protocol: the table pulled (first touch: the init)
        # and pushed in loader-sized batches, each call timed
        pulls, pushes = [], []
        t_all = time.perf_counter()
        for lo in range(0, c["rows"], c["batch"]):
            ids = list(range(lo, min(c["rows"], lo + c["batch"])))
            t0 = time.perf_counter()
            rows = table.pull(ids)
            pulls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            table.push(ids, np.full_like(rows, 1e-3))
            pushes.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
        pull, push = float(np.median(pulls)), float(np.median(pushes))
        print(f"[phase 24 (d)] parameter server, bench.py's bench_ps "
              f"configuration: {c['rows']} rows x {c['dim']} on "
              f"{c['servers']} PSServers, batches of {c['batch']}: "
              f"{c['rows'] / wall:.0f} rows/s over the table, pull p50 "
              f"{pull * 1e3:.2f} ms (first touch), push p50 "
              f"{push * 1e3:.2f} ms, row-lock retries {client.cas_retries} "
              f"(host only: {card_line()})")
        # the CTR step: two trainers hogwild, then one alone
        cfg_paths, outs = [], []
        for rank, table_name in ((0, "ctr"), (1, "ctr"), (0, "alone")):
            p = os.path.join(tmp, f"ctr_{rank}_{table_name}.json")
            with open(p, "w") as f:
                json.dump(dict(cfg, rank=rank, endpoints=eps,
                               table=table_name), f)
            cfg_paths.append(p)
            outs.append(os.path.join(tmp, f"ctr_{rank}_{table_name}.npz"))
        # the lone trainer's table is its own: it runs beside the pair
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--child", "p24", "ctr", p, o])
                 for p, o in zip(cfg_paths, outs)]
        for p in procs:
            check(p.wait(timeout=600) == 0, "24 (d): a CTR trainer failed")
        got = [np.load(o) for o in outs]
        for name, runs in (("ctr", got[:2]), ("alone", got[2:])):
            ids = np.concatenate([g["ids"] for g in runs])
            deltas = np.concatenate([g["deltas"] for g in runs])
            touched = np.unique(ids)
            rows = SparseTable(client, name, c["dim"], 0.01, 7).pull(
                touched.tolist())
            init = PSClient._init_rows(touched, c["dim"], 0.01, 7)
            pos = {int(i): k for k, i in enumerate(touched)}
            if name == "ctr":
                want = init.astype(np.float64)
                for i, d in zip(ids, deltas):
                    want[pos[int(i)]] += d
                err = float(np.abs(rows - want).max() /
                            max(1e-12, np.abs(want).max()))
                retries = int(sum(int(g["retries"]) for g in runs))
                ms = [1e3 * float(np.median(g["times"])) for g in runs]
                print(f"[phase 24 (d)] CTR step, 2 trainers hogwild over "
                      f"SparseEmbedding (dense tower on the card): "
                      f"{len(ids)} pushed rows over {len(touched)} touched "
                      f"rows; each equals init + the sum of its pushes to "
                      f"{err:.3g} of the largest (checked at {PS_TOL}); "
                      f"row-lock retries {retries}; ms/step {ms}")
                check(err <= PS_TOL, f"24 (d): rows off init + pushes by "
                                     f"{err:.3g}")
            else:
                want = init.copy()
                for i, d in zip(ids, deltas):
                    want[pos[int(i)]] = (want[pos[int(i)]] + d).astype(
                        np.float32)
                same = np.array_equal(rows, want)
                print(f"[phase 24 (d)] one trainer alone: the table "
                      f"equals the numpy reference (init + each push in "
                      f"order, fp32): {same}")
                check(same, "24 (d): one trainer's table differs from the "
                            "numpy reference")
    finally:
        for s in servers:
            s.stop()


# ------------------------------- the observability plane's serving half (25)

SOAK_HORIZON_S = 20.0
# phase 11's prompts and cohorts on a diurnal + burst trace of
# ``bench_soak``'s shape, at a rate the 4-replica fleet sustains
SOAK_TRAFFIC = dict(base_rate_per_s=2.0, diurnal_amplitude=0.5,
                    day_period_s=SOAK_HORIZON_S / 2.0,
                    bursts=((2.0, 3.0, 3.0), (12.0, 2.0, 3.0)),
                    n_cohorts=3, cohort_prefix_len=256, cohort_fraction=0.5,
                    prompt_len=(64, 1024),
                    max_new_tokens=(FLEET_NEW, FLEET_NEW), seed=25)
# ``bench_soak``'s six events at its fractions of the horizon, and a
# bitflip; poison storms stay on the CPU test (a poison boards and kills
# every replica it lands on: each kill here costs a 1.3B build)
SOAK_CHAOS = (("spawn_io_error", 0.08), ("stall_admit", 0.2),
              ("kill", 0.35), ("bitflip", 0.42), ("stall_poll", 0.5),
              ("kill", 0.65), ("stall_admit", 0.8))
SOAK_SCALER = dict(FLEET_SCALER, min_replicas=1, max_replicas=4,
                   spawn_max_retries=2, spawn_backoff_base_s=0.01,
                   spawn_backoff_cap_s=0.05)
# alert windows of at least 2 s short / 4 s long: a respawn's build and
# capture stall the drive loop and its in-loop scrape
SOAK_ALERT = dict(burn_rate_threshold=2.0, long_window_seconds=4.0,
                  short_window_seconds=2.0, clear_after_seconds=0.75)
# the error budget's window: a kill spends the whole budget of a 0.99
# objective, and the autoscaler scales down only with a quarter of it
# left, so the budget must refill within the settle after the last kill
SOAK_BUDGET_WINDOW_S = 8.0
SOAK_TTFT_BOUND_S = 15.0
SOAK_DEVICE = "cuda"


def _gauge_of(text, name):
    """The unlabelled sample of ``name`` in Prometheus text, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def soak_on_card(torch, cfg, params, params_bytes, base, pa, serving,
                 observability):
    """Phase 25 (a): ``run_soak`` over an autoscaled fleet of
    ``FLEET_ENGINE`` engines (2 to 4) with the chaos timeline, one
    ``fleet_availability`` SLO, the sampler, burn feedback and the
    run's own telemetry server, every check read from the report and
    its live scrape.  Returns the ragged kernel's launches."""
    from paddle_tpu_torch.observability.metrics import MetricsRegistry

    FleetEngine = fleet_engine_class(serving)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    pool_bytes = (2 * L * FLEET_ENGINE["num_pages"]
                  * FLEET_ENGINE["page_size"] * H * hd * 2)

    def factory():
        return FleetEngine(cfg, params, device=SOAK_DEVICE, **FLEET_ENGINE)

    traffic = serving.TrafficGenerator(vocab_size=cfg.vocab_size,
                                       **SOAK_TRAFFIC)
    chaos = [serving.ChaosEvent(t=SOAK_HORIZON_S * f, action=a,
                                stall_s=0.4 if a == "stall_admit" else 0.3)
             for a, f in SOAK_CHAOS]
    slos = (observability.SLO(
        "fleet_availability", target=0.99,
        bad=("router_replica_failure_events_total",
             "router_requests_lost_total"),
        total=("router_dispatches_total",),
        alerts=(observability.BurnRateAlert("page", **SOAK_ALERT),),
        budget_window_seconds=SOAK_BUDGET_WINDOW_S),)
    pa.ragged_paged_attention.launches = 0
    report = serving.run_soak(
        factory, traffic, SOAK_HORIZON_S, initial_replicas=2, chaos=chaos,
        scaler_kw=dict(SOAK_SCALER), registry=MetricsRegistry(), slos=slos,
        profile=True, burn_feedback=True, telemetry=True,
        deadline_s=SOAK_HORIZON_S + 90.0, grace_s=20.0, min_down_events=1,
        ttft_bound_s=SOAK_TTFT_BOUND_S)
    launches = pa.ragged_paged_attention.launches
    steps = sum(FleetEngine.steps_by_engine.values())
    scraped = report["scraped"]
    fleet, events = scraped["fleet"], report["scale_events"]

    # ---- checks
    check(not report["timed_out"], "the soak hit its deadline")
    check(report["lost_requests"] == 0,
          f"the soak lost {report['lost_requests']} requests")
    check(report["requests_finished"] == report["requests_submitted"],
          f"{report['requests_finished']} of "
          f"{report['requests_submitted']} submitted requests finished")
    check(events.get("up", 0) >= 1 and events.get("down", 0) >= 1,
          f"the fleet did not scale both ways: {events}")
    check(report["ttft_p99_ok"], f"TTFT p99 {report['ttft_p99_s']} s over "
                                 f"{SOAK_TTFT_BOUND_S} s")
    flight_ops = {r["op"] for r in scraped["flight"]["records"]} | set(
        scraped["flight"]["summary"]["by_op"])
    want_ops = {f"soak::{a}" for a, _ in SOAK_CHAOS}
    check(want_ops <= flight_ops,
          f"chaos missing from /flight: {sorted(want_ops - flight_ops)}")
    fired = {(f["site"], f["kind"]) for f in report["injector_fired"]}
    check({("serving.admit", "stall"), ("autoscaler.poll", "stall"),
           ("autoscaler.scale_up", "io_error"),
           ("serving.step", "bitflip")} <= fired,
          f"injected faults fired: {sorted(fired)}")
    kills = sum(1 for a, _ in SOAK_CHAOS if a == "kill")
    crashes = sum(n for k, n in fleet["counters"]["failovers"].items()
                  if k.endswith(",crash"))
    check(crashes >= kills and fleet["counters"]["lost"] == 0,
          f"/fleet shows {crashes} crash failovers for {kills} kills "
          f"({fleet['counters']['failovers']})")
    kinds = [t["transition"] for t in report["slo"]["transitions"]]
    scraped_kinds = [t["transition"] for t in scraped["slo"]["transitions"]]
    check(kinds and kinds[0] == "fire" and kinds[-1] == "clear"
          and "fire" in scraped_kinds and "clear" in scraped_kinds
          and scraped["slo"]["page_active"] is False,
          f"the page did not fire and clear: report {kinds}, /slo "
          f"{scraped_kinds}")
    check(scraped.get("healthz_ok") is True
          and scraped["healthz"]["slo_page_active"] is False,
          f"/healthz after the page cleared: {scraped.get('healthz')} "
          f"(status {scraped.get('healthz_status')})")
    slo_ids = {t["trace_id"] for t in scraped["traces"]["traces"]
               if any(s["name"] == "slo::fleet_availability"
                      for s in t["spans"])}
    caps = [c for c in scraped["profilez"]["captures"]
            if c["trigger"] == "slo_page"]
    check(caps and all(c["trace_id"] in slo_ids for c in caps),
          f"/profilez captures {caps} not linked to a slo:: trace")
    q = scraped["timeseries_query"]
    check(q["kind"] == "counter" and (q["delta"] or 0) > 0,
          f"/timeseries windowed answer {q}")
    tids = [t["trace_id"] for t in scraped["traces"]["traces"]]
    check(len(tids) == len(set(tids)), "a trace split across entries")
    check(launches > 0 and launches == L * steps,
          f"ragged launches {launches} != {L} x {steps} engine steps")
    check(FleetEngine.finite and all(FleetEngine.finite),
          "soak logits not finite")
    # memory at the last scrape: the live engines' pools and the params
    live = sum(1 for r in fleet["replicas"].values() if r["state"] != "dead")
    gauge = _gauge_of(scraped["metrics"], "torch_cuda_allocated_bytes")
    want = base + params_bytes + live * pool_bytes
    check(gauge is not None and abs(gauge - want) <= FLEET_MEM_SLACK,
          f"at the last scrape {gauge} bytes allocated, {live} live "
          f"engines and the params account for {want}")

    # ---- report
    gen = sum(len(r["output"]) for r in report["requests"])
    drv = report["loop"]
    caps_n = [c for c, _ in FleetEngine.graphs.values()]
    print(f"[phase 25 (a)] run_soak over gpt3-1.3b bf16 engines ("
          f"{FLEET_ENGINE}), 2 -> up to 4 replicas, trace seed "
          f"{SOAK_TRAFFIC['seed']} ({SOAK_HORIZON_S:.0f} s, base "
          f"{SOAK_TRAFFIC['base_rate_per_s']}/s diurnal + 2 bursts, prompts "
          f"64-1024, 3 cohorts of 256-token prefixes, {FLEET_NEW} new "
          f"tokens): {report['requests_submitted']} requests, "
          f"{report['requests_finished']} finished, lost "
          f"{report['lost_requests']}, burn-feedback drops "
          f"{report['burn_feedback']['dropped']} "
          f"({report['burn_feedback']['dropped_while_page']} during the "
          f"page); wall {report['wall_s']:.2f} s; {gen / report['wall_s']:.1f}"
          f" generated tok/s ({card_line()})")
    print(f"[phase 25 (a)] TTFT p50 {report['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{report['ttft_p99_s'] * 1e3:.1f} ms (bound "
          f"{SOAK_TTFT_BOUND_S:.0f} s); scale events {events}; spawn "
          f"failures {report['spawn_failures']}; redispatched "
          f"{report['redispatched']}; crash failovers {crashes}; chaos "
          + ", ".join(f"{c['action']}@{c['t']:.1f}s" for c in report["chaos"])
          + f"; injected faults fired {sorted(fired)}")
    t_fire = report["slo"]["transitions"][0]["time"]
    print(f"[phase 25 (a)] SLO transitions (s after the first fire) "
          + ", ".join(f"{t['transition']} {t['time'] - t_fire:+.2f} (burn "
                      f"short {t['burn_short']}, long {t['burn_long']})"
                      for t in report["slo"]["transitions"])
          + f"; /profilez captures {len(caps)} slo_page, linked to "
          f"slo:: traces; /healthz 200 after the clear")
    print(f"[phase 25 (a)] host: longest drive-loop gap (a respawn's "
          f"build and capture) {drv['max_gap_s'] * 1e3:.1f} ms; scrape + "
          f"SLO evaluation {drv['observe_s']:.3f} s of {report['wall_s']:.2f}"
          f" s wall ({drv['observe_s'] / report['wall_s']:.4f}) over "
          f"{drv['beats']} beats; time series "
          f"{report['timeseries']['scrapes']} scrapes, "
          f"{report['timeseries']['series']} series")
    print(f"[phase 25 (a)] ragged kernel launches {launches} = {L} x "
          f"{steps} engine steps over {len(caps_n)} engines (captures "
          f"{caps_n}); memory at the last scrape {gauge / 2**30:.3f} GiB, "
          f"{(gauge - want) / 2**20:+.1f} MiB beyond {live} live pools + "
          f"params")
    return launches


def store_plane_on_card(torch, cfg, params, pa, serving, observability):
    """Phase 25 (b): two ``ReplicaServer``s with a 1.3B engine each
    publishing over one ``TCPStore``; a ``FleetRouter`` scoring from
    ``collect_prefix_summaries`` sends a shared-prefix cohort to the
    replica that gossiped the prefix; a kill fails its requests over;
    one telemetry server serves ``/traces?fleet=1`` (one trace per
    failed-over request) and ``/slo?fleet=1``; the device gauge agrees
    with ``torch.cuda.memory_allocated()``.  Returns the ragged
    kernel's launches."""
    import urllib.request

    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability.metrics import (MetricsRegistry,
                                                        default_registry)

    obs = observability
    store = TCPStore(is_master=True, world_size=1)
    reg = MetricsRegistry()
    cohort = serving.TrafficGenerator(vocab_size=cfg.vocab_size,
                                      **SOAK_TRAFFIC).cohort_prefixes[0]
    rng = np.random.RandomState(25)
    pa.ragged_paged_attention.launches = 0
    servers = [serving.ReplicaServer(
        lambda: serving.Engine(cfg, params, device=SOAK_DEVICE,
                               tracer=obs.Tracer(), **FLEET_ENGINE),
        rid, store=store, gossip_interval_s=0.2) for rid in range(2)]
    # replica 1 serves the cohort's prefix once; replica 0 stays cold.
    # Each serve loop ends with a final publish of its summary and ring
    warm = servers[1].engine.add_request(
        list(cohort) + [int(t) for t in rng.randint(0, cfg.vocab_size, 8)],
        serving.SamplingParams(max_new_tokens=4))
    servers[1].serve(should_stop=lambda: not servers[1].engine.has_work())
    servers[0].serve(max_steps=0)
    check(warm.state == serving.RequestState.FINISHED,
          f"replica 1's warm-up request ended {warm.state}")
    router = serving.FleetRouter(
        [srv.engine for srv in servers], registry=reg, tracer=obs.Tracer(),
        prefix_summary_source=lambda: serving.collect_prefix_summaries(
            store, [0, 1]))
    slo_engines = []
    for rid in range(2):
        ts = obs.TimeSeriesStore(registry=default_registry())
        slo_engines.append(obs.SLOEngine(ts, [obs.SLO(
            "replica_goodput", target=0.9,
            good=("serving_requests_finished_total",),
            total=("serving_requests_submitted_total",))],
            registry=MetricsRegistry()))
        ts.scrape_once()
    server = obs.start_telemetry_server(
        port=0, registry=reg, router=router,
        fleet_traces=lambda: obs.collect_fleet_traces(
            store, [0, 1], extra_rings=[("router",
                                          router.tracer.traces())]),
        fleet_slo=lambda: obs.collect_fleet_slo(store, [0, 1]))
    try:
        sp = serving.SamplingParams(max_new_tokens=FLEET_NEW)
        reqs = [router.submit(list(cohort) + [int(t) for t in rng.randint(
            0, cfg.vocab_size, n)], sp) for n in (16, 40, 24, 8)]
        router.step()
        first = reqs[0].replica_id
        hits = router.metrics.snapshot()["cache_aware_dispatches"]
        check(first == 1 and hits >= 1,
              f"the cohort's first request went to replica {first} "
              f"({hits} cache-aware dispatches); replica 1 gossiped the "
              f"prefix")
        for _ in range(400):       # until requests decode on replica 1
            if any(f.replica_id == 1 and f.tokens_out for f in reqs):
                break
            router.step()
        moving = [f for f in reqs if f.replica_id == 1
                  and f.state != serving.FleetRequestState.FINISHED]
        router.kill_replica(1)
        for _ in range(20000):
            if not router.has_work():
                break
            router.step()
        for srv in servers:         # each replica's last gossip beat
            srv.trace_publisher.publish()
        for rid, eng in enumerate(slo_engines):
            eng.store.scrape_once()
            eng.evaluate()
            obs.SLOStatusPublisher(eng, rid, store).publish()
        torch.cuda.synchronize()
        sample = obs.ResourceSampler(registry=reg).sample_once()
        alloc = torch.cuda.memory_allocated()

        def get(path):
            with urllib.request.urlopen(server.url + path,
                                        timeout=10) as resp:
                return resp.read().decode()

        traces = json.loads(get("/traces?fleet=1"))["traces"]
        fleet_slo = json.loads(get("/slo?fleet=1"))
        metrics_text = get("/metrics")
    finally:
        server.stop()
    launches = pa.ragged_paged_attention.launches
    steps = sum(srv.engine.steps for srv in servers)

    # ---- checks
    check(all(f.state == serving.FleetRequestState.FINISHED
              and len(f.output) == FLEET_NEW for f in reqs),
          f"cohort requests ended {[f.state for f in reqs]}")
    check(moving, "no request was aboard replica 1 at its kill")
    ids = [t["trace_id"] for t in traces]
    check(len(ids) == len(set(ids)), "/traces?fleet=1 split a trace")
    # a hard-killed replica never ends its segments: a failed-over
    # request is the router's two dispatches and the failover, and the
    # survivor's segment; replica 1's ring holds what it finished
    moved = [t for t in traces if any(s["name"] == "router::failover"
                                      for s in t["spans"])]
    sources = [{s["source"] for s in t["spans"]} for t in moved]
    check(len(moved) >= len(moving) and all(
        {"router", "replica0"} <= src for src in sources) and all(
        [s["name"] for s in t["spans"]].count("router::dispatch") >= 2
        for t in moved) and any(s["source"] == "replica1" for t in traces
                                for s in t["spans"]),
          f"{len(moving)} requests failed over; /traces?fleet=1 holds "
          f"{len(moved)} failover traces with sources {sources}, replica "
          f"1's ring {'in' if any(s['source'] == 'replica1' for t in traces for s in t['spans']) else 'not in'} the view")
    obj = fleet_slo.get("slos", {}).get("replica_goodput", {})
    check(fleet_slo.get("fleet") is True
          and set(obj.get("replicas", {})) == {"replica0", "replica1"},
          f"/slo?fleet=1 {fleet_slo}")
    gauge = _gauge_of(metrics_text, "torch_cuda_allocated_bytes")
    check(sample["torch_cuda_allocated_bytes"] == alloc and gauge
          is not None and abs(gauge - alloc) <= 1e-8 * alloc,
          f"device gauge {gauge} (sample "
          f"{sample['torch_cuda_allocated_bytes']}) against "
          f"memory_allocated {alloc}")
    check(launches == cfg.num_layers * steps,
          f"ragged launches {launches} != {cfg.num_layers} x {steps}")
    print(f"[phase 25 (b)] two ReplicaServers (gpt3-1.3b bf16) over one "
          f"TCPStore: the cohort's first request went to replica {first} "
          f"(the one that gossiped the 256-token prefix), "
          f"{hits} cache-aware dispatches; the kill moved "
          f"{len(moving)} requests, each one trace on /traces?fleet=1 "
          f"with spans from {sorted(set().union(*sources))} (of "
          f"{len(traces)} merged traces); /slo?fleet=1 "
          f"folds {sorted(obj.get('replicas', {}))}; device gauge "
          f"{gauge:.0f} = memory_allocated {alloc}; ragged launches "
          f"{launches} = {cfg.num_layers} x {steps}")
    for srv in servers:
        srv.engine = None
    del servers, router
    store.close()
    return launches


def phase_soak(torch, cfg, pa, serving, observability):
    """Phase 25: the serving half of the observability plane at
    GPT-3 1.3B: (a) the chaos soak, (b) the store plane.  Returns the
    ragged kernel's launches of each."""
    from paddle_tpu_torch.models import gpt_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = gpt_init(cfg, torch.Generator(device=SOAK_DEVICE).manual_seed(0),
                      device=SOAK_DEVICE)
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - base
    t0 = time.perf_counter()
    soak = soak_on_card(torch, cfg, params, params_bytes, base, pa,
                        serving, observability)
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base - params_bytes
    check(abs(left) <= FLEET_MEM_SLACK,
          f"after the soak {left / 2**20:+.1f} MiB beyond the params: a "
          f"killed or retired engine's pool was kept")
    print(f"[phase 25 (a)] {time.perf_counter() - t0:.1f} s; after the "
          f"soak {left / 2**20:+.1f} MiB beyond the params")
    t0 = time.perf_counter()
    plane = store_plane_on_card(torch, cfg, params, pa, serving,
                                observability)
    print(f"[phase 25 (b)] {time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return soak, plane


class _Background:
    """``fn(*args)`` on a thread; ``result()`` joins it and raises what it
    raised (a failed check included)."""

    def __init__(self, fn, *args):
        import threading

        self._out = {}
        self._t = threading.Thread(target=self._run, args=(fn, args),
                                   daemon=True)
        self._t.start()

    def _run(self, fn, args):
        try:
            self._out["value"] = fn(*args)
        except BaseException as e:       # re-raised in result()
            self._out["error"] = e

    def join(self):
        self._t.join()

    def result(self):
        self._t.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out.get("value")


def phase_rest(torch, fa, cfg=P24, parts="abcde"):
    """Phase 24: the rest of distributed training (see ``P24``); ``parts``
    picks (a) with (e), (b) with (c), and (d).  (a) runs first, alone:
    beside (b)-(d) it saved ~11 s of 177 and loaded the host enough for
    (c)'s watchdog (2 s without progress) to name a rank doing host work
    between two collectives.  Returns the flash launches of (a) (every
    rank's timed steps) and of (b)'s resumed world (rank 0)."""
    from paddle_tpu_torch.distributed.store import TCPStore

    tmp = tempfile.mkdtemp(prefix="phase24_")
    store = TCPStore(is_master=True, world_size=1, timeout=120.0)
    cfg = dict(cfg, store=f"127.0.0.1:{store.port}")
    out = {}
    agent = refs = ps = None
    if "b" in parts:        # started now: they take their time to start
        agent, refs = start_host_agent(cfg, tmp), start_refs(cfg, tmp)
    try:
        if "a" in parts:
            t0 = time.perf_counter()
            out["auto_parallel_launches"] = p24_auto(torch, cfg, tmp, store)
            print(f"[phase 24 (a), (e)] {time.perf_counter() - t0:.1f} s")
        # (d) runs beside (b) and (c): their time is the worlds' starts
        t0 = time.perf_counter()
        ps = _Background(p24_ps, torch, cfg, tmp) if "d" in parts else None
        if "b" in parts:
            out["supervised_launches"] = p24_supervised(torch, cfg, tmp,
                                                        store, agent, refs)
        if ps is not None:
            ps.result()
        print(f"[phase 24 (b), (c), (d)] {time.perf_counter() - t0:.1f} s")
    finally:
        if ps is not None:              # it stops its own processes
            ps.join()
        for proc in ([agent[1]] if agent else []) + \
                [p for p, _ in (refs or {}).values()]:
            _stop(proc)
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------- recompute and the RNG tracker (phase 26)

#: (a): the Paddle-style GPT at GPT-3 1.3B widths, depth cut to 4 of 24
RECOMPUTE = dict(layers=4, batch=2, dropout=0.1, steps=3, lr=1e-4)
#: (b): the tracker's mp group (phase 22 (g)'s 2 ranks over gloo)
TRACKER = dict(ranks=2, hidden=256, ffn=1024, tokens=1024, seed=2600,
               rate=0.1)


def tracker_arrays(c=TRACKER):
    rng = np.random.RandomState(26)
    f = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    return {"w1": f(c["hidden"], c["ffn"]), "b1": f(c["ffn"]),
            "w2": f(c["ffn"], c["hidden"]), "b2": f(c["hidden"]),
            "x": f(c["tokens"], c["hidden"])}


def tracker_on_rank(device="gpu"):
    """Phase 26 (b) on this rank of a 2-rank world (phase 22 (g)'s, after
    its MLP: a world of its own would cost its ~30 s start):
    ``tests/torch_dist_cases.py``'s ``tracker_case``, with its
    seconds."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_dist_cases as dc

    t0 = time.perf_counter()
    res = dc.tracker_case(TRACKER["ranks"], tracker_arrays(),
                          TRACKER["seed"], device=device,
                          rate=TRACKER["rate"])
    res["seconds"] = time.perf_counter() - t0
    return res


def tracker_world(ranks):
    r0 = ranks[0]
    print(f"[phase 26 (b)] RNGStatesTracker over mp {TRACKER['ranks']} "
          f"(gloo, one card; hidden {TRACKER['hidden']}, ffn "
          f"{TRACKER['ffn']}, {TRACKER['tokens']} tokens, dropout "
          f"{TRACKER['rate']}): ColumnParallelLinear -> dropout under "
          f"local_seed -> RowParallelLinear -> dropout under global_seed; "
          f"mask CRCs local {r0['local']}, global {r0['global']}; dropped "
          f"shares {[r['dropped'] for r in ranks]}; losses of two runs "
          f"{[r['losses'] for r in ranks]}; default stream kept "
          f"{[r['default_kept'] for r in ranks]}; "
          f"{[round(r['seconds'], 2) for r in ranks]} s a rank (in phase "
          f"22 (g)'s world, after its MLP)")
    check(all(r["global"] == r0["global"] and r["local"] == r0["local"]
              for r in ranks), "26 (b): the ranks gathered different CRCs")
    check(len(set(r0["global"])) == 1, "26 (b): global_seed masks differ "
                                      "across the mp group")
    check(len(set(r0["local"])) == len(ranks), "26 (b): local_seed masks "
                                               "are equal across ranks")
    check(all(r["losses"][0] == r["losses"][1] for r in ranks) and
          len({r["losses"][0] for r in ranks}) == 1,
          "26 (b): the losses differ between runs or ranks")
    check(all(r["default_kept"] for r in ranks),
          "26 (b): a named stream moved the default stream")


def recompute_step(torch, paddle, prog, fa, model, x, y, amp):
    """One forward and backward from ``paddle.seed(260)``, outside any
    step scope (the plain dygraph loop around ``recompute``): the loss,
    the flash launches, ms (synchronised host clock) and the peak bytes
    above what was allocated before it."""
    for p in model.parameters():
        p.clear_grad()
    paddle.seed(260)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    t0 = time.perf_counter()
    ctx = (paddle.amp.auto_cast(dtype="bfloat16") if amp
           else contextlib.nullcontext())
    with ctx:
        loss = prog.loss_fn(paddle, model, x, y)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (loss.detach(), dict(fa.launches), ms,
            torch.cuda.max_memory_allocated() - base)


def eager_recompute(torch, paddle, prog, fa, nets, state, tokens, labels,
                    layers, dropout):
    """Phase 26 (a), outside any step scope: one forward and backward of
    each of ``nets`` (without and with recompute, loaded with
    ``state``) in fp32 and under bf16 ``auto_cast``: loss and every
    gradient bitwise equal, flash forward launches ``layers`` without
    and twice that with, backward launches equal, the peak lower with
    recompute.  Returns the launches by dtype."""
    x, y = paddle.to_tensor(tokens), paddle.to_tensor(labels)
    for net in nets.values():
        missing, unexpected = net.set_state_dict(state)
        check(not missing and not unexpected,
              f"26 (a): {missing} {unexpected}")
    launches = {}
    for tag, amp in (("fp32", False), ("bf16", True)):
        runs = {rc: recompute_step(torch, paddle, prog, fa, nets[rc], x, y,
                                   amp) for rc in (False, True)}
        grads = [dict(nets[rc].named_parameters()) for rc in (False, True)]
        unequal = sorted(k for k, p in grads[0].items()
                         if not torch.equal(p.grad, grads[1][k].grad))
        (l0, n0, ms0, pk0), (l1, n1, ms1, pk1) = runs[False], runs[True]
        same_loss = torch.equal(l0, l1)
        launches[tag] = {"plain": n0, "recompute": n1}
        print(f"[phase 26 (a)] {tag}, eager outside any step scope (one "
              f"forward + backward each, {layers} layers, dropout "
              f"{dropout}): loss {l0.item():.6f} without recompute, "
              f"{l1.item():.6f} with (bitwise equal: {same_loss}); "
              f"gradients not bitwise equal: {unequal or 'none'} of "
              f"{len(grads[0])}; peak above the step's start "
              f"{pk0 / 2**30:.3f} GiB without, {pk1 / 2**30:.3f} GiB with; "
              f"ms {ms0:.1f} without, {ms1:.1f} with (one run each); flash "
              f"launches {n0} without, {n1} with; {card_line()}")
        check(same_loss and not unequal, f"26 (a) {tag}: recompute changed "
                                         f"the loss or gradients {unequal}")
        check(n1["fwd"] == 2 * n0["fwd"] and n1["bwd"] == n0["bwd"] and
              n0["fwd"] == layers,
              f"26 (a) {tag}: flash launches {n0} without, {n1} with "
              f"recompute")
        check(pk1 < pk0, f"26 (a) {tag}: recompute did not lower the peak")
        del grads
    for net in nets.values():
        for p in net.parameters():
            p.clear_grad()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def pair_offsets(torch, paddle):
    """Phase 26 (a) first: one dropout in a step scope's ``recompute``
    (a segment run twice a step, so both members of its pair draw) in a
    ``CapturedStep`` (an eager run, the capture, 3 replays) against the
    body called directly 4 times: each member's Philox offset after
    each step equal on both routes, the masks and gradients equal step
    for step, the recompute's mask the forward's, and 4 distinct masks.
    Returns the graph route's offsets."""
    from paddle_tpu_torch._captured import CapturedStep
    from paddle_tpu_torch.core import random as rnd
    from paddle_tpu_torch.distributed.recompute import recompute

    drop = paddle.nn.Dropout(0.1)
    x = torch.ones(2, 2048, 2048, device="cuda", requires_grad=True)
    stream = "pair_offsets"

    def body(x):
        with rnd.step_scope(), \
                rnd.get_rng_state_tracker().rng_state(stream):
            y = recompute(drop, x)
            g, = torch.autograd.grad(y.sum(), x)
        return y.detach(), g

    masks, offs = {}, {}
    for route in ("eager", "graph"):
        rnd.seed(2600, stream=stream)
        step = CapturedStep(body, torch.device("cuda"))
        run = body if route == "eager" else step
        masks[route], offs[route] = [], []
        for _ in range(4):
            y, g = run(x)
            masks[route].append((y.clone(), g.clone()))
            pair = rnd._streams[stream].pairs[0]
            offs[route].append([m.get_offset() for m in
                                pair.members[_cuda_key(torch)]])
        step.release()
    ys = [y for y, _ in masks["graph"]]
    same = all(torch.equal(a, b) and torch.equal(c, d)
               for (a, c), (b, d) in zip(masks["eager"], masks["graph"]))
    fwd_is_bwd = all(torch.equal(y, g) for y, g in masks["graph"])
    fresh = not any(torch.equal(ys[i], ys[j]) for i in range(4)
                    for j in range(i))
    print(f"[phase 26 (a)] one dropout(0.1) on [2, 2048, 2048] in a step "
          f"scope's recompute, in a CapturedStep (eager run, capture, 3 "
          f"replays) and called directly 4 times: the pair's members' "
          f"Philox offsets after each step, graph {offs['graph']}, eager "
          f"{offs['eager']}; masks and gradients equal step for step: "
          f"{same}; the recompute's mask is the forward's: {fwd_is_bwd}; "
          f"4 distinct masks: {fresh}; {card_line()}")
    check(offs["eager"] == offs["graph"] and same and fwd_is_bwd and fresh,
          "26 (a): a pair's offsets or masks differ between the graph and "
          "the eager steps")
    return offs["graph"]


def _cuda_key(torch):
    return f"cuda:{torch.cuda.current_device()}"


def hapi_recompute_run(torch, paddle, prog, fa, net, state, tokens, labels,
                       route, amp, lr, ref=None, profile=False):
    """``c['steps']`` hapi ``train_batch`` calls of ``net`` (loaded with
    ``state``; AdamW at ``lr``; ``paddle.seed(260)`` first) on the
    ``route`` ("graph", or "eager": the body called directly).  Per
    step: the loss, the flash launches, ms (the host clock to the loss's
    read), the peak above the step's start (eager: also up to the
    update, after the backward); the gradients and parameters after
    each step are kept (``ref`` None) or held to ``ref``'s (their
    largest difference).  ``profile``: one more step, traced (device ms
    by kind, busy share).  Returns a dict."""
    from paddle_tpu_torch.hapi import Model

    missing, unexpected = net.set_state_dict(state)
    check(not missing and not unexpected, f"26 (a): {missing} {unexpected}")
    model = Model(net)
    opt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                 parameters=net.parameters())

    def loss_fn(out, y):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(out, [-1, out.shape[-1]]),
            paddle.reshape(y, [-1]), ignore_index=-100)

    model.prepare(opt, loss_fn)
    params = dict(net.named_parameters())
    names = list(params)
    grads = [torch.empty_like(params[k]) for k in names]
    apply = opt.apply_gradients_

    out = {"loss": [], "launches": [], "ms": [], "peak": [], "diff": 0.0,
           "kept": [], "bwd_peak": [], "base": 0}

    def recording(ps, gs, *rest):       # into buffers made outside a pool
        if route == "eager":
            out["bwd_peak"].append(torch.cuda.max_memory_allocated()
                                   - out["base"])
        torch._foreach_copy_(grads, [gs[k] for k in names])
        return apply(ps, gs, *rest)

    def step():
        with (paddle.amp.auto_cast(dtype="bfloat16") if amp
              else contextlib.nullcontext()):
            return model.train_batch(tokens, labels)

    opt.apply_gradients_ = recording
    ctx = eager_route(torch, model) if route == "eager" \
        else contextlib.nullcontext()
    with ctx:
        paddle.seed(260)
        for i in range(RECOMPUTE["steps"]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = out["base"] = torch.cuda.memory_allocated()
            zero_counts(fa)
            t0 = time.perf_counter()
            loss, _ = step()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["peak"].append(torch.cuda.max_memory_allocated() - base)
            out["loss"].append(loss)
            out["launches"].append(dict(fa.launches))
            now = grads + [params[k].detach() for k in names]
            if ref is None:
                out["kept"].append([t.clone() for t in now])
            else:
                out["diff"] = max([out["diff"], abs(loss - ref["loss"][i])] + [
                    float((a - b).abs().max())
                    for a, b in zip(now, ref["kept"][i])])
    out["pool"] = model._train_fn.pool_bytes
    out["captures"] = model.captures["train"]
    if profile:
        kinds = {}
        dev, wall = device_window(torch, step, reps=1, kinds=kinds)
        out["traced"] = (f"device {dev:.1f} ms of {wall:.1f} (busy "
                         f"{dev / wall:.3f}): " + ", ".join(
                             f"{k} {v:.1f}" for k, v in sorted(
                                 kinds.items())))
    opt.apply_gradients_ = apply
    del model, opt, grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recompute_program(torch, paddle, fa, gpt_init, cfg, c=RECOMPUTE):
    """Phase 26 (a): the pair offsets (``pair_offsets``), then two
    Paddle-style GPTs (``models/paddle_gpt.py``) with one state and
    residual dropout, one wrapping every block in
    ``distributed.recompute.recompute``: one forward and backward each
    outside any step scope (``eager_recompute``), then through hapi
    ``train_batch`` (AdamW) in fp32 and under bf16 ``auto_cast``, each
    on the graph
    route and the eager route: losses, every gradient and every
    parameter after each step bitwise equal across the four runs, fresh
    masks each step (a graph run at lr 0: its losses differ), flash
    forward launches doubled with recompute; the graph's pool and the
    eager peak with and without recompute, ms a step.  Returns the
    launches a step, by dtype and run."""
    from paddle_tpu_torch.models import paddle_gpt as prog

    paddle.set_device("gpu")
    offsets = pair_offsets(torch, paddle)
    g = dataclasses.replace(cfg, num_layers=c["layers"], dtype="float32",
                            remat="nothing")
    params = gpt_init(g, torch.Generator(device="cuda").manual_seed(26),
                      device="cuda")
    state = prog.gpt_state_from_params(params, g.num_layers)
    tokens = np.random.default_rng(26).integers(
        0, g.vocab_size, (c["batch"], g.max_seq_len)).astype(np.int64)
    labels = prog.next_token_labels(tokens)
    nets = {rc: prog.build_gpt(
        paddle, g.vocab_size, g.hidden, g.num_heads, g.ffn_hidden,
        g.num_layers, g.max_seq_len, dropout=c["dropout"], recompute=rc)
        for rc in (False, True)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"pair_offsets": offsets, "eager": eager_recompute(
        torch, paddle, prog, fa, nets, state, tokens, labels,
        g.num_layers, c["dropout"])}
    card = card_line()
    for tag, amp in (("fp32", False), ("bf16", True)):
        run = functools.partial(hapi_recompute_run, torch, paddle, prog, fa,
                                state=state, tokens=tokens, labels=labels,
                                amp=amp, lr=c["lr"])
        runs = {("graph", False): run(nets[False], route="graph",
                                      profile=True)}
        ref = runs[("graph", False)]
        for key in (("graph", True), ("eager", False), ("eager", True)):
            runs[key] = run(nets[key[1]], route=key[0], ref=ref,
                            profile=key[0] == "graph")
        still = run(nets[True], route="graph", lr=0.0)
        del ref["kept"]
        diff = max(r["diff"] for r in runs.values())
        launches[tag] = {f"{route}_{'recompute' if rc else 'plain'}":
                         r["launches"] for (route, rc), r in runs.items()}
        for (route, rc), r in runs.items():
            print(f"[phase 26 (a)] {tag} hapi train_batch, {route} route, "
                  f"{'recompute' if rc else 'no recompute'}: losses "
                  f"{r['loss']}; ms a step "
                  f"{[round(v, 2) for v in r['ms']]}; peak above the "
                  f"step's start {[round(v / 2**30, 3) for v in r['peak']]}"
                  f" GiB (up to the update "
                  f"{[round(v / 2**30, 3) for v in r['bwd_peak']]}); graph "
                  f"pool {r['pool'] / 2**30:.3f} GiB; flash launches a "
                  f"step {r['launches']}; captures {r['captures']}; a "
                  f"traced 4th step: {r.get('traced', 'not traced')}; "
                  f"{card}")
        print(f"[phase 26 (a)] {tag}: Paddle-style GPT, {g.num_layers} "
              f"layers at GPT-3 1.3B widths, batch {c['batch']} x "
              f"{g.max_seq_len}, residual dropout {c['dropout']}, AdamW "
              f"{c['lr']}, {c['steps']} steps a run: largest difference "
              f"of the losses, all {len(state)} gradients and parameters "
              f"after each step from the graph run without recompute: "
              f"recompute on the graph {runs[('graph', True)]['diff']}, "
              f"eager without {runs[('eager', False)]['diff']}, eager with "
              f"{runs[('eager', True)]['diff']}; lr 0 on the graph with "
              f"recompute: losses {still['loss']} (fresh masks); {card}")
        check(diff == 0, f"26 (a) {tag}: the runs differ by {diff}")
        check(len(set(still["loss"])) == c["steps"],
              f"26 (a) {tag}: the masks repeat at lr 0: {still['loss']}")
        check(all(np.isfinite(r["loss"]).all() and
                  r["loss"][-1] < r["loss"][0] for r in runs.values()),
              f"26 (a) {tag}: a loss did not fall")
        bwd = g.num_layers * (2 if tag == "fp32" else 1)
        for (route, rc), r in runs.items():
            check(all(n["fwd"] == g.num_layers * (2 if rc else 1) and
                      n["bwd"] == bwd for n in r["launches"]),
                  f"26 (a) {tag} {route} recompute={rc}: flash launches "
                  f"{r['launches']}")
            check(r["captures"] == (1 if route == "graph" else 0),
                  f"26 (a) {tag} {route}: {r['captures']} captures")
        check(runs[("graph", True)]["pool"] < runs[("graph", False)]["pool"]
              and runs[("eager", True)]["peak"][-1] <
              runs[("eager", False)]["peak"][-1],
              f"26 (a) {tag}: recompute did not lower the pool or the peak")
    del nets, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_recompute(torch, paddle, fa, gpt_init, cfg, tracker):
    """Phase 26: (a), then (b)'s checks on the ranks' results that phase
    22 (g)'s world returned (``tracker``); returns (a)'s flash
    launches."""
    t0 = time.perf_counter()
    launches = recompute_program(torch, paddle, fa, gpt_init, cfg)
    print(f"[phase 26 (a)] {time.perf_counter() - t0:.1f} s")
    check(tracker is not None, "26 (b): phase 22 (g) did not run")
    tracker_world(tracker)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import importlib

        from paddle_tpu_torch import (distributed, models, observability,
                                      resilience, serving)
        from paddle_tpu_torch.distributed import moe
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import paged_attention as pa
        ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
        from paddle_tpu_torch.models import GPT_CONFIGS, gpt_init, gpt_loss
        from paddle_tpu_torch.models.gpt import gpt_ragged_step
        from paddle_tpu_torch.observability import default_watchdog
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    print(f"[phase 1] built {len(_build.SOURCES)} kernel(s) in "
          f"{prepare(torch):.1f} s")
    for name, log in _build.build_logs().items():
        kernel, spill = "?", ""
        for line in log.splitlines():
            # registers and spills of every kernel, and ptxas's notes on
            # wgmma serialisation or an ignored setmaxnreg
            if "Function properties for " in line:
                kernel = line.split("Function properties for ")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line:
                used = line.split(":", 1)[-1].strip()
                print(f"  {name}: {kernel[:72]}: {used}; {spill}")
            elif "wgmma" in line or "setmaxnreg" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    rpa = phase_kernel_vs_plain(torch, pa)
    print(f"[phase 2] {time.perf_counter() - t0:.1f} s")

    cfg = GPT_CONFIGS["gpt3-1.3b"]
    t0 = time.perf_counter()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    phase_full_step(torch, cfg, params, pa, gpt_ragged_step)
    print(f"[phase 3] {time.perf_counter() - t0:.1f} s")

    # the serving engines' captures are held to one each (phases 4, 11,
    # 12 and 16)
    watchdog = default_watchdog().enable()
    t0 = time.perf_counter()
    launches = phase_serving(torch, cfg, params, pa, serving, watchdog)
    print(f"[phase 4] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_graph_vs_eager(torch, cfg, params, pa, serving, gpt_ragged_step,
                         watchdog, "gpt3-1.3b")
    print(f"[phase 16] gpt3-1.3b {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flash = phase_flash_kernels(torch, fa, ra)
    print(f"[phase 5] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_train_step(torch, cfg, params, fa, gpt_loss)
    print(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flash_launches, loss1 = phase_train_throughput(torch)
    print(f"[phase 7] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ring = phase_ring_pair_kernels(torch, fa, ra)
    print(f"[phase 8] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_ring_vs_flash(torch, fa, ra)
    print(f"[phase 9] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ring_launches, ring_loss1 = phase_train_throughput(
        torch, sep=RING_SEP, tag="phase 10")
    rel = abs(ring_loss1 - loss1) / abs(loss1)
    print(f"[phase 10] step-1 loss: ring sep={RING_SEP} {ring_loss1:.6f}, "
          f"flash (phase 7) {loss1:.6f}, relative difference {rel:.3g} "
          f"(checked at 2e-3)")
    check(rel <= 2e-3, f"ring step-1 loss differs from phase 7's by "
                       f"{rel:.4g} relative")
    print(f"[phase 10] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fleet_launches = phase_fleet(torch, cfg, pa, serving, resilience,
                                 watchdog)
    print(f"[phase 11] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    soak_launches, plane_launches = phase_soak(torch, cfg, pa, serving,
                                               observability)
    print(f"[phase 25] {time.perf_counter() - t0:.1f} s")

    moe_cfg = moe_config(cfg)
    t0 = time.perf_counter()
    phase_moe_step(torch, moe_cfg, pa, moe, gpt_init, gpt_ragged_step)
    moe_params = gpt_init(moe_cfg,
                          torch.Generator(device="cuda").manual_seed(12),
                          device="cuda")
    moe_launches = phase_moe_serving(torch, moe_cfg, moe_params, pa, moe,
                                     serving, watchdog)
    print(f"[phase 12] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    n = GRAPH_MOE_LAYERS
    phase_graph_vs_eager(
        torch, dataclasses.replace(moe_cfg, num_layers=n),
        {**moe_params, "blocks": {k: v[:n] for k, v in
                                  moe_params["blocks"].items()}},
        pa, serving, gpt_ragged_step, watchdog,
        f"gpt3-1.3b x{MOE_EXPERTS} experts, {n} layers")
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase 16] MoE {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    moe_flash = phase_moe_train(torch, moe_cfg, fa, moe, distributed,
                                gpt_init, gpt_loss)
    print(f"[phase 13] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bert_flash, noncausal = phase_bert_train(torch, fa, distributed, models)
    print(f"[phase 14] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    eager_flash = phase_eager(torch, fa)
    print(f"[phase 15] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_train_graph(torch, distributed)
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    predictor_launches, generation_launches = phase_deploy(
        torch, fa, pa, serving, gpt_init, cfg)
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ft_launches, ft_ms, crc = phase_fault_tolerance(torch, fa, ra,
                                                    distributed)
    print(f"[phase 19] {time.perf_counter() - t0:.1f} s")

    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    n_ops = phase_ops_on_card(torch, paddle)
    program_launches = phase_paddle_program(torch, paddle, fa, gpt_init,
                                            gpt_loss, cfg)
    print(f"[phase 20] {time.perf_counter() - t0:.1f} s ({n_ops} ops)")

    t0 = time.perf_counter()
    incubate_launches = phase_domain(torch, paddle, fa)
    print(f"[phase 21] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    hybrid_launches, tracker = phase_hybrid(torch, fa, ra)
    print(f"[phase 22] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    world_launches = phase_worlds(torch, serving)
    print(f"[phase 23] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rest_launches = phase_rest(torch, fa)
    print(f"[phase 24] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    recompute_launches = phase_recompute(torch, paddle, fa, gpt_init, cfg,
                                         tracker)
    print(f"[phase 26] {time.perf_counter() - t0:.1f} s")

    csrc = "paddle_tpu_torch/kernels/csrc/"
    # rows 2 and 3 of the TPU kernels (dK/dV and dQ) are one kernel now:
    # both entries carry its launches and times
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": csrc + "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:117",
        "launches": launches, "fleet_launches": fleet_launches,
        "soak_launches": soak_launches,
        "store_plane_launches": plane_launches,
        "moe_launches": moe_launches,
        "generation_launches": generation_launches, **rpa}] + [
        {"name": f"flash_attention_{name}", "route": "cuda",
         "source": csrc + source,
         "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
         "launches": flash_launches[key], "moe_launches": moe_flash[key],
         "bert_launches": bert_flash[key],
         "eager_launches": eager_flash[key], **flash[key],
         "noncausal_d64": noncausal[key]}
        for name, key, source, line in (
            ("fwd", "fwd", "flash_fwd_sm90.cu", 64),
            ("bwd_dkdv", "bwd", "flash_bwd_sm90.cu", 168),
            ("bwd_dq", "bwd", "flash_bwd_sm90.cu", 215))
    ] + [
        # the TPU's two per-pair kernels (:105 dK/dV, :133 dQ) are one
        # kernel here; its numbers are the full pair's, the diagonal
        # pair's under diagonal_*
        {"name": "ring_pair_bwd", "route": "cuda",
         "source": csrc + "flash_bwd_sm90.cu",
         "replaces": "paddle_tpu/kernels/ring_attention.py:105",
         "also_replaces": "paddle_tpu/kernels/ring_attention.py:133",
         "launches": ring_launches["pair_bwd"], **ring}]
    # the forward kernel also runs every ring pair's forward (phase 10)
    # and the encoder predictors' attention (phase 18)
    kernels[1]["ring_launches"] = ring_launches["fwd"]
    # phase 19: the resumed engine's launches, and the backward's whole
    # call at the determinism check's shapes (every dQ bitwise over 20
    # repeats)
    for entry in kernels[1:4]:
        key = entry["name"].split("_")[2]
        entry["ft_engine_launches"] = ft_launches[
            "fwd" if key == "fwd" else "bwd"]
    for entry in kernels[2:]:
        entry["deterministic_ms"] = {
            k: v for k, v in ft_ms.items()
            if k.startswith("ring") == (entry["name"] == "ring_pair_bwd")}
    kernels[1]["predictor_launches"] = predictor_launches
    # phase 20 (b): the Paddle-style program's bf16 steps
    for entry in kernels[1:4]:
        key = entry["name"].split("_")[2]
        entry["program_launches"] = program_launches[
            "fwd" if key == "fwd" else "bwd"]
    # phase 21 (c): the fused BERT-base encoder's timed steps
    for entry in kernels[1:4]:
        key = entry["name"].split("_")[2]
        entry["incubate_launches"] = incubate_launches[
            "fwd" if key == "fwd" else "bwd"]
    # phase 22: every rank's launches over the timed steps of each world
    # ((a)-(e)) and (f)'s kernel-vs-plain forward and backward
    for entry in kernels[1:4]:
        key = entry["name"].split("_")[2]
        key = "fwd" if key == "fwd" else "bwd"
        entry["hybrid_launches"] = {c: v[key]
                                    for c, v in hybrid_launches.items()}
    # phase 23: every rank's launches over the timed step of (a)-(d) and
    # the timed steps of (g)'s hapi GPT world and, for the ragged kernel,
    # over (e)'s mp engines
    for entry in kernels[1:4]:
        key = "fwd" if entry["name"].endswith("fwd") else "bwd"
        entry["world_launches"] = {c: v[key] for c, v in
                                   world_launches.items()
                                   if c in WORLDS or c == "g"}
    kernels[0]["world_launches"] = {
        f"e_{tag}": n for tag, n in world_launches.get("e", {}).items()}
    # phase 24: (a)'s every rank over its timed steps, (b)'s rank 0 over
    # the resumed steps
    for entry in kernels[1:4]:
        key = "fwd" if entry["name"].endswith("fwd") else "bwd"
        for k, v in rest_launches.items():
            entry[k] = v.get(key)
    # phase 26 (a): one forward + backward outside any step scope, and
    # hapi train_batch's launches a step (3 steps a run), graph and
    # eager routes; each without and with recompute, fp32 and bf16
    for entry in kernels[1:4]:
        key = "fwd" if entry["name"].endswith("fwd") else "bwd"
        entry["recompute_launches"] = {
            tag: {k: n[key] for k, n in v.items()}
            for tag, v in recompute_launches["eager"].items()}
        entry["hapi_recompute_launches"] = {
            tag: {run: [n[key] for n in steps] for run, steps in v.items()}
            for tag, v in recompute_launches.items()
            if tag not in ("pair_offsets", "eager")}
    kernels[1]["hybrid_ring_launches"] = {
        c: v["fwd"] for c, v in hybrid_launches.items() if c in "cf"}
    kernels[4]["hybrid_launches"] = {
        c: v["pair_bwd"] for c, v in hybrid_launches.items() if c in "cf"}
    # the port's own kernel (no Pallas site): the sentinel's digests,
    # replacing the JAX package's host CRC; launches from phase 19 (a),
    # times at 19 (f)'s MLP parameters
    kernels.append({
        "name": "crc32", "route": "cuda", "source": csrc + "crc32.cu",
        "replaces": "paddle_tpu/resilience/integrity.py:83",
        "max_abs_err": 0, **crc})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:3] == ["--child", "fit"]:
        sys.exit(child_fit(sys.argv[3]))
    CHILDREN = {"hybrid": child_hybrid, "hybrid_mlp": child_hybrid_mlp,
                "worlds": child_worlds}
    if sys.argv[1:3] == ["--child", "p24"]:
        sys.exit(child_p24(*sys.argv[3:]))
    if sys.argv[1:2] == ["--child"] and sys.argv[2] in CHILDREN:
        sys.exit(CHILDREN[sys.argv[2]](*sys.argv[3:5]))
    sys.exit(main())
