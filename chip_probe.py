#!/usr/bin/env python3
"""Measurements on the card behind some of the port's records (run from
the repository root on a machine with a CUDA card):

    python3 chip_probe.py gloo            # which gloo collectives take
                                          # CUDA tensors, 2 ranks
    python3 chip_probe.py replay          # hapi's replay split by part
    python3 chip_probe.py sentinel [N]    # the sentinel card test's
                                          # numbers, N fresh processes
    python3 chip_probe.py witness [N]     # the same beside a plain
                                          # PyTorch MLP's graph replay
    python3 chip_probe.py embedding       # whether an embedding's
                                          # gradient repeats bit for bit

``gloo``: two processes on card 0 over gloo try each collective on CUDA
tensors and print what each does (ok, or the error), then time a
64 MiB all-reduce sent as it is and staged through pinned host memory;
the point-to-point sends go last, since gloo aborts the process on a
CUDA ``isend``.  ``replay``: ``hapi.Model.replay_train_batch`` of the
sentinel test's MLP (hidden 1024, batch 128, fp32, Momentum) taken
apart, p50 / p90 / max ms of each part over 60 replays, once on the host
clock alone and once with the device synchronised after each part, with
the garbage collections, captures and allocator growth seen meanwhile.
``sentinel``: the measurement of the card test
``test_sentinel_overhead_under_bound_on_the_card``
(``tests/test_torch_kernels_cuda.py``: the median step of 20,
fingerprint of 9 and replay of 5, and the ratio held to 0.03 there),
printed, in N fresh processes.  ``witness``: in each of N pairs of fresh
processes (their order alternating), the port's measurement as
``sentinel`` and the same MLP in plain PyTorch with none of the port's
code (``bare_once``): whether a replay's stall comes with the port.
``embedding``: 20 backward passes of ``index_select`` (what the port's
embedding once ran) and of ``F.embedding`` (what it runs) on the same ids,
at 256 ids over a vocabulary of 256 (width 128) and at 4096 over 50257
(width 2048): the distinct gradients and their largest difference;
then the card test ``test_captured_hapi_recompute_step_equals_the_eager
_route``'s fp32 model (the Paddle-style GPT, 2 layers, hidden 128) run
twice through hapi's graph over 3 steps with each embedding: the
parameters that differ between the two runs after each step."""
from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


# ------------------------------------------------------------------ gloo


def gloo_rank(rank, world, port):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda:0")
    x = torch.ones(1024, device=dev) * (rank + 1)

    def tryop(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res = "ok"
        except Exception as e:  # noqa: BLE001 - the probe's answer
            res = f"{type(e).__name__}: {str(e)[:160]}"
        print(f"rank {rank} {name}: {res}", flush=True)
        dist.barrier()

    def empty(n=1024):
        return torch.empty(n, device=dev)

    tryop("all_reduce", lambda: dist.all_reduce(x))
    tryop("all_reduce bf16", lambda: dist.all_reduce(x.bfloat16()))
    tryop("broadcast", lambda: dist.broadcast(x, 0))
    tryop("all_gather", lambda: dist.all_gather(
        [empty() for _ in range(world)], x))
    tryop("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        empty(world * 1024), x))
    tryop("reduce_scatter", lambda: dist.reduce_scatter(
        empty(512), list(x.chunk(world))))
    tryop("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        empty(512), x))
    tryop("all_to_all", lambda: dist.all_to_all(
        [empty(512) for _ in range(world)], list(x.chunk(world))))
    tryop("all_to_all_single", lambda: dist.all_to_all_single(empty(), x))
    tryop("reduce", lambda: dist.reduce(x, 0))
    big = torch.ones(16 << 20, device=dev)
    pin = torch.empty(16 << 20, pin_memory=True)
    for name, fn in (("as it is", lambda: dist.all_reduce(big)),
                     ("staged", lambda: (pin.copy_(big), dist.all_reduce(pin),
                                         big.copy_(pin)))):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        print(f"rank {rank} all_reduce of 64 MiB fp32 on CUDA, {name}: "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms", flush=True)
        dist.barrier()

    def p2p():
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, buf, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    tryop("batch_isend_irecv", p2p)


def gloo():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "gloo-rank", str(r),
                               "2", str(port)]) for r in range(2)]
    rcs = [p.wait(timeout=300) for p in procs]
    print(f"rank exit codes {rcs} (a gloo abort on a CUDA send shows here)")


# ------------------------------------------------------------ the replay


def sentinel_model():
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    paddle.seed(0)
    nn = paddle.nn
    model = paddle.Model(nn.Sequential(
        nn.Linear(1024, 1024), nn.ReLU(), nn.Linear(1024, 1024),
        nn.ReLU(), nn.Linear(1024, 10)))
    model.prepare(paddle.optimizer.Momentum(
        learning_rate=0.01, parameters=model.parameters()),
        nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    x = rng.randn(128, 1024).astype(np.float32)
    y = rng.randint(0, 10, (128,)).astype(np.int64)
    return model, x, y


def _pct(ts):
    a = np.asarray(ts) * 1e3
    return {"p50": round(float(np.median(a)), 4),
            "p90": round(float(np.percentile(a, 90)), 4),
            "max": round(float(a.max()), 4)}


def replay_parts(model, snap, batch, n=60, sync=False):
    """``Model.replay_train_batch``'s steps one by one, timed."""
    import torch

    state = model._state()
    names, live = state
    keys = ("snapshot_live", "load_snapshot", "train_call", "loss_read",
            "copy_params", "load_back", "total")
    parts = {k: [] for k in keys}
    collections = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            collections.append((info["generation"],
                                round((time.perf_counter() - on_gc.t) * 1e3,
                                      3)))

    gc.callbacks.append(on_gc)
    captures = model._train_fn.captures
    reserved = torch.cuda.memory_reserved()
    try:
        for _ in range(n):
            t = [time.perf_counter()]

            def mark():
                if sync:
                    torch.cuda.synchronize()
                t.append(time.perf_counter())

            model._replay_live = model.train_state_snapshot(
                into=getattr(model, "_replay_live", None), _state=state)
            mark()
            model._load_train_state(snap, state)
            mark()
            loss, _, _, _ = model._train_call(*batch, snap["lr"])
            mark()
            float(loss)
            mark()
            after = getattr(model, "_replay_params", None)
            params = live[:len(names[0])]
            if after is None:
                after = {k: torch.empty_like(p)
                         for k, p in zip(names[0], params)}
                model._replay_params = after
            with torch.no_grad():
                torch._foreach_copy_(list(after.values()), params)
            mark()
            model._load_train_state(model._replay_live, state)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for k, a, b in zip(keys, t, t[1:]):
                parts[k].append(b - a)
            parts["total"].append(t[-1] - t[0])
    finally:
        gc.callbacks.remove(on_gc)
    return {"parts": {k: _pct(v) for k, v in parts.items()},
            "collections": collections,
            "captures": [captures, model._train_fn.captures],
            "reserved_growth": torch.cuda.memory_reserved() - reserved}


def replay():
    model, x, y = sentinel_model()
    for _ in range(20):
        model.train_batch(x, y)
    snap = model.train_state_snapshot()
    model.replay_train_batch(snap, (x, y))
    for sync in (False, True):
        how = ("device synchronised after each part" if sync
               else "host clock")
        split = replay_parts(model, snap, (x, y), sync=sync)
        print(f"replay split, {how}: {json.dumps(split)}", flush=True)


def sentinel_once():
    """The card test's measurement, printed (its bounds: ratio < 0.03,
    fingerprint < 0.2 s)."""
    from paddle_tpu_torch.resilience.integrity import tree_fingerprint

    model, x, y = sentinel_model()

    def median(fn, n):
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    step = median(lambda: model.train_batch(x, y), 20)
    tree = {"params": dict(model.network.named_parameters())}
    fp = median(lambda: tree_fingerprint(tree), 9)
    snap = model.train_state_snapshot()
    replays = []

    def replay():
        t0 = time.perf_counter()
        model.replay_train_batch(snap, (x, y))
        replays.append(time.perf_counter() - t0)

    rp = median(replay, 5)
    five = [round(t * 1e3, 3) for t in replays[1:]]
    replays.clear()
    for _ in range(60):
        replay()
    ratio = (fp / 25 + rp / 100) / step
    print(f"step {step * 1e3:.4f} ms, fingerprint {fp * 1e3:.4f} ms, replay "
          f"{rp * 1e3:.4f} ms (replays {five}), ratio {ratio:.4f} "
          f"({'under' if ratio < 0.03 and fp < 0.2 else 'OVER'} the bound); "
          f"60 more replays {json.dumps(_pct(replays))}", flush=True)


# ---------------------------------------------- the replay without the port


def bare_once():
    """The card test's measurement on the same MLP written in plain
    PyTorch, with none of the port's code: ``nn.Linear`` layers, SGD with
    momentum, the step (input from a pinned buffer, forward, backward,
    update) captured as one CUDA graph.  A train step is the input copy,
    the graph's replay and the loss read; a replay is what
    ``Model.replay_train_batch`` does around that train step (the live
    state and the device generator's state copied out, the snapshot
    copied in, the step, the params copied, the live state copied
    back).  Printed as ``sentinel_once`` prints, with the fingerprint
    left out (its time is the port's own)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    torch.manual_seed(0)
    dev = torch.device("cuda")
    net = nn.Sequential(nn.Linear(1024, 1024), nn.ReLU(),
                        nn.Linear(1024, 1024), nn.ReLU(),
                        nn.Linear(1024, 10)).to(dev)
    opt = torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9)
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(128, 1024).astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, 10, (128,)).astype(np.int64))
    x, y = torch.empty_like(xs, device=dev), torch.empty_like(ys, device=dev)
    px, py = xs.pin_memory(), ys.pin_memory()
    gen = torch.Generator(device=dev)

    def body():
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        return loss

    x.copy_(xs)
    y.copy_(ys)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = body()

    def train():
        px.copy_(xs)
        py.copy_(ys)
        x.copy_(px, non_blocking=True)
        y.copy_(py, non_blocking=True)
        graph.replay()
        return float(loss.detach())

    params = list(net.parameters())
    live = params + [opt.state[p]["momentum_buffer"] for p in params]
    snap = [t.detach().clone() for t in live]
    keep = [torch.empty_like(t) for t in live]
    after = [torch.empty_like(p) for p in params]

    @torch.no_grad()
    def replay():
        torch._foreach_copy_(keep, live)
        state = gen.get_state()
        torch._foreach_copy_(live, snap)
        train()
        torch._foreach_copy_(after, params)
        torch._foreach_copy_(live, keep)
        gen.set_state(state)

    def median(fn, n):
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), ts

    step, _ = median(train, 20)
    with torch.no_grad():
        torch._foreach_copy_(snap, live)
    rp, ts = median(replay, 5)
    more = median(replay, 60)[1]
    print(f"bare: step {step * 1e3:.4f} ms, replay {rp * 1e3:.4f} ms "
          f"(replays {[round(t * 1e3, 3) for t in ts]}), replay ratio "
          f"{rp / 100 / step:.4f}; 60 more replays {json.dumps(_pct(more))}",
          flush=True)


# ------------------------------------------------------------- embedding


def _index_select_embedding(ids, weight, padding_idx=None, sparse=False):
    import torch

    return torch.index_select(weight, 0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(weight.shape[1:]))


def _hapi_twice(paddle, prog):
    """Two graph runs of 3 hapi steps of the card test's fp32 model from
    one state and seed: ``{step: {param: largest difference}}`` of the
    parameters that differ."""
    V, D, H, FFN, L, S = 256, 128, 2, 512, 2, 128
    paddle.seed(24)
    state = {k: v.detach().clone() for k, v in prog.build_gpt(
        paddle, V, D, H, FFN, L, S).state_dict().items()}
    tokens = np.random.default_rng(24).integers(0, V, (2, S))
    labels = prog.next_token_labels(tokens)

    def loss_fn(out, y):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(out, [-1, V]), paddle.reshape(y, [-1]),
            ignore_index=-100)

    runs = []
    for _ in range(2):
        net = prog.build_gpt(paddle, V, D, H, FFN, L, S, dropout=0.1,
                             recompute=True)
        net.set_state_dict(state)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=net.parameters()), loss_fn)
        paddle.seed(24)
        steps = []
        for _ in range(3):
            model.train_batch(tokens, labels)
            steps.append({k: p.detach().clone()
                          for k, p in net.named_parameters()})
        runs.append(steps)
    return {i: {k: float((a[k] - b[k]).abs().max()) for k in a
                if not bool((a[k] == b[k]).all())}
            for i, (a, b) in enumerate(zip(*runs))}


def embedding():
    import torch
    import torch.nn.functional as F

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import paddle_gpt as prog

    dev = torch.device("cuda")
    paddle.set_device("gpu")
    for V, N, width in ((256, 256, 128), (50257, 4096, 2048)):
        rng = np.random.default_rng(24)
        ids = torch.from_numpy(rng.integers(0, V, N)).to(dev)
        w = torch.randn(V, width, device=dev, requires_grad=True)
        go = torch.randn(N, width, device=dev)
        grads = {}
        for name, fn in (("index_select", _index_select_embedding),
                         ("F.embedding", lambda i, w: F.embedding(i, w))):
            gs = [torch.autograd.grad(fn(ids, w), w, go)[0]
                  for _ in range(20)]
            grads[name] = gs[0]
            print(f"ids {N} over {V}, width {width}: {name} backward, "
                  f"{len({g.cpu().numpy().tobytes() for g in gs})} "
                  f"distinct gradients of 20, largest difference "
                  f"{max(float((g - gs[0]).abs().max()) for g in gs)}",
                  flush=True)
        print(f"  index_select against F.embedding, largest difference "
              f"{float((grads['index_select'] - grads['F.embedding']).abs().max())}",
              flush=True)
    # the port's embedding calls F.embedding through the module: swapped
    # for index_select, it is the embedding as it once was
    port = F.embedding
    for name, fn in (("index_select", _index_select_embedding),
                     ("F.embedding", port)):
        F.embedding = fn
        try:
            print(f"hapi graph twice with {name}: parameters that differ "
                  f"after each step {_hapi_twice(paddle, prog)}",
                  flush=True)
        finally:
            F.embedding = port


def main():
    sys.path.insert(0, ROOT)
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "gloo-rank":
        gloo_rank(*(int(a) for a in sys.argv[2:5]))
        return 0
    if mode == "sentinel-once":
        sentinel_once()
        return 0
    if mode == "bare-once":
        bare_once()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(_card())
    if mode == "gloo":
        gloo()
    elif mode == "replay":
        replay()
    elif mode == "embedding":
        embedding()
    elif mode in ("sentinel", "witness"):
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 10
        for i in range(n):
            runs = ["sentinel-once"] + (["bare-once"] if mode == "witness"
                                        else [])
            for run in runs[::-1] if i % 2 else runs:
                subprocess.run([sys.executable, __file__, run], check=True,
                               cwd=ROOT)
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
