"""Case functions the ranks of ``torch_world.World`` run (jax-free): each
builds what it needs from its arguments (numpy arrays and plain dicts),
runs on this rank and returns numpy results.  A rank outside the case's
grid returns None."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paddle_tpu_torch.distributed import (BertAdapter, EngineConfig,
                                          HybridCommunicateGroup,
                                          HybridEngine, collective,
                                          get_rank)
from paddle_tpu_torch.models import (BERT_CONFIGS, GPT_CONFIGS,
                                     params_from_jax, params_to_numpy)


def outside(axes):
    """True on a rank outside the grid ``axes`` (over ranks 0..n-1) of a
    larger world, after making the grid's groups with the others (every
    rank makes every group)."""
    n = int(np.prod(list(axes.values())))
    if get_rank() < n:
        return False
    HybridCommunicateGroup(**{f"{a}_degree": v for a, v in axes.items()},
                           ranks=list(range(n)))
    return True


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------------------------ the engine


def model_of(spec):
    """The model adapter or config a spec names: ``("gpt" | "bert",
    base config name, field overrides)``."""
    kind, base, kw = spec
    if kind == "bert":
        return BertAdapter(dataclasses.replace(BERT_CONFIGS[base], **kw))
    return dataclasses.replace(GPT_CONFIGS[base], **kw)


def engine_steps(model, axes, params, tokens, labels, steps=3, lr=1e-3,
                 ec=None, dropout=False, out="params"):
    """``steps`` engine steps on the grid ``axes`` (over ranks 0..n-1)
    from the full ``params`` tree; returns the losses and, per ``out``,
    the gathered params (``"params"``), this rank's shards
    (``"shards"``) or both, and the engine's collective byte counts."""
    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       engine_cfg=EngineConfig(**(ec or {})),
                       ranks=list(range(n)))
    dtype = eng.cfg.torch_dtype()
    local = eng.shard_params(params_from_jax(params, device="cpu",
                                             dtype=dtype))
    opt = eng.init_opt(local)
    collective.reset_collective_stats()
    losses = []
    for i in range(steps):
        local, opt, loss = eng.step(local, opt, tokens, labels, lr=lr,
                                    dropout_seed=i if dropout else 0)
        losses.append(float(loss))
    res = {"losses": losses, "coords": dict(eng.coords),
           "stats": collective.collective_stats()}
    if out in ("params", "both"):
        res["params"] = params_to_numpy(eng.gather_params(local))
    if out in ("shards", "both"):
        res["shards"] = params_to_numpy(local)
    return res


def dropout_masks(model, axes, params, tokens, labels):
    """The embedding dropout mask this rank draws in its first step
    (``engine._dropout`` on ones at the embedding's seed), with its grid
    coordinates."""
    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       ranks=list(range(n)))
    seen = {}
    orig = eng._dropout

    def spy(x, rate, seed):
        y = orig(x, rate, seed)
        if "mask" not in seen and seed is not None and rate > 0:
            seen["mask"] = _np(y != 0)
            seen["seed"] = int(seed) if not isinstance(
                seed, torch.Tensor) else int(seed.item())
        return y

    eng._dropout = spy
    local = eng.shard_params(params_from_jax(params, device="cpu"))
    opt = eng.init_opt(local)
    eng.step(local, opt, tokens, labels, lr=1e-3, dropout_seed=7)
    return {"coords": dict(eng.coords), **seen}


# ------------------------------------------------------- the collectives


def _group(n):
    """The group of ranks 0..n-1 (every rank makes it)."""
    return collective.new_group(list(range(n)))


def collective_case(op, n, inputs, kw):
    """``op`` over the group of ranks 0..n-1 on this rank's input (its
    index in ``inputs``); None outside the group."""
    g = _group(n)
    me = get_rank()
    if me >= n:
        return None
    x = torch.from_numpy(np.array(inputs[me]))
    C = collective
    if op.startswith("all_reduce_"):
        return C.all_reduce(x, op=op.split("_")[-1], group=g).numpy()
    if op == "reduce":
        return C.reduce(x, dst=1, group=g).numpy()
    if op == "all_gather":
        return C.all_gather(x, group=g, **kw).numpy()
    if op == "all_gather_list":
        return np.stack([t.numpy() for t in C.all_gather([], x, group=g)])
    if op == "broadcast":
        return C.broadcast(x, src=kw["src"], group=g).numpy()
    if op == "scatter":
        return C.scatter(x[0], tensor_list=list(x), src=0, group=g).numpy()
    if op == "reduce_scatter":
        return C.reduce_scatter(x, group=g).numpy()
    if op == "all_to_all":
        return C.all_to_all(x, group=g, **kw).numpy()
    if op == "all_to_all_list":
        return np.stack([t.numpy() for t in C.all_to_all(list(x),
                                                         group=g)])
    if op == "ppermute":
        return C.ppermute(x, [tuple(p) for p in kw["perm"]],
                          group=g).numpy()
    if op == "split":
        return C.split(x, n, axis=kw["axis"], group=g).numpy()
    raise ValueError(op)


def send_recv_barrier(n):
    """Rank i sends its rank number to rank (i + 1) % n and receives the
    previous one's; then a barrier.  Returns what arrived."""
    g = _group(n)
    me = get_rank()
    if me >= n:
        return None
    got = torch.zeros(3)
    mine = torch.full((3,), float(me))
    if me % 2 == 0:
        collective.send(mine, dst=(me + 1) % n, group=g)
        collective.recv(got, src=(me - 1) % n, group=g)
    else:
        collective.recv(got, src=(me - 1) % n, group=g)
        collective.send(mine, dst=(me + 1) % n, group=g)
    collective.barrier(group=g)
    return got.numpy()


def env_and_groups(degrees):
    """``ParallelEnv`` of this rank, and the ranks of its group along each
    axis of ``HybridCommunicateGroup(**degrees)``."""
    from paddle_tpu_torch.distributed import ParallelEnv

    hcg = HybridCommunicateGroup(**degrees)
    env = ParallelEnv()
    groups = {a: hcg.group_over((a,)).ranks for a in
              ("dp", "pp", "sharding", "sep", "ep", "mp")}
    return {"rank": env.rank, "world_size": env.world_size,
            "local_rank": env.local_rank, "device": str(env.device),
            "nranks": env.nranks, "groups": groups,
            "coords": hcg.coords,
            "check": hcg.get_check_parallel_group().ranks}


def mesh_round_trip(dp, mp, tree, specs):
    """``shard_tree`` of the full ``tree`` on a (dp, mp) mesh, each shard
    checked by ``assert_placement``, and ``gather_tree`` back; then
    ``shard_params`` (the rule table) and ``shard_batch`` of the same
    tree."""
    from paddle_tpu_torch.distributed import mesh

    m = mesh.build_mesh(dp=dp, mp=mp)
    specs = {k: mesh.P(*v) for k, v in specs.items()}
    full = {k: torch.from_numpy(v) for k, v in tree.items()}
    local = mesh.shard_tree(full, m, specs)
    for k in local:
        mesh.assert_placement(local[k], full[k].shape, m, specs[k], name=k)
    back = mesh.gather_tree(local, m, specs)
    report = mesh.placement_report(local, full, m, specs)
    ruled = mesh.shard_params(full, m)
    rows = mesh.shard_batch(m, full["both"])
    return {"shapes": {k: list(v.shape) for k, v in local.items()},
            "back": {k: v.numpy() for k, v in back.items()},
            "report": report,
            "ruled": {k: v.numpy() for k, v in ruled.items()},
            "rows": rows.numpy(), "coords": m.coords}


# ------------------------------------------------------ tensor parallel


def mp_layers_case(n, arrays):
    """The tensor-parallel layers over ranks 0..n-1 on this rank's shards
    of the full weights in ``arrays``: outputs, the input's gradient and
    this rank's weight gradients (loss: the sum of the outputs; the CE
    loss: the mean over labelled tokens)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import mp_layers as M

    g = _group(n)
    me = get_rank()
    if me >= n:
        return None
    paddle.set_device("cpu")
    a = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    out = {}

    def mine(t, dim):
        return t.chunk(n, dim=dim)[me].clone()

    # column (no gather) + row (parallel input): the dense MLP
    col = M.ColumnParallelLinear(8, 16, gather_output=False, mp_group=g)
    row = M.RowParallelLinear(16, 8, input_is_parallel=True, mp_group=g)
    with torch.no_grad():
        col.weight.copy_(mine(a["w1"], 1))
        col.bias.copy_(mine(a["b1"], 0))
        row.weight.copy_(mine(a["w2"], 0))
        row.bias.copy_(a["b2"])
    x = a["x"].clone().requires_grad_(True)
    y = row(col(x))
    gx, gw1, gb1, gw2, gb2 = torch.autograd.grad(
        y.sum(), [x, col.weight, col.bias, row.weight, row.bias])
    out["mlp"] = y.detach().numpy()
    out["mlp_grads"] = [t.numpy() for t in (gx, gw1, gb1, gw2, gb2)]
    # column with gathered output
    colg = M.ColumnParallelLinear(8, 16, has_bias=False, gather_output=True,
                                  mp_group=g)
    with torch.no_grad():
        colg.weight.copy_(mine(a["w1"], 1))
    x = a["x"].clone().requires_grad_(True)
    y = colg(x)
    out["col_gather"] = y.detach().numpy()
    out["col_gather_grads"] = [t.numpy() for t in torch.autograd.grad(
        (y * a["wy"]).sum(), [x, colg.weight])]
    # row splitting its (whole) input
    rowu = M.RowParallelLinear(16, 8, has_bias=False,
                               input_is_parallel=False, mp_group=g)
    with torch.no_grad():
        rowu.weight.copy_(mine(a["w2"], 0))
    h = a["h"].clone().requires_grad_(True)
    y = rowu(h)
    out["row_split"] = y.detach().numpy()
    out["row_split_grads"] = [t.numpy() for t in torch.autograd.grad(
        (y * a["wz"]).sum(), [h, rowu.weight])]
    # vocab-parallel embedding
    emb = M.VocabParallelEmbedding(16, 6, mp_group=g)
    with torch.no_grad():
        emb.weight.copy_(mine(a["table"], 0))
    ids = torch.from_numpy(np.array(arrays["ids"])).long()
    e = emb(ids)
    out["embed"] = e.detach().numpy()
    out["embed_grad"] = torch.autograd.grad(
        (e * a["we"]).sum(), [emb.weight])[0].numpy()
    # vocab-parallel cross entropy
    logits = mine(a["logits"], -1).requires_grad_(True)
    labels = torch.from_numpy(np.array(arrays["labels"])).long()
    ce = M.ParallelCrossEntropy(mp_group=g)(logits, labels)
    mask = (labels != -100).float()
    loss = (ce * mask).sum() / mask.sum()
    out["ce"] = ce.detach().numpy()
    out["ce_grad"] = torch.autograd.grad(loss, [logits])[0].numpy()
    return out


def tracker_case(n, arrays, seed, device="cpu", rate=0.1):
    """Megatron's dropout discipline over an mp group of ranks 0..n-1:
    ``ColumnParallelLinear`` -> dropout under ``rng_state("local_seed")``
    -> ``RowParallelLinear`` -> dropout under ``rng_state("global_seed")``,
    with ``add("global_seed", seed)`` on every rank and
    ``add("local_seed", seed + 1 + rank)`` (the tracker refuses a seed
    twice, so rank 0's local seed cannot be ``seed`` itself).  Run twice
    from the same seeds.  Returns every rank's CRC-32 of its local and
    global masks (all-gathered), the losses of both runs, and whether the
    default stream's generator and key were left as they were."""
    import zlib

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import random as R
    from paddle_tpu_torch.distributed import mp_layers as M

    g = _group(n)
    me = get_rank()
    if me >= n:
        return None
    dev = paddle.set_device(device)
    a = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()}
    hidden, ffn = a["w1"].shape
    col = M.ColumnParallelLinear(hidden, ffn, gather_output=False,
                                 mp_group=g)
    row = M.RowParallelLinear(ffn, hidden, input_is_parallel=True,
                              mp_group=g)
    with torch.no_grad():
        col.weight.copy_(a["w1"].chunk(n, dim=1)[me])
        col.bias.copy_(a["b1"].chunk(n, dim=0)[me])
        row.weight.copy_(a["w2"].chunk(n, dim=0)[me])
        row.bias.copy_(a["b2"])
    F = paddle.nn.functional
    tracker = R.get_rng_state_tracker()
    default_gen = R.generator(dev).get_state()
    default_key = R.current_key()

    def run():
        tracker.reset()
        tracker.add("global_seed", seed)
        tracker.add("local_seed", seed + 1 + me)
        h = col(a["x"])
        with tracker.rng_state("local_seed"):
            h = F.dropout(h, rate)
        y = row(h)
        with tracker.rng_state("global_seed"):
            y = F.dropout(y, rate)
        loss = (y * y).mean()
        loss.backward()
        return loss.item(), (h == 0), (y == 0)

    first, local, glob = run()
    second = run()[0]
    digests = torch.tensor(
        [zlib.crc32(m.cpu().numpy().tobytes()) for m in (local, glob)],
        dtype=torch.int64, device=dev)
    every = collective.all_gather(digests, group=g).reshape(n, 2).tolist()
    return {"local": [d[0] for d in every], "global": [d[1] for d in every],
            "dropped": [float(local.float().mean()),
                        float(glob.float().mean())],
            "losses": [first, second],
            "default_kept": bool(torch.equal(
                R.generator(dev).get_state(), default_gen) and torch.equal(
                R.current_key(), default_key))}


# ------------------------------------------------------------------ fleet


def fleet_init_case(hybrid):
    """``fleet.init`` with ``hybrid`` degrees: the degrees it settles on,
    the parallel mode and this rank's dp group."""
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(hybrid)
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    return {"degrees": dict(s.hybrid_configs),
            "mode": hcg.get_parallel_mode(),
            "dp_group": hcg.get_data_parallel_group().ranks,
            "worker": (fleet.fleet.worker_index(), fleet.fleet.worker_num())}


def _mlp(paddle, seed):
    paddle.seed(seed)
    nn = paddle.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def fleet_train_case(knob, x, y, steps=3):
    """``fleet.init(dp over the world)``, ``distributed_model`` (a
    ``DataParallel``) and ``distributed_optimizer`` with ``knob`` set on
    the strategy (None: the plain mean sync); each rank trains on its
    rows of ``x``.  Returns the losses, the grads of the first step after
    the sync and the final params."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet

    paddle.set_device("cpu")
    s = fleet.DistributedStrategy()
    if knob:
        setattr(s, knob, True)
    if knob == "localsgd":
        s.localsgd_configs["k_steps"] = 2
    if knob == "dgc":
        s.dgc_configs.update(sparsity=0.25, momentum=0.0)
    fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(_mlp(paddle, 7))
    opt = fleet.distributed_optimizer(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    n, me = fleet.fleet.worker_num(), fleet.fleet.worker_index()
    b = len(x) // n
    xs = torch.from_numpy(np.array(x[me * b:(me + 1) * b]))
    ys = torch.from_numpy(np.array(y[me * b:(me + 1) * b])).long()
    losses, first = [], None
    for _ in range(steps):
        loss = torch.nn.functional.cross_entropy(model(xs), ys)
        loss.backward()
        if knob is None and first is None:
            # what DataParallel's reducer gives, before the optimizer's
            # own (idempotent on equal grads) sync
            model.apply_collective_grads()
            first = [p.grad.numpy().copy() for p in model.parameters()]
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": losses, "first_grads": first,
            "params": [p.detach().numpy().copy()
                       for p in model.parameters()]}


def meta_sync_case(kind, grads):
    """One sync of ``kind`` (``GradSync``, ``BF16AllreduceSync``,
    ``DGCSync``) over the world on this rank's gradients ``grads[rank]``:
    the synced gradients (and DGC's residuals)."""
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as M

    me = get_rank()
    ps = []
    for g in grads[me]:
        p = torch.nn.Parameter(torch.zeros(g.shape))
        p.grad = torch.from_numpy(np.array(g))
        ps.append(p)
    sync = {"plain": M.GradSync(), "bf16": M.BF16AllreduceSync(),
            "dgc": M.DGCSync(sparsity=0.25, momentum=0.0)}[kind]
    sync.sync(ps)
    out = {"grads": [p.grad.numpy() for p in ps]}
    if kind == "dgc":
        out["residual"] = [sync._v[id(p)].numpy() for p in ps]
    return out


# ------------------------------------------------ pipeline and ZeRO-3


def pipeline_stats(model, axes, params, tokens, labels, ec):
    """One engine step on the grid ``axes``: the pipeline loop's record
    (``live_peak``: the most microbatch inputs a stage held at once)."""
    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       engine_cfg=EngineConfig(**ec), ranks=list(range(n)))
    local = eng.shard_params(params_from_jax(params, device="cpu"))
    eng.step(local, eng.init_opt(local), tokens, labels, lr=1e-3)
    return dict(eng.pipeline_stats)


def state_bytes(model, axes, params, ec):
    """Bytes of this rank's params and optimizer state (the persistent
    per-rank state) and the local shape of ``blocks/qkv_w``."""
    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       engine_cfg=EngineConfig(**ec), ranks=list(range(n)))
    local = eng.shard_params(params_from_jax(params, device="cpu"))
    opt = eng.init_opt(local)

    def size(tree):
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        return tree.numel() * tree.element_size() if isinstance(
            tree, torch.Tensor) else 0

    return {"bytes": size(local) + size(opt["slots"]),
            "qkv_w": list(local["blocks"]["qkv_w"].shape)}


# ------------------------------------------------- pp_layers and fleet


def cnn_descs(nn):
    """The AlexNet-style conv stack of ``tests/test_pp_layers.py``."""
    from paddle_tpu_torch.distributed.pp_layers import LayerDesc

    return [LayerDesc(nn.Conv2D, 1, 6, 5, padding=2), LayerDesc(nn.ReLU),
            LayerDesc(nn.MaxPool2D, kernel_size=2, stride=2),
            LayerDesc(nn.Conv2D, 6, 16, 5), LayerDesc(nn.ReLU),
            LayerDesc(nn.MaxPool2D, kernel_size=2, stride=2),
            LayerDesc(nn.Flatten), LayerDesc(nn.Linear, 16 * 5 * 5, 64),
            LayerDesc(nn.ReLU), LayerDesc(nn.Linear, 64, 10)]


def tied_descs(nn):
    """A tied layer on the first and the last stage."""
    from paddle_tpu_torch.distributed.pp_layers import (LayerDesc,
                                                        SharedLayerDesc)

    return [SharedLayerDesc("tied", nn.Linear, 16, 16), LayerDesc(nn.ReLU),
            LayerDesc(nn.Linear, 16, 16),
            SharedLayerDesc("tied", nn.Linear, 16, 16)]


def pipeline_layers_case(kind, stages, seg, state, x, y, M, lr, steps=3,
                         fleet_mode=False):
    """``steps`` ``PipelineEngine.train_batch`` steps of the ``kind``
    layer list (``"cnn"`` or ``"tied"``) over ``stages`` ranks from the
    logical per-layer ``state``: the losses and the engine's final
    state (this rank's entries).  ``fleet_mode``: built through
    ``fleet.init(pp_degree=stages)`` and ``fleet.distributed_model``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pp_layers import (PipelineEngine,
                                                        PipelineLayer)

    paddle.set_device("cpu")
    nn = paddle.nn
    descs = (cnn_descs if kind == "cnn" else tied_descs)(nn)
    loss = nn.CrossEntropyLoss() if kind == "cnn" else nn.MSELoss()
    if fleet_mode:
        s = fleet.DistributedStrategy()
        s.hybrid_configs["pp_degree"] = stages
        s.pipeline_configs["accumulate_steps"] = M
        fleet.init(is_collective=True, strategy=s)
        hcg = fleet.get_hybrid_communicate_group()
        eng = fleet.distributed_model(PipelineLayer(
            descs, loss_fn=loss, seg_method=seg, topology=hcg))
    else:
        axes = {"pp": stages}
        if outside(axes):
            return None
        hcg = HybridCommunicateGroup(pp_degree=stages,
                                     ranks=list(range(stages)))
        eng = PipelineEngine(
            PipelineLayer(descs, num_stages=stages, loss_fn=loss,
                          seg_method=seg, stage=hcg.get_stage_id()),
            num_microbatches=M, group=hcg.get_pipe_parallel_group())
    eng.load_state(state)
    losses = []
    collective.reset_collective_stats()
    for _ in range(steps):
        _, l = eng.train_batch(x, y, lr=lr)
        losses.append(float(l))
    return {"losses": losses, "type": type(eng).__name__,
            "stage": eng.stage, "bounds": eng.pl.segment_bounds(),
            "state": [{k: _np(v) for k, v in d.items()}
                      for d in eng.state()],
            "bytes": collective.collective_stats()["bytes"]}


def stage_executor_case(port, data, target, w0, w1, steps=5, lr=0.05):
    """``tests/test_fleet_executor.py``'s two-process pipeline on ranks
    0 and 1 of the world: stage 0 ``tanh(x @ w0)``, stage 1 the MSE of
    ``h @ w1``, streaming over a ``TCPStore`` message bus; returns the
    last stage's losses and each stage's final weight."""
    from paddle_tpu_torch.distributed.fleet_executor import (
        MessageBus, PipelineStageExecutor)
    from paddle_tpu_torch.distributed.store import TCPStore

    rank = get_rank()
    if rank > 1:
        return None
    store = TCPStore("127.0.0.1", port, is_master=rank == 0, world_size=2)
    bus = MessageBus(store)
    if rank == 0:
        ex = PipelineStageExecutor(
            lambda p, x: torch.tanh(x @ p[0]),
            [torch.from_numpy(np.array(w0))], 0, 2, bus, lr=lr)
        for _ in range(steps):
            ex.train_batch([torch.from_numpy(np.array(d)) for d in data])
        return {"w": _np(ex.params[0])}
    ex = PipelineStageExecutor(
        None, [torch.from_numpy(np.array(w1))], 1, 2, bus, lr=lr,
        loss_fn=lambda p, x, y: ((x @ p[0] - y) ** 2).mean())
    losses = [ex.train_batch(None, labels=[np.array(t) for t in target])
              for _ in range(steps)]
    return {"losses": losses, "w": _np(ex.params[0])}


# ------------------------------------------------------- mesh serving


def mesh_serving_case(cfg_kw, params, prompts, sp_kw, axes, engine_kw):
    """``Engine(mesh=build_mesh(**axes))`` on this rank from the full
    ``params`` tree: the generated tokens, the pool's and ``qkv_w``'s
    local shapes, the steps and the collective calls by op."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.serving import Engine, SamplingParams

    n = int(np.prod(list(axes.values())))
    if get_rank() >= n:
        mesh_mod.build_mesh(**axes)      # every rank makes every group
        return None
    mesh = mesh_mod.build_mesh(**axes)
    eng = Engine(GPTConfig(**cfg_kw), params_from_jax(params, device="cpu"),
                 device="cpu", mesh=mesh, **engine_kw)
    collective.reset_collective_stats()
    out = eng.generate(prompts, SamplingParams(**sp_kw))
    return {"tokens": out, "coords": dict(mesh.coords),
            "pool": list(eng.cache.k_pages.shape),
            "qkv_w": list(eng.params["blocks"]["qkv_w"].shape),
            "steps": eng.steps,
            "calls": collective.collective_stats()["calls"]}


# ------------------------------------------------------ hapi over a world


def hapi_mesh_case(weights, x, y, mesh_axes, rules, epochs=3, lr=0.1,
                   bs=16, opt="sgd"):
    """``Model.prepare(device_mesh=...)`` (``"auto"``, or a mesh of
    ``mesh_axes`` with ``rules``) on the toy 8-16-2 MLP from ``weights``,
    ``fit`` over ``(x, y)``: the epoch losses, the final params, this
    rank's slot shapes and its owned windows' keys."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.hapi import Model

    paddle.set_device("cpu")
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    net.set_state_dict({k: np.array(v) for k, v in weights.items()})
    model = Model(net)
    o = (paddle.optimizer.SGD(learning_rate=lr, parameters=net.parameters())
         if opt == "sgd" else paddle.optimizer.Adam(
             learning_rate=lr, parameters=net.parameters()))
    mesh = "auto" if mesh_axes is None else mesh_mod.build_mesh(**mesh_axes)
    model.prepare(o, nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  device_mesh=mesh,
                  sharding_rules=[(pat, mesh_mod.P(*spec))
                                  for pat, spec in rules])

    class Data(paddle.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    from paddle_tpu_torch.distributed import collective

    collective.reset_collective_stats()
    hist = model.fit(Data(), batch_size=bs, epochs=epochs, shuffle=False,
                     verbose=0)
    mp_bytes = collective.collective_stats()["bytes"].get("mp", 0)
    ev = model.evaluate(Data(), batch_size=bs, verbose=0)
    from paddle_tpu_torch.resilience.integrity import (IntegrityCallback,
                                                       shard_fingerprint)

    cb = IntegrityCallback(fingerprint_shards=True)
    cb.set_model(model)
    # between steps each parameter holds this rank's window only
    with model.whole_parameters():
        params = {k: _np(p) for k, p in net.named_parameters()}
    return {"losses": [h["loss"] for h in hist],
            "fingerprint": shard_fingerprint(cb._fingerprint_tree()),
            "coords": dict(model._mesh.coords),
            "acc": [h["acc"] for h in hist], "eval": ev,
            "params": params,
            "param_bytes": model.param_bytes(),
            "slots": {k: {n: list(t.shape) for n, t in s.items()}
                      for k, s in model._opt_state["slots"].items()},
            "windows": {k: v.key for k, v in
                        model.shard_views()["params"].items()},
            "tp": {n: list(model._tp[m]) for n, m in net.named_modules()
                   if m in model._tp},
            "mp_bytes": mp_bytes}


def hapi_mesh_io_case(weights, x, y, mesh_axes, rules, path):
    """The readers of a world's whole parameters while each rank holds
    windows: ``fit(save_dir=)`` with a ``CheckpointCallback`` (Adam, 2
    epochs, a checkpoint every 4 steps into this rank's directory), the
    default ``IntegrityCallback`` digest, ``Model.save``, then one more
    epoch from three equal states: the fitted model, a fresh model that
    ``load``s the saved files, and one restored from the fit
    checkpoint."""
    import os
    import pickle

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import (CheckpointCallback,
                                                 restore_fit_state)
    from paddle_tpu_torch.resilience.integrity import (IntegrityCallback,
                                                       tree_fingerprint)

    paddle.set_device("cpu")
    nn = paddle.nn

    def build():
        net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
        net.set_state_dict({k: np.array(v) for k, v in weights.items()})
        model = Model(net)
        model.prepare(paddle.optimizer.Adam(learning_rate=0.1,
                                            parameters=net.parameters()),
                      nn.CrossEntropyLoss(),
                      device_mesh=mesh_mod.build_mesh(**mesh_axes),
                      sharding_rules=[(pat, mesh_mod.P(*spec))
                                      for pat, spec in rules])
        return model

    class Data(paddle.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    def fit(model, epochs, **kw):
        hist = model.fit(Data(), batch_size=16, epochs=epochs,
                         shuffle=False, verbose=0, **kw)
        return [h["loss"] for h in hist]

    def whole(model):       # copies: a later step writes in place
        with model.whole_parameters():
            return {k: _np(p).copy()
                    for k, p in model.network.named_parameters()}

    rank = get_rank()
    a = build()
    ck_dir = os.path.join(path, f"ck{rank}")
    losses = fit(a, 2, save_dir=os.path.join(path, "fit"),
                 callbacks=[CheckpointCallback(ck_dir, every_n_steps=4)])
    cb = IntegrityCallback()
    cb.set_model(a)
    digest = tree_fingerprint(cb._fingerprint_tree())
    params = whole(a)
    with open(os.path.join(path, "fit", "final.pdparams"), "rb") as f:
        saved = {k: np.asarray(v) for k, v in pickle.load(f)["params"].items()}
    a.save(os.path.join(path, f"model{rank}"))
    b = build()
    b.load(os.path.join(path, f"model{rank}"))
    c = build()
    info = restore_fit_state(c, ck_dir)
    more = {n: fit(m, 1) for n, m in (("a", a), ("b", b), ("c", c))}
    return {"losses": losses, "digest": digest, "params": params,
            "saved": saved, "param_bytes": a.param_bytes(),
            "resumed_step": info["global_step"], "more": more,
            "after": {n: whole(m) for n, m in (("a", a), ("b", b),
                                                ("c", c))}}


def hapi_mp_refusal_case(rules):
    """A dp 2 x mp 2 hapi step whose ``rules`` split over mp a parameter
    that is not an ``nn.Linear`` weight: the error's text."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.hapi import Model

    paddle.set_device("cpu")
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    model = Model(net)
    model.prepare(paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=net.parameters()),
                  nn.CrossEntropyLoss(),
                  device_mesh=mesh_mod.build_mesh(dp=2, mp=2),
                  sharding_rules=[(pat, mesh_mod.P(*spec))
                                  for pat, spec in rules])
    x = np.zeros((4, 8), np.float32)
    try:
        model.train_batch(x, np.zeros((4,), np.int64))
    except ValueError as e:
        return str(e)
    return None


class LayoutSpy:
    """The shapes a hapi ``Model``'s parameters have while it runs: at
    each forward of the network (by ``phase``, which the caller sets:
    ``"train"``, ``"eval"``, ``"predict"``) and of each gradient autograd
    gives them (a hook on each parameter)."""

    def __init__(self, net):
        self.phase = None
        self.forward = {}       # phase -> {name: [shape, ...]}
        self.grads = {}         # name -> [shape, ...]
        self._params = dict(net.named_parameters())
        net.register_forward_pre_hook(self._at_forward)
        for k, p in self._params.items():
            p.register_hook(lambda g, k=k: self._at_grad(k, g))

    def _at_forward(self, module, args):
        seen = self.forward.setdefault(self.phase, {})
        for k, p in self._params.items():
            seen.setdefault(k, []).append(list(p.shape))

    def _at_grad(self, k, g):
        self.grads.setdefault(k, []).append(list(g.shape))

    def report(self):
        uniq = lambda shapes: sorted({tuple(s) for s in shapes})  # noqa
        return {"forward": {ph: {k: uniq(v) for k, v in d.items()}
                            for ph, d in self.forward.items()},
                "grads": {k: uniq(v) for k, v in self.grads.items()}}


def hapi_optimizer(paddle, kind, params, clip=None, wd=None, lr=0.1):
    """The optimizer of the layout cases, the same in both packages:
    ``kind`` ``"adam"`` (coupled decay ``wd``) or ``"lamb"``; ``clip``
    ``"global"``, ``"norm"`` or ``"value"`` at 0.05 (they bite on the
    toy data), or None."""
    o = paddle.optimizer
    grad_clip = {None: None,
                 "global": lambda: o.ClipGradByGlobalNorm(0.05),
                 "norm": lambda: o.ClipGradByNorm(0.05),
                 "value": lambda: o.ClipGradByValue(0.05)}[clip]
    grad_clip = grad_clip() if grad_clip else None
    if kind == "lamb":
        return o.Lamb(learning_rate=lr, parameters=params,
                      grad_clip=grad_clip)
    return o.Adam(learning_rate=lr, parameters=params, weight_decay=wd,
                  grad_clip=grad_clip)


def hapi_layout_case(weights, x, y, mesh_axes, rules, kind="adam",
                     clip=None, wd=None, epochs=3, bs=16):
    """The toy 8-16-2 MLP from ``weights`` under ``Model.prepare(
    device_mesh=)`` on ``mesh_axes`` with ``rules``: ``epochs`` passes of
    ``train_batch`` over ``(x, y)`` in batches of ``bs`` (the gradient
    norm logged), then ``eval_batch`` on the first 15 rows (a batch that
    dp trims) and ``predict_batch`` on the first 16, with a
    :class:`LayoutSpy` on the network.  Returns the losses, the grad
    norms, the whole params, the eval loss and accuracy, the
    predictions, the shapes the spy saw, and each parameter's whole shape
    and the shape it holds between steps."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.hapi import Model

    paddle.set_device("cpu")
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    net.set_state_dict({k: np.array(v) for k, v in weights.items()})
    whole = {k: list(p.shape) for k, p in net.named_parameters()}
    spy = LayoutSpy(net)
    model = Model(net)
    model.prepare(hapi_optimizer(paddle, kind, net.parameters(), clip, wd),
                  nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  device_mesh=mesh_mod.build_mesh(**mesh_axes),
                  sharding_rules=[(pat, mesh_mod.P(*spec))
                                  for pat, spec in rules])
    model.enable_grad_norm_logging()
    losses, gnorms = [], []
    spy.phase = "train"
    for _ in range(epochs):
        for i in range(0, len(x), bs):
            loss, res = model.train_batch(x[i:i + bs], y[i:i + bs])
            losses.append(loss)
            gnorms.append(res["grad_norm"])
    for m in model._metrics:
        m.reset()
    spy.phase = "eval"
    ev_loss, ev = model.eval_batch(x[:15], y[:15])
    spy.phase = "predict"
    pred = model.predict_batch(x[:16])
    spy.phase = None
    with model.whole_parameters():
        params = {k: _np(p) for k, p in net.named_parameters()}
    return {"losses": losses, "gnorms": gnorms, "params": params,
            "eval": [ev_loss, ev["acc"]], "predict": pred,
            "layout": spy.report(), "whole": whole,
            "coords": dict(model._mesh.coords),
            "step_shapes": {k: list(p.shape)
                            for k, p in net.named_parameters()}}


def hapi_gpt_case(state, tokens, labels, dims, rules, steps=3, lr=1e-3):
    """The Paddle-style GPT of ``models/paddle_gpt.py`` (``dims``: vocab,
    hidden, heads, ffn, layers, max_seq) from ``state`` under hapi at dp
    2 x mp 2 with ``rules``: ``steps`` AdamW ``train_batch`` calls on
    ``(tokens, labels)``, then ``eval_batch`` and ``predict_batch`` on the
    same rows, with a :class:`LayoutSpy` on the network."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import paddle_gpt as prog

    paddle.set_device("cpu")
    V = dims[0]
    net = prog.build_gpt(paddle, *dims)
    net.set_state_dict({k: np.array(v) for k, v in state.items()})
    spy = LayoutSpy(net)

    def loss(out, y):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(out, [-1, V]), paddle.reshape(y, [-1]),
            ignore_index=-100)

    model = Model(net)
    model.prepare(paddle.optimizer.AdamW(learning_rate=lr,
                                         weight_decay=0.01,
                                         parameters=net.parameters()),
                  loss, device_mesh=mesh_mod.build_mesh(dp=2, mp=2),
                  sharding_rules=[(pat, mesh_mod.P(*spec))
                                  for pat, spec in rules])
    spy.phase = "train"
    losses = [model.train_batch(tokens, labels)[0] for _ in range(steps)]
    spy.phase = "eval"
    ev_loss, _ = model.eval_batch(tokens, labels)
    spy.phase = "predict"
    pred = model.predict_batch(tokens)
    spy.phase = None
    with model.whole_parameters():
        params = {k: _np(p) for k, p in net.named_parameters()}
    return {"losses": losses, "eval": ev_loss, "predict": pred,
            "params": params, "layout": spy.report(),
            "tp": sorted((n, model._tp[m][0]) for n, m in
                         net.named_modules() if m in model._tp)}


# ------------------------------------- checkpoint windows and integrity


def save_windows_case(model, axes, params, tokens, labels, path, ec,
                      steps=2, barrier_port=None):
    """``steps`` engine steps on the grid ``axes``, then
    ``save_engine_state`` (every rank its windows; with ``barrier_port``
    through a ``CommitBarrier`` over a ``TCPStore`` there), then one more
    step (the uninterrupted run's): that step's loss and the gathered
    params after it, this rank's manifest and the barrier's status."""
    import json
    import os

    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.store import TCPStore

    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       engine_cfg=EngineConfig(**ec), ranks=list(range(n)))
    p = eng.shard_params(params_from_jax(params, device="cpu"))
    o = eng.init_opt(p)
    for _ in range(steps):
        p, o, _ = eng.step(p, o, tokens, labels, lr=1e-3)
    barrier = None
    if barrier_port is not None:
        store = TCPStore("127.0.0.1", barrier_port,
                         is_master=get_rank() == 0, world_size=n)
        barrier = ck.CommitBarrier(store, get_rank(), n, timeout=60.0)
    collective.barrier()
    ck.save_engine_state(path, eng, p, o, barrier=barrier)
    collective.barrier()
    p, o, loss = eng.step(p, o, tokens, labels, lr=1e-3)
    with open(os.path.join(path, f"manifest.{get_rank()}.json")) as f:
        manifest = json.load(f)
    return {"loss": float(loss), "params": params_to_numpy(
        eng.gather_params(p)), "manifest": manifest,
        "barrier": barrier.status() if barrier is not None else None}


def load_windows_case(model, axes, tokens, labels, path, ec):
    """A fresh engine on the grid ``axes`` restores the checkpoint at
    ``path`` (``load_engine_state``: each rank reads its windows) and
    takes one step: its loss, the gathered params after it, the step."""
    from paddle_tpu_torch.distributed import checkpoint as ck

    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       engine_cfg=EngineConfig(**ec), ranks=list(range(n)))
    p, o = ck.load_engine_state(path, eng)
    step0 = o["step"]
    p, o, loss = eng.step(p, o, tokens, labels, lr=1e-3)
    return {"loss": float(loss), "step0": step0,
            "params": params_to_numpy(eng.gather_params(p))}


def fingerprint_case(model, axes, params, flip=None):
    """This rank's ``shard_fingerprint`` of its engine shards
    (``shard_views``) on the grid ``axes``; with ``flip`` ``(rank, leaf,
    flat index)`` that rank flips one bit of its shard first, then every
    rank runs ``cross_rank_windows`` and ``repair_windows``: the report
    before and after the repair, and this rank's digest after it."""
    import paddle_tpu_torch.resilience.integrity as I

    n = int(np.prod(list(axes.values())))
    if outside(axes):
        return None
    eng = HybridEngine(model_of(model), **axes, device="cpu",
                       ranks=list(range(n)))
    p = eng.shard_params(params_from_jax(params, device="cpu"))
    views = eng.shard_views(p)
    out = {"digest": I.shard_fingerprint(views), "coords": eng.coords}
    if flip is not None:
        rank, leaf, i = flip
        if get_rank() == rank:
            t = dict(_items(p))[leaf]
            bits = t.detach().view(-1).view(torch.int32)
            bits[i] ^= 1 << 20
        out["before"], _ = I.cross_rank_windows(views)
        out["repaired"] = I.repair_windows(views, out["before"])
        out["after"], _ = I.cross_rank_windows(eng.shard_views(p))
        out["digest_after"] = I.shard_fingerprint(eng.shard_views(p))
    return out


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# ------------------------------------------------- the flight recorder


def flight_hang_case(stalled, tmp, stall_s=4.0):
    """Every rank records three all-reduces, then a fourth in which rank
    ``stalled`` stalls at the ``collective.all_reduce`` fault site while
    the others wait on the wire; each rank's ``HangWatchdog`` beats on
    its own thread over the world's store.  Returns what each watchdog
    named, the stalled rank's in-flight records at detection, whether
    the bundle holds thread stacks, and whether the sums agree."""
    import os
    import time
    import uuid

    from paddle_tpu_torch.distributed import get_world_size
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability import (FlightRecorder, HangWatchdog,
                                                MetricsRegistry, Tracer,
                                                use_flight_recorder)
    from paddle_tpu_torch.resilience import FaultSpec, injected_faults

    rank, world = get_rank(), get_world_size()
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    store = TCPStore(host=host, port=int(port), world_size=world)
    tag = collective.broadcast(torch.tensor([uuid.uuid4().int % 2**31]))
    rec = FlightRecorder(capacity=64, registry=MetricsRegistry(),
                         tracer=Tracer())
    hw = HangWatchdog(store, rank=rank, world_size=world, recorder=rec,
                      stall_timeout_s=1.0, interval_s=0.1,
                      bundle_dir=os.path.join(tmp, f"r{rank}"),
                      registry=MetricsRegistry(), tracer=Tracer(),
                      key_prefix=f"flight{int(tag)}")
    sums = []
    with use_flight_recorder(rec):
        for i in range(3):
            sums.append(collective.all_reduce(torch.full((8,), float(i)))
                        .sum().item())
        hw.start(interval_s=0.1)
        seen = {}

        def note():
            while not hw.fired and time.monotonic() - t0 < stall_s + 5:
                time.sleep(0.02)
            seen["inflight"] = [[r["seq"], r["op"]] for r in rec.inflight()]

        import threading

        t0 = time.monotonic()
        watcher = threading.Thread(target=note, daemon=True)
        watcher.start()
        faults = [FaultSpec("collective.all_reduce", "stall", occurrence=1,
                            stall_s=stall_s)] if rank == stalled else []
        with injected_faults(*faults):
            sums.append(collective.all_reduce(torch.full((8,), 3.0))
                        .sum().item())
        watcher.join(timeout=stall_s + 10)
    hw.stop()
    d = hw.last_desync or {}
    bundle = {}
    if hw.bundles:
        import json

        with open(hw.bundles[0]) as f:
            bundle = json.load(f)
    collective.barrier()
    return {"fired": hw.fired, "lagging_rank": d.get("lagging_rank"),
            "divergent_seq": d.get("divergent_seq"), "op": d.get("op"),
            "inflight": seen.get("inflight"),
            "threads": bool(bundle.get("threads")),
            "losses_equal": sums == [8.0 * i * world for i in range(4)]}


def flight_busy_rank_case(busy, busy_s=2.0, stall_timeout_s=0.5):
    """Every rank records three all-reduces; then rank ``busy`` works on
    the host for ``busy_s`` (no collective in flight, as when it writes
    a checkpoint) while the others wait on the wire in a barrier, longer
    than ``stall_timeout_s``.  Returns each watchdog's fire count and
    the largest lag it saw (progress of the fleet less the busy rank's)."""
    import os
    import time
    import uuid

    from paddle_tpu_torch.distributed import get_world_size
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability import (FlightRecorder, HangWatchdog,
                                                MetricsRegistry, Tracer,
                                                use_flight_recorder)

    rank, world = get_rank(), get_world_size()
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    store = TCPStore(host=host, port=int(port), world_size=world)
    tag = collective.broadcast(torch.tensor([uuid.uuid4().int % 2**31]))
    rec = FlightRecorder(capacity=64, registry=MetricsRegistry(),
                         tracer=Tracer())
    hw = HangWatchdog(store, rank=rank, world_size=world, recorder=rec,
                      stall_timeout_s=stall_timeout_s, interval_s=0.1,
                      registry=MetricsRegistry(), tracer=Tracer(),
                      key_prefix=f"busy{int(tag)}")
    lag = [0.0]
    with use_flight_recorder(rec):
        for i in range(3):
            collective.all_reduce(torch.full((8,), float(i)))
        hw.start(interval_s=0.1)
        if rank == busy:
            t0 = time.monotonic()
            while time.monotonic() - t0 < busy_s:
                hbs = hw.heartbeats()
                if len(hbs) == world:
                    prog = {r: hw._progress(hb) for r, hb in hbs.items()}
                    lag[0] = max(lag[0], max(prog.values()) - prog[busy])
                time.sleep(0.05)
        collective.barrier()
        time.sleep(3 * 0.1)
    hw.stop()
    collective.barrier()
    return {"fired": hw.fired, "lag": lag[0], "desync": hw.last_desync}


# ------------------------------------------------------- auto-parallel


def _ap_mesh(sizes):
    from paddle_tpu_torch.distributed.mesh import Mesh

    return Mesh(dict(sizes))


def mlp_loss(params, x):
    """The JAX test's ``mlp_loss`` in torch."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    h = h @ params["w2"] + params["b2"]
    return (h.float() ** 2).mean()


def sgd_step(loss_fn, lr):
    """``(params, x) -> (params - lr·grad, loss)``, as the JAX test's
    ``_sgd_step``: the gradient taken inside the traced function."""
    from torch.utils import _pytree as pytree

    def step(params, x):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), x)
            grads = torch.autograd.grad(loss, leaves)
        new = [p - lr * g for p, g in zip(flat, grads)]
        return pytree.tree_unflatten(new, spec), loss.detach()
    return step


def gpt_ap_loss(cfg):
    """The JAX test's GPT ``loss``: log-softmax of fp32 logits, the next
    token by ``roll``, the mean over every position."""
    from paddle_tpu_torch.models.gpt import gpt_forward

    def loss(params, tokens):
        logits = gpt_forward(cfg, params, tokens)
        logp = torch.log_softmax(logits.float(), -1)
        tgt = torch.roll(tokens, -1, 1)
        return -torch.gather(logp, -1, tgt[..., None]).mean()
    return loss


def auto_parallel_case(model, sizes, params, batches, annotations, lr):
    """``len(batches)`` SGD steps of ``parallelize(sgd_step(loss))`` on a
    mesh of ``sizes`` over the world: returns the losses, the final
    params gathered whole, the completed specs (as tuples), this rank's
    parameter bytes against the whole tree's, and the step's counts."""
    from torch.utils import _pytree as pytree

    from paddle_tpu_torch.distributed.auto_parallel import parallelize
    from paddle_tpu_torch.distributed.mesh import P

    mesh = _ap_mesh(sizes)
    if model == "mlp":
        loss = mlp_loss
    else:
        loss = gpt_ap_loss(model_of(model))
    tree = pytree.tree_map(torch.from_numpy, params)
    xs = [torch.from_numpy(b) for b in batches]
    ann = {k: P(*v) for k, v in annotations.items()}
    step, specs = parallelize(sgd_step(loss, lr), mesh, (tree, xs[0]), ann,
                              return_specs=True)
    from paddle_tpu_torch.distributed.auto_parallel import reshard

    sp = reshard(tree, specs[0], mesh)
    losses = []
    for x in xs:
        sp, l = step(sp, x)
        losses.append(float(l.data))
    full = pytree.tree_map(lambda d: d.numpy(), sp,
                           is_leaf=lambda d: hasattr(d, "full"))
    local = sum(d.data.numel() * d.data.element_size()
                for d in pytree.tree_leaves(
                    sp, is_leaf=lambda d: hasattr(d, "full")))
    whole = sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(tree))
    flat_specs = pytree.tree_map(
        lambda s: tuple(s), specs,
        is_leaf=lambda s: type(s).__name__ == "PartitionSpec")
    return {"losses": losses, "params": full, "specs": flat_specs,
            "local_bytes": local, "whole_bytes": whole,
            "stats": dict(step.stats), "whole_ops": dict(step.whole_ops)}


def reshard_case(x):
    """``shard_tensor`` round trip and ``reshard`` between layouts and
    onto a differently-factored mesh; returns what each rank holds and
    the whole tensors gathered back."""
    from paddle_tpu_torch.distributed.auto_parallel import (reshard,
                                                            shard_tensor)
    from paddle_tpu_torch.distributed.mesh import Mesh, P

    mesh_a = Mesh({"dp": 2, "mp": 2})
    mesh_b = Mesh({"x": 4, "y": 1})
    t = torch.from_numpy(x)
    sx = shard_tensor(t, mesh_a, P("dp", "mp"))
    tree = {"w": t, "b": t[0].clone()}
    on_a = reshard(tree, {"w": P("dp", "mp"), "b": P("mp")}, mesh_a)
    on_a2 = reshard(on_a, {"w": P("mp", "dp"), "b": P(None)}, mesh_a)
    on_b = reshard(on_a, {"w": P(None, "x"), "b": P("x")}, mesh_b)
    one = reshard([t, t[:4]], P("dp"), mesh_a)
    return {"window": sx.index, "local": sx.data.numpy(),
            "full": sx.numpy(), "a_w": on_a["w"].numpy(),
            "a2_w": on_a2["w"].numpy(), "a2_w_local": on_a2["w"].data.numpy(),
            "b_w_local": on_b["w"].data.numpy(), "b_w": on_b["w"].numpy(),
            "b_b": on_b["b"].numpy(), "one_spec": [tuple(d.spec)
                                                  for d in one],
            "one_local": [d.data.numpy() for d in one]}
