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
