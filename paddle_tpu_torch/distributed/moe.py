"""Mixture-of-Experts blocks (the port of ``paddle_tpu/distributed/moe.py``).

The JAX package gates with GShard's dense-dispatch form: ``moe_gating``
builds ``combine``/``dispatch`` tensors of shape ``[n, E, C]`` (tokens,
experts, capacity slots) and ``moe_layer`` dispatches and combines by
einsum over them.  At a training batch (n = 16384, E = 8, C = 8192)
each of those is 4.29 GB of fp32 a layer, so the port computes the same
function in index form:

- ``moe_route`` gives, for each token and each of the ``top_k`` routing
  rounds, its expert (``argmax`` of the masked probabilities, first
  index on ties), its slot (a cumsum along the token axis plus the
  running count of earlier rounds, so a 2nd choice queues behind every
  1st choice), its gate weight (normalised by the sum of the k gates
  when ``normalize_top_k and top_k > 1``) and ``keep = slot < C``, and
  the GShard load-balance loss ``E·Σ_e f_e·p_e`` on the top-1 mask;
- ``moe_layer`` gathers each dispatched (token, round) row into
  ``expert_in[e, slot]`` (empty slots stay zero), runs the experts on
  ``[E, C, D]`` and sums ``y[n] = Σ_k w_k · out[e_k, slot_k]``.  Each
  ``(e, c)`` holds at most one token, so this is the einsum's result.

``moe_gating`` keeps the JAX signature and returns the dense tensors
built from that routing, for tests and small sizes; nothing on the
model's path calls it.  Expert parallelism (``ep_axis``: the
expert-parallel ``collective.Group``, or ``"ep"`` for ``fleet``'s)
keeps E/ep experts a rank: the dispatched ``[E, C, D]`` goes to the
experts' owners by a balanced all-to-all (``[E/ep, ep·C, D]``), and the
outputs come back by the inverse one, as the JAX ``all_to_all`` pair
does; every rank routes its own tokens over all E experts with the
capacity of its own token count.  The routing, dispatch, combine and
expert products are XLA ops in the JAX package and PyTorch ops here; each runs
inside a ``torch.profiler`` range (``moe::route``, ``moe::dispatch``,
``moe::experts``, ``moe::combine``).  Every shape follows from ``n``,
``E``, ``top_k`` and the capacity, and no op reads a value on the host,
so the serving step that calls ``moe_layer`` is captured in a CUDA
graph as it is.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .._device import resolve_device

__all__ = ["moe_capacity", "moe_route", "moe_gating", "moe_ffn",
           "moe_layer", "MoERouting", "MoELayer", "NaiveGate",
           "SwitchGate", "GShardGate"]


def moe_capacity(num_tokens, num_experts, capacity_factor, top_k):
    """Expert capacity: ⌈n / E · capacity_factor · top_k⌉, at least 1."""
    return max(1, int(math.ceil(
        num_tokens / num_experts * capacity_factor * top_k)))


@dataclasses.dataclass
class MoERouting:
    """Where each token's ``top_k`` choices go.  ``[n, k]`` tensors:
    ``expert`` and ``slot`` (int64), ``weight`` (fp32, the gate weight
    before the capacity cut; differentiable), ``keep`` (``slot <
    capacity``); ``aux`` the fp32 load-balance loss."""

    expert: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int

    @property
    def dispatched(self):
        """The (token, round) pairs whose row enters its expert slot:
        kept, with a weight above 0 (JAX's ``dispatch = combine > 0``)."""
        return self.keep & (self.weight > 0)


def moe_route(logits, *, top_k=2, capacity=None, capacity_factor=1.25,
              normalize_top_k=True):
    """GShard top-k routing of ``logits [n, E]`` (computed in fp32) in
    index form; see the module docstring."""
    n, E = logits.shape
    C = capacity or moe_capacity(n, E, capacity_factor, top_k)
    probs = torch.softmax(logits.float(), dim=-1)
    masked = probs.detach()
    # tokens per expert so far, carried across the rounds so a 2nd
    # choice queues behind every 1st choice
    counts = torch.zeros(E, dtype=torch.long, device=logits.device)
    experts, slots, gates = [], [], []
    for _ in range(top_k):
        idx = masked.argmax(dim=-1)                          # [n]
        mask = F.one_hot(idx, E)                             # [n, E] int64
        # the cumsum runs along the inner axis of [E, n]: a scan down the
        # outer axis of [n, E] is a serial walk over n on the card
        pos = torch.cumsum(mask.t().contiguous(), dim=1)     # [E, n]
        slots.append(pos.gather(0, idx[None])[0] - 1 + counts[idx])
        counts = counts + mask.sum(dim=0)
        experts.append(idx)
        gates.append(probs.gather(1, idx[:, None])[:, 0])
        masked = masked * (1 - mask)                         # exclude chosen
    # load balance on the top-1 assignment
    f = F.one_hot(experts[0], E).float().mean(dim=0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    if normalize_top_k and top_k > 1:
        denom = sum(gates)
        gates = [g / denom for g in gates]
    slot = torch.stack(slots, dim=1)
    return MoERouting(expert=torch.stack(experts, dim=1), slot=slot,
                      weight=torch.stack(gates, dim=1), keep=slot < C,
                      aux=aux, capacity=C)


def moe_gating(logits, *, top_k=2, capacity=None, capacity_factor=1.25,
               normalize_top_k=True):
    """Dense-dispatch gating with the JAX signature: ``(combine [n, E, C]
    fp32, dispatch [n, E, C] bool, aux)``, built from ``moe_route``.  It
    holds n·E·C values: for tests and small sizes only."""
    n, E = logits.shape
    r = moe_route(logits, top_k=top_k, capacity=capacity,
                  capacity_factor=capacity_factor,
                  normalize_top_k=normalize_top_k)
    C = r.capacity
    combine = torch.zeros((n, E * C + 1), dtype=torch.float32,
                          device=logits.device)
    # dropped choices land in a spare column that is cut off below
    col = torch.where(r.keep, r.expert * C + r.slot, E * C)
    combine = combine.scatter_add(1, col, r.weight * r.keep)
    combine = combine[:, :E * C].reshape(n, E, C)
    return combine, combine > 0, r.aux


def moe_ffn(expert_params, x):
    """Per-expert tanh-GELU FFN: ``x [E, T, D] → [E, T, D]``."""
    h = torch.bmm(x, expert_params["up_w"]) + expert_params["up_b"][:, None]
    h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, expert_params["down_w"])
    return out + expert_params["down_b"][:, None]


def moe_layer(params, x, *, top_k=2, capacity_factor=1.25, ep_axis=None,
              normalize_top_k=True):
    """The MoE block: gate → dispatch → experts → combine.

    ``params``: ``{"gate_w": [D, E], "up_w": [E, D, F], "up_b": [E, F],
    "down_w": [E, F, D], "down_b": [E, D]}``; ``x [B, S, D]``, whose
    B·S tokens are routed together in row-major order.  Returns
    ``(y [B, S, D], aux)``.  The gate runs in fp32 from ``x.float() @
    gate_w.float()``; the combine weights are cast to ``x.dtype`` before
    they meet the expert outputs, as JAX's ``combine.astype(x.dtype)``."""
    group = _ep_group(ep_axis)
    ep = group.nranks if group is not None else 1
    B, S, D = x.shape
    n = B * S
    xt = x.reshape(n, D)
    E = params["gate_w"].shape[-1]
    if params["up_w"].shape[0] * ep != E:
        raise ValueError(f"experts {E} != local {params['up_w'].shape[0]} "
                         f"x ep {ep}")

    with record_function("moe::route"):
        logits = xt.float() @ params["gate_w"].float()
        r = moe_route(logits, top_k=top_k, capacity_factor=capacity_factor,
                      normalize_top_k=normalize_top_k)
    C = r.capacity
    flat = r.expert * C + r.slot                             # [n, k]
    with record_function("moe::dispatch"):
        # slot → token map; row n of x_pad is zeros (an empty slot), the
        # spare last entry takes every choice that is not dispatched
        src = torch.full((E * C + 1,), n, dtype=torch.long, device=x.device)
        tok = torch.arange(n, device=x.device)[:, None].expand_as(flat)
        src.scatter_(0, torch.where(r.dispatched, flat, E * C).reshape(-1),
                     tok.reshape(-1))
        x_pad = torch.cat([xt, xt.new_zeros((1, D))])
        expert_in = x_pad.index_select(0, src[:E * C]).view(E, C, D)
    if ep > 1:
        from .collective import AllToAll

        # to the experts' owners: [E/ep, ep·C, D]
        expert_in = AllToAll.apply(expert_in, group, 0, 1)
    with record_function("moe::experts"):
        out = moe_ffn(params, expert_in)
    if ep > 1:
        out = AllToAll.apply(out, group, 1, 0)
    with record_function("moe::combine"):
        # a dropped choice reads slot 0 with weight 0 (and no gradient)
        picked = out.reshape(E * C, D).index_select(
            0, torch.where(r.keep, flat, 0).reshape(-1)).view(n, top_k, D)
        w = torch.where(r.keep, r.weight, 0.0).to(x.dtype)
        y = torch.bmm(w[:, None], picked)[:, 0]
    return y.reshape(B, S, D), r.aux


def _ep_group(ep_axis):
    """The expert-parallel group ``ep_axis`` names: a ``collective.Group``
    as it is, ``"ep"`` the one of ``fleet.init``'s topology; None for
    none.  A name with no world behind it raises."""
    if ep_axis is None or not isinstance(ep_axis, str):
        return ep_axis
    from .fleet import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError(
            f"ep_axis={ep_axis!r} names the expert-parallel group of a "
            f"multi-GPU world: call fleet.init(strategy) in each rank's "
            f"process, or pass the collective.Group")
    return hcg.get_expert_parallel_group()


# ------------------------------------------------------------ module facade


class _GateBase(nn.Module):
    """A gate: its ``weight [d_model, num_experts]`` (normal, std 0.02)
    and the routing it implies (``top_k``, ``normalize``)."""

    top_k = 1
    normalize = False

    def __init__(self, d_model, num_experts, generator=None, device=None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.weight = nn.Parameter(_normal((d_model, num_experts), 0.02,
                                           generator, resolve_device(device)))

    def logits(self, x):
        return x @ self.weight


class NaiveGate(_GateBase):
    top_k = 2
    normalize = False


class SwitchGate(_GateBase):
    top_k = 1
    normalize = False


class GShardGate(_GateBase):
    top_k = 2
    normalize = True


_GATES = {"naive": NaiveGate, "switch": SwitchGate, "gshard": GShardGate}


def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).mul_(std)


class MoELayer(nn.Module):
    """The JAX ``MoELayer`` facade: a gate (an instance or a name) and
    ``num_experts`` FFNs of hidden ``d_hidden`` (weights normal, std
    0.02; biases zero; fp32), drawn from ``generator`` on ``device``
    (default CUDA).  ``forward`` returns ``y`` and leaves the load-balance loss
    in ``aux_loss``.  With ``ep_axis`` the layer is one rank's share of
    the experts: build it with ``num_experts`` = E/ep and pass the gate
    of all E (``gate=GShardGate(d_model, E)``)."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=1.25, ep_axis=None,
                 generator=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(gate, str):
            gate = _GATES[gate](d_model, num_experts, generator=generator,
                                device=dev)
        self.gate = gate
        self.num_experts = num_experts
        self.top_k = top_k or gate.top_k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        E = num_experts
        self.up_w = nn.Parameter(_normal((E, d_model, d_hidden), 0.02,
                                         generator, dev))
        self.up_b = nn.Parameter(torch.zeros((E, d_hidden), device=dev))
        self.down_w = nn.Parameter(_normal((E, d_hidden, d_model), 0.02,
                                           generator, dev))
        self.down_b = nn.Parameter(torch.zeros((E, d_model), device=dev))
        self.aux_loss = None

    def forward(self, x):
        params = {"gate_w": self.gate.weight, "up_w": self.up_w,
                  "up_b": self.up_b, "down_w": self.down_w,
                  "down_b": self.down_b}
        y, aux = moe_layer(
            params, x, top_k=self.top_k,
            capacity_factor=self.capacity_factor, ep_axis=self.ep_axis,
            normalize_top_k=getattr(self.gate, "normalize", True))
        self.aux_loss = aux
        return y
