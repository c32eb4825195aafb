"""Tensor-parallel layers (the port of
``paddle_tpu/distributed/mp_layers.py``): Megatron's column- and
row-split linears, the vocab-split embedding and the vocab-split cross
entropy, over the model-parallel (``mp``) group.

Where the JAX layers hold the full weight and let GSPMD (or a
``shard_map``) split it, a layer here holds this rank's partition, as
the reference's do: ``ColumnParallelLinear`` ``[in, out/mp]``,
``RowParallelLinear`` ``[in/mp, out]``, ``VocabParallelEmbedding``
``[V/mp, D]``.  The collectives are Megatron's pairs, written as
autograd Functions:

- ``copy_to_group``: identity forward, all-reduce of the gradient
  backward (the input of a column split);
- ``reduce_from_group``: all-reduce forward, identity backward (the
  output of a row split, the embedding's, the CE's sums);
- ``gather_from_group`` / ``scatter_to_group``: all-gather of the last
  dim forward and this rank's slice of the gradient backward, and the
  reverse.

Forward values and gradients equal the unsplit layer's: a replicated
input's gradient is summed over the group once, in the pair's backward.
"""
from __future__ import annotations

import torch

from ..nn.initializer import Normal, XavierUniform
from ..nn.layer.layers import Layer
from . import collective

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_cross_entropy", "copy_to_group", "reduce_from_group",
           "gather_from_group", "scatter_to_group",
           "model_parallel_group"]


def _live(group):
    return group is not None and group.nranks > 1


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g.contiguous().clone(),
                                     group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.all_gather(x.contiguous(), group=group,
                                     axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return collective.split(g, ctx.group.nranks, axis=g.dim() - 1,
                                group=ctx.group).contiguous(), None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.split(x, group.nranks, axis=x.dim() - 1,
                                group=group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return collective.all_gather(g.contiguous(), group=ctx.group,
                                     axis=g.dim() - 1), None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group) if _live(group) else x


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group) if _live(group) else x


def gather_from_group(x, group):
    return _GatherFromGroup.apply(x, group) if _live(group) else x


def scatter_to_group(x, group):
    return _ScatterToGroup.apply(x, group) if _live(group) else x


def model_parallel_group(group=None):
    """``group``, else the model-parallel group of ``fleet.init``'s
    topology, else None (one rank)."""
    if group is not None:
        return group
    from .fleet import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _degree(group, num_partitions):
    if num_partitions is not None:
        return num_partitions
    return group.nranks if group is not None else 1


class ColumnParallelLinear(Layer):
    """``y = x @ W + b`` with W split along its output columns: this rank
    holds ``[in, out/mp]`` and its bias slice.  ``gather_output``
    all-gathers the columns (else the output stays split, as a
    ``RowParallelLinear(input_is_parallel=True)`` takes it)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, mp_group=None,
                 num_partitions=None, fuse_matmul_bias=False):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.world_size = _degree(self.group, num_partitions)
        if out_features % self.world_size:
            raise ValueError(f"out_features {out_features} not divisible by "
                             f"mp {self.world_size}")
        self.gather_output = gather_output
        self.out_features = out_features
        self.out_per_partition = out_features // self.world_size
        self.weight = self.create_parameter(
            [in_features, self.out_per_partition], attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.is_distributed = True
        self.bias = self.create_parameter(
            [self.out_per_partition], is_bias=True) if has_bias else None

    def forward(self, x):
        out = copy_to_group(x, self.group) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = gather_from_group(out, self.group)
        return out


class RowParallelLinear(Layer):
    """``y = x @ W + b`` with W split along its input rows: this rank holds
    ``[in/mp, out]``; the partial products are all-reduced, THEN the
    (replicated) bias is added once.  Without ``input_is_parallel`` the
    input is split along its last dim first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 num_partitions=None):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.world_size = _degree(self.group, num_partitions)
        if in_features % self.world_size:
            raise ValueError(f"in_features {in_features} not divisible by "
                             f"mp {self.world_size}")
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features // self.world_size, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.is_distributed = True
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_group(x, self.group)
        out = reduce_from_group(x @ self.weight, self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


def vocab_parallel_embed(ids, weight, group):
    """Rows of the vocab-split table ``weight [V/mp, D]`` for the global
    ``ids``: each rank looks up the ids in its range (zeros elsewhere) and
    the partial rows are summed over the group."""
    vpp = weight.shape[0]
    start = (group.rank if _live(group) else 0) * vpp
    local = ids.long() - start
    inside = (local >= 0) & (local < vpp)
    emb = weight[local.clamp(0, vpp - 1)]
    emb = torch.where(inside[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                          device=emb.device))
    return reduce_from_group(emb, group)


class VocabParallelEmbedding(Layer):
    """An embedding table split along the vocabulary: this rank holds
    rows ``[rank·V/mp, (rank+1)·V/mp)``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.world_size = _degree(self.group, None)
        if num_embeddings % self.world_size:
            raise ValueError(f"num_embeddings {num_embeddings} not divisible "
                             f"by mp {self.world_size}")
        self.num_embeddings = num_embeddings
        self.weight = self.create_parameter(
            [num_embeddings // self.world_size, embedding_dim],
            attr=weight_attr, default_initializer=Normal(0.0, 0.02))
        self.weight.is_distributed = True

    def forward(self, ids):
        return vocab_parallel_embed(ids, self.weight, self.group)


def parallel_cross_entropy(logits, label, mp_axis=None, ignore_index=-100):
    """Softmax cross entropy of vocab-split ``logits [..., V/mp]`` (this
    rank's columns) against global ``label``, per token (0 where the
    label is ``ignore_index``).  ``mp_axis``: the model-parallel group
    (default: ``fleet``'s; None or one rank is the plain CE).  Global max
    (no gradient) and sum of exponentials over the group, the true
    label's logit from the rank that holds it, as the JAX function."""
    group = model_parallel_group(
        mp_axis if isinstance(mp_axis, collective.Group) else None)
    vpp = logits.shape[-1]
    offset = (group.rank if _live(group) else 0) * vpp
    lf = logits.float()
    gmax = lf.detach().amax(dim=-1, keepdim=True)
    if _live(group):
        collective.all_reduce(gmax, op=collective.ReduceOp.MAX, group=group)
    shifted = lf - gmax
    sumexp = reduce_from_group(torch.exp(shifted).sum(dim=-1, keepdim=True),
                               group)
    local = label.long() - offset
    inside = (local >= 0) & (local < vpp)
    picked = shifted.gather(-1, local.clamp(0, vpp - 1)[..., None])[..., 0]
    picked = reduce_from_group(torch.where(inside, picked, 0.0), group)
    loss = torch.log(sumexp[..., 0]) - picked
    return torch.where(label == ignore_index, 0.0, loss)


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, ignore_index=-100):
        super().__init__()
        self.group = mp_group
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        return parallel_cross_entropy(logits, label, mp_axis=self.group,
                                      ignore_index=self.ignore_index)
