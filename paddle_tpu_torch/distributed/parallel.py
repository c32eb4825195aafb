"""``DataParallel`` (the port of ``paddle_tpu/distributed/parallel.py``).

Forward runs the wrapped layer; ``apply_collective_grads`` (the
reference Reducer's job) averages every gradient over the data-parallel
group after ``backward``: same-dtype gradients are packed into buckets
of about ``comm_buffer_size`` MB, one all-reduce a bucket.  A trainable
parameter the loss did not reach is an error (the ranks would build
different buckets), or a zero gradient with ``find_unused_parameters``.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from .collective import ReduceOp, all_reduce, world_group

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _trainable(self):
        return [p for p in self._layers.parameters() if p.requires_grad]

    def _resolve_unused(self):
        unused = [p for p in self._trainable() if p.grad is None]
        if not unused:
            return
        if not self.find_unused_parameters:
            raise RuntimeError(
                f"DataParallel: {len(unused)} trainable parameter(s) "
                f"received no gradient this step; ranks would build "
                f"mismatched allreduce buckets. Pass "
                f"find_unused_parameters=True (zero-fills them) or make "
                f"the loss depend on every trainable parameter.")
        for p in unused:
            p.grad = torch.zeros_like(p)

    def _grad_buckets(self):
        limit = self.comm_buffer_size * 1024 * 1024
        buckets, cur, cur_bytes = [], [], 0
        for p in self._trainable():
            if p.grad is None:
                continue
            g = p.grad
            if cur and (g.dtype != cur[-1].grad.dtype or cur_bytes >= limit):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += g.numel() * g.element_size()
        if cur:
            buckets.append(cur)
        return buckets

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average the gradients over the group (the world by default)."""
        group = self.group or world_group()
        n = group.nranks
        self._resolve_unused()
        for bucket in self._grad_buckets():
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            all_reduce(flat, op=ReduceOp.SUM, group=group)
            if n > 1:
                flat /= n
            off = 0
            for p in bucket:
                size = p.grad.numel()
                p.grad.copy_(flat[off:off + size].view_as(p.grad))
                off += size

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss
