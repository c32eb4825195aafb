"""``HybridParallelOptimizer`` — what ``fleet.distributed_optimizer``
returns (the port of ``paddle_tpu/distributed/fleet/hybrid_optimizer.py``):
the user's optimizer with the strategy's gradient sync around its
``step`` (plain mean, bf16 on the wire, DGC or LocalSGD) over the
data-parallel group."""
from __future__ import annotations

from .meta_optimizers import BF16AllreduceSync, DGCSync, GradSync, LocalSGD

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        group = hcg.get_data_parallel_group() if hcg else None
        self._localsgd = None
        if strategy is not None and getattr(strategy, "dgc", False):
            cfgs = getattr(strategy, "dgc_configs", {}) or {}
            self._sync = DGCSync(
                group, sparsity=cfgs.get("sparsity", 0.01),
                momentum=cfgs.get("momentum", 0.9),
                rampup_begin_step=cfgs.get("rampup_begin_step", 0))
        elif strategy is not None and getattr(strategy, "localsgd", False):
            cfgs = getattr(strategy, "localsgd_configs", {}) or {}
            self._localsgd = LocalSGD(group, k_steps=cfgs.get("k_steps", 4))
            self._sync = None
        elif strategy is not None and getattr(strategy, "fp16_allreduce",
                                              False):
            self._sync = BF16AllreduceSync(group)
        else:
            self._sync = GradSync(group)

    def _params(self):
        return list(self._inner._parameter_list or [])

    def step(self):
        params = self._params()
        if self._sync is not None:
            self._sync.sync(params)
        self._inner.step()
        if self._localsgd is not None:
            self._localsgd.after_step(params)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self):
        self._inner.clear_grad()

    def __getattr__(self, name):
        return getattr(self._inner, name)
