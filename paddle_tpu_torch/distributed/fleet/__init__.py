"""Fleet (the port of ``paddle_tpu/distributed/fleet``):
``fleet.init(strategy=)`` lays the world out as the strategy's degrees
(dp absorbing the ranks the others leave), ``distributed_model`` and
``distributed_optimizer`` wrap a layer and its optimizer for that
layout, and ``engine_config_from_strategy`` maps the strategy onto the
``HybridEngine``'s config.  ``fleet/elastic.py`` is not ported yet."""
from .distributed_strategy import (DistributedStrategy,  # noqa: F401
                                   engine_config_from_strategy)
from .fleet_base import (  # noqa: F401
    Fleet,
    distributed_model,
    distributed_optimizer,
    fleet,
    get_hybrid_communicate_group,
    init,
)
from .hybrid_optimizer import HybridParallelOptimizer  # noqa: F401
from .meta_optimizers import (BF16AllreduceSync, DGCSync,  # noqa: F401
                              GradSync, LocalSGD)
