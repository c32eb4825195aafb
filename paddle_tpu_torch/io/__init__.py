"""Data pipeline (the port of ``paddle_tpu/io``): datasets, samplers, the
``DataLoader`` with its worker processes, and the industrial
``InMemoryDataset`` / ``QueueDataset``."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)
from .multiprocess import WorkerInfo, get_worker_info  # noqa: F401
from .industrial import InMemoryDataset, QueueDataset  # noqa: F401
