"""Data pipeline (the port of ``paddle_tpu/io``): datasets, samplers and
the ``DataLoader``."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)
