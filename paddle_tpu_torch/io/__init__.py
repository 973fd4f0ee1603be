"""``paddle.io`` — datasets, samplers and the DataLoader (the counterpart
of ``paddle_tpu/io``). Batches come out as tensors on the port's current
device."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info
