"""Datasets — the counterpart of ``paddle_tpu/io/dataset.py`` (reference:
``python/paddle/io/dataloader/dataset.py``). ``random_split`` draws its
permutation from numpy's global generator, as the JAX package does."""
from __future__ import annotations

import bisect

import numpy as np
import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long tensors (numpy arrays are taken as tensors);
    an item is the tuple of each tensor's row."""

    def __init__(self, tensors):
        self.tensors = [t if isinstance(t, torch.Tensor)
                        else torch.as_tensor(np.asarray(t)) for t in tensors]
        n = len(self.tensors[0])
        if any(len(t) != n for t in self.tensors):
            raise ValueError("TensorDataset: tensors of different lengths "
                             f"{[len(t) for t in self.tensors]}")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("ComposeDataset: datasets of different lengths")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(round(l * total)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError(f"random_split: lengths {lengths} do not sum to "
                         f"the dataset's {total}")
    perm = np.random.permutation(total).tolist()
    out = []
    offset = 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out
