"""Gluon's data API (the counterpart of ``mxtpu/gluon/data/``;
reference ``python/mxnet/gluon/data/``†): datasets, samplers, the
``DataLoader`` and the vision datasets and transforms.  Batches are
host (CPU) NDArrays, as the iterators' are."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler)
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset", "Sampler", "SequentialSampler",
           "RandomSampler", "BatchSampler", "DataLoader", "vision"]
