"""DLRM synthetic data generation (the port's own copy of
``param_tpu/models/dlrm_data.py``).

Produces (dense, indices, labels) numpy batches with uniform or Zipf-skewed
sparse indices.  Given the same seed the batches are bit-identical to the
reference package's: the same numpy generator calls in the same order, and
the same native C++ index generators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from param_tpu_torch.utils import native

_zipf_cache = {}


def gen_indices(
    rng: np.random.Generator,
    batch: int,
    num_tables: int,
    nnz: int,
    num_rows: int,
    distribution: str = "uniform",
    zipf_alpha: float = 1.15,
) -> np.ndarray:
    """(batch, num_tables, nnz) int32 indices, uniform or Zipf-ranked."""
    seed = int(rng.integers(0, 2**62))
    shape = (batch, num_tables, nnz)
    if distribution == "uniform":
        return native.uniform_indices(seed, num_rows, shape)
    if distribution == "zipf":
        if native.native_available():
            key = (zipf_alpha, num_rows)
            if key not in _zipf_cache:
                _zipf_cache[key] = native.ZipfSampler(zipf_alpha, num_rows)
            return _zipf_cache[key].sample(seed, shape)
        z = rng.zipf(zipf_alpha, size=shape)
        return ((z - 1) % num_rows).astype(np.int32)
    raise ValueError(f"unknown distribution {distribution!r}")


@dataclass
class RandomDataset:
    """Streaming random batches."""

    batch: int
    dense_dim: int
    num_tables: int
    nnz: int
    num_rows: int
    num_batches: int = 10
    distribution: str = "uniform"
    seed: int = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            dense = rng.normal(size=(self.batch, self.dense_dim)).astype(np.float32)
            idx = gen_indices(
                rng, self.batch, self.num_tables, self.nnz, self.num_rows,
                self.distribution,
            )
            labels = rng.integers(0, 2, size=(self.batch,)).astype(np.float32)
            yield dense, idx, labels


@dataclass
class SyntheticDataset(RandomDataset):
    """Learnable synthetic data: the label correlates with a random linear
    probe of the dense features and with hits on one hot row per table, so
    a trained DLRM reaches AUC > 0.5."""

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        w = rng.normal(size=(self.dense_dim,)).astype(np.float32)
        hot = rng.integers(0, self.num_rows, size=(self.num_tables,))
        for _ in range(self.num_batches):
            dense = rng.normal(size=(self.batch, self.dense_dim)).astype(np.float32)
            idx = gen_indices(
                rng, self.batch, self.num_tables, self.nnz, self.num_rows,
                self.distribution,
            )
            score = dense @ w / np.sqrt(self.dense_dim)
            hits = (idx == hot[None, :, None]).sum(axis=(1, 2)).astype(np.float32)
            p = 1.0 / (1.0 + np.exp(-(score + hits - 0.5)))
            labels = (rng.random(self.batch) < p).astype(np.float32)
            yield dense, idx, labels


def data_loader(kind: str, **kwargs):
    if kind == "random":
        return RandomDataset(**kwargs)
    if kind == "synthetic":
        return SyntheticDataset(**kwargs)
    raise ValueError(f"unknown dataset kind {kind!r}")
