"""The port's DLRM data generators give bit-identical batches to the
reference's for the same seed."""

import numpy as np
import pytest

from param_tpu.models import dlrm_data as jax_data
from param_tpu_torch.models import dlrm_data as torch_data

KW = dict(batch=32, dense_dim=8, num_tables=3, nnz=5, num_rows=1000,
          num_batches=3)


@pytest.mark.parametrize("kind", ["random", "synthetic"])
@pytest.mark.parametrize("distribution", ["uniform", "zipf"])
def test_batches_identical(kind, distribution):
    ref = list(jax_data.data_loader(kind, distribution=distribution, seed=7,
                                    **KW))
    got = list(torch_data.data_loader(kind, distribution=distribution, seed=7,
                                      **KW))
    assert len(got) == len(ref) == KW["num_batches"]
    for (d0, i0, l0), (d1, i1, l1) in zip(ref, got):
        assert i1.dtype == np.int32 and i1.shape == (32, 3, 5)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(l1, l0)


@pytest.mark.parametrize("distribution", ["uniform", "zipf"])
def test_gen_indices_identical(distribution):
    a = jax_data.gen_indices(np.random.default_rng(3), 16, 2, 4, 500,
                             distribution)
    b = torch_data.gen_indices(np.random.default_rng(3), 16, 2, 4, 500,
                               distribution)
    np.testing.assert_array_equal(b, a)
    assert b.min() >= 0 and b.max() < 500


def test_native_library_loads():
    from param_tpu_torch.utils import native

    assert native.native_available()
    out = native.pad_ragged(np.array([5, 1, 2], np.int32),
                            np.array([0, 1, 3], np.int64), 3, 9)
    np.testing.assert_array_equal(out, [[5, 9, 9], [1, 2, 9]])


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        torch_data.data_loader("trace", **KW)
    with pytest.raises(ValueError):
        torch_data.gen_indices(np.random.default_rng(0), 2, 1, 1, 10, "normal")
