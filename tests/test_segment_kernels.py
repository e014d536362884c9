"""Differential tests for the sorted segment-sum entry point.

The Python scatter loop is the oracle (atomicAdd semantics,
/root/reference/cpp/storage.cu:37-49: duplicate indices accumulate)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.ops.segment_kernels import sorted_segment_sum


def _reference(upd, rows, num_rows):
    out = np.zeros((num_rows, upd.shape[1]), dtype=np.float64)
    for i in range(upd.shape[0]):
        out[rows[i]] += upd[i]
    return out


@pytest.mark.parametrize(
    "num_updates,num_rows,dim",
    [(64, 16, 8), (100, 7, 3), (5, 32, 4), (1, 1, 1)],
)
def test_matches_reference(num_updates, num_rows, dim):
    rng = np.random.RandomState(0)
    rows = np.sort(rng.randint(0, num_rows, num_updates))
    upd = rng.randn(num_updates, dim)
    got = sorted_segment_sum(
        jnp.asarray(upd), jnp.asarray(rows, jnp.int32), num_rows
    )
    np.testing.assert_allclose(
        np.asarray(got), _reference(upd, rows, num_rows), rtol=1e-12
    )


def test_empty_rows_are_zero():
    upd = jnp.ones((4, 3))
    rows = jnp.asarray([1, 1, 5, 5], jnp.int32)
    got = np.asarray(sorted_segment_sum(upd, rows, 8))
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[1], 2.0)
    np.testing.assert_array_equal(got[5], 2.0)
    np.testing.assert_array_equal(got[7], 0.0)


def test_bf16_updates_widened_by_caller():
    """The callers widen bf16 streams before accumulation (optim/updates);
    the op itself accumulates at the update dtype."""
    upd = jnp.ones((6, 2), jnp.bfloat16)
    rows = jnp.asarray([0, 0, 0, 1, 1, 1], jnp.int32)
    got = sorted_segment_sum(upd.astype(jnp.float32), rows, 2)
    assert got.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got), 3.0)
