"""Sorted segment-sum entry point for the gradient-accumulation hot path.

This replaces the reference's atomicAdd embedding scatter
(update_repr_kernel, storage.cu:37-49).  The callers (optim/updates.py)
sort the indices first, so XLA takes its sorted-scatter path; duplicate
indices still accumulate exactly like atomicAdd.  Whether the sort pays
for itself on the GPU, where the unsorted scatter lowers to atomics like
the reference's, is measured in PERF.md ("Kernels on the H100").
``cunvsm.ops.prefix_diff`` is an opt-in scatter-free alternative for the
canonical weight-free word update.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sorted_segment_sum(
    upd_sorted: jax.Array,
    rows_sorted: jax.Array,
    num_rows: int,
) -> jax.Array:
    """out[v] = sum of ``upd_sorted`` rows whose ``rows_sorted`` id is v.

    ``rows_sorted`` must be sorted ascending (the callers sort).
    """
    return jax.ops.segment_sum(
        upd_sorted,
        rows_sorted,
        num_segments=num_rows,
        indices_are_sorted=True,
    )
