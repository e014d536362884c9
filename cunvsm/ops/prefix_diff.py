"""Scatter-free dense segment accumulation via chunked prefix differences.

An opt-in replacement for the reference's atomicAdd embedding scatter
(update_repr_kernel, storage.cu:37-49) on the *word*-table hot path, for a
backend whose scatter emitter is bound by a per-row rate rather than by
bandwidth.  It issues *no scatter at all*:

1.  Pack every update position into one uint32 sort key
    ``(row_id << 16) | instance_id`` and append one *sentinel* key per
    destination row, ``(row_id << 16) | 0xFFFF`` — sentinels sort after
    every real update of their row.  ONE single-operand sort orders the
    merged stream by destination row.
2.  A second single-operand sort recovers the V sentinel positions in
    row order (the classic sort-based compaction: sentinel positions are
    strictly increasing in row id, so sorting ``position-if-sentinel``
    yields them as a static-shape prefix).
3.  The sorted update stream is reduced with an *inclusive running prefix*
    computed hierarchically: within fixed chunks of C positions by a
    [C, C] lower-triangular matmul (bf16 inputs, float32
    accumulation — exactly the precision of the scatter path it replaces),
    and across chunks by a cheap [num_chunks, dim] cumulative sum.
4.  ``out[v] = G[sentinel_pos[v]] - G[sentinel_pos[v-1]]`` — two
    V-row gathers and an elementwise difference.  Because the update
    values are mixed-sign, the running prefix random-walks (|G| ~
    sqrt(N) * sigma), so the float32 cancellation error of the difference
    is ~sqrt(N / L) ulp for a segment of L updates — orders of magnitude
    below the bfloat16 quantization already present in the stream.

OPT-IN via CUNVSM_PREFIX_DIFF=1; the sorted scatter is the default.  XLA
may insert full-stream layout copies around the [C, C] x [Nc, C, d] prefix
contraction, so compare whole steps before switching it on.  It has not
been measured on the GPU.

Constraints (checked by ``prefix_diff_applicable``): row ids fit 16 bits,
instance ids fit strictly below 0xFFFF (the sentinel marker), a single
weight-free descriptor (the canonical uniform-feature-weight word update),
and float32/float64 accumulation.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_SENTINEL_PTR = 0xFFFF


def prefix_diff_applicable(
    n_inst: int, window: int, num_rows: int, weights, accum_dtype
) -> bool:
    """Static gate for the prefix-diff path (see module docstring)."""
    if os.environ.get("CUNVSM_PREFIX_DIFF", "0") != "1":
        return False
    n = n_inst * window
    return (
        weights is None
        and accum_dtype is None
        and n_inst < _SENTINEL_PTR
        and num_rows <= (1 << 16)
        and n >= num_rows  # sentinel overhead must stay amortized
        and n + num_rows < (1 << 31)
    )


def prefix_diff_segment_sum(
    grad: jax.Array,
    indices: jax.Array,
    num_rows: int,
    stream_dtype=None,
    chunk: int | None = None,
) -> jax.Array:
    """out[v] = sum over (i, w) with indices[i, w] == v of grad[i].

    Semantically identical to the sorted-scatter accumulation in
    ``optim.updates._sorted_segment_accumulate`` (weight-free single
    descriptor), computed without any scatter.  ``stream_dtype`` casts the
    gathered gradient stream (mixed-precision streams); every reduction
    accumulates at float32 (or the native wide dtype).
    """
    if chunk is None:
        # Chunk width of the prefix matmul (scripts/bench_ab.py pd_chunk*
        # variants sweep it).
        chunk = int(os.environ.get("CUNVSM_PREFIX_CHUNK", "128"))
    n_inst, window = indices.shape
    dim = grad.shape[1]
    n = n_inst * window
    v_rows = num_rows

    if stream_dtype is not None and jnp.dtype(stream_dtype) != grad.dtype:
        acc_dtype = grad.dtype
        grad = grad.astype(stream_dtype)
    else:
        acc_dtype = (
            jnp.float32 if grad.dtype == jnp.bfloat16 else grad.dtype
        )

    # --- 1. merged packed keys: updates + one sentinel per row -------------
    idx = indices.reshape(-1).astype(jnp.uint32)
    ptr = jnp.arange(n, dtype=jnp.uint32) // jnp.uint32(window)
    key_stream = (idx << 16) | ptr
    key_sent = (jnp.arange(v_rows, dtype=jnp.uint32) << 16) | jnp.uint32(
        _SENTINEL_PTR
    )
    merged = jnp.concatenate([key_stream, key_sent])
    m = n + v_rows
    (key_s,) = jax.lax.sort((merged,), num_keys=1)
    ptr_s = key_s & jnp.uint32(0xFFFF)

    # --- 2. sentinel positions, in row order -------------------------------
    pos = jnp.arange(m, dtype=jnp.uint32)
    packed2 = jnp.where(
        ptr_s == jnp.uint32(_SENTINEL_PTR), pos, jnp.uint32(0xFFFFFFFF)
    )
    (p2,) = jax.lax.sort((packed2,), num_keys=1)
    p_v = p2[:v_rows]  # position of row v's sentinel in the sorted stream

    # --- 3. gather the update stream (sentinels hit a zero row) ------------
    pad = (-m) % chunk
    if pad:
        ptr_s = jnp.concatenate(
            [ptr_s, jnp.full((pad,), _SENTINEL_PTR, jnp.uint32)]
        )
    grad_padded = jnp.concatenate(
        [grad, jnp.zeros((1, dim), grad.dtype)]
    )
    take_idx = jnp.minimum(ptr_s, jnp.uint32(n_inst)).astype(jnp.int32)
    a = jnp.take(grad_padded, take_idx, axis=0, mode="clip")  # [m + pad, d]

    # --- 4. hierarchical inclusive prefix ----------------------------------
    num_chunks = (m + pad) // chunk
    a3 = a.reshape(num_chunks, chunk, dim)
    tril = jnp.tril(jnp.ones((chunk, chunk), a.dtype))
    # cc[i, c, :] = sum_{j <= i} a3[c, j, :] — kept in [chunk, num_chunks,
    # dim] layout (the natural dot_general result order) so both consumers
    # below are contiguous-row ops: the chunk totals are the slice
    # cc[chunk-1] and the sentinel lookups are plain row gathers.
    cc = jax.lax.dot_general(
        tril,
        a3,
        (((1,), (1,)), ((), ())),
        preferred_element_type=acc_dtype,
    )  # [chunk, num_chunks, dim]
    totals = cc[chunk - 1]  # [num_chunks, dim]
    gp = jnp.cumsum(totals, axis=0) - totals  # exclusive chunk prefix

    # --- 5. prefix differences at the sentinels ----------------------------
    c_v = (p_v // jnp.uint32(chunk)).astype(jnp.int32)
    j_v = (p_v % jnp.uint32(chunk)).astype(jnp.int32)
    cc_flat = cc.reshape(chunk * num_chunks, dim)
    gs = jnp.take(gp, c_v, axis=0, mode="clip") + jnp.take(
        cc_flat, j_v * num_chunks + c_v, axis=0, mode="clip"
    )  # [v_rows, dim]: inclusive prefix through row v's last update
    out = gs - jnp.concatenate([jnp.zeros((1, dim), gs.dtype), gs[:-1]])
    return out.astype(acc_dtype)
