"""Sharded query serving: doc-score matmul + distributed top-k merge.

The serving analog of the training-side entity sharding (SURVEY.md §2.4,
§3.4): the L2-normalized document matrix is sharded row-wise over the
``model`` axis, every device scores its shard of documents against the
(replicated) projected queries and takes a local top-k, and the global
ranking is the top-k of the gathered per-shard candidates.

The communication pattern is written out explicitly with ``shard_map``
rather than left to GSPMD: each shard contributes exactly k (value, global
doc id) candidate pairs to one all-gather of [Q, shards * k] — the full
[Q, D] score matrix never crosses the interconnect.
tests/test_sharding.py compiles this on an 8-device mesh and asserts the property on the optimized HLO
(no collective moves more than the candidate volume).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cunvsm.parallel.mesh import MODEL_AXIS


def make_sharded_scorer(
    mesh: Mesh, entity_norm: jax.Array, top_k: int, num_docs: int = None
):
    """Build a jit'd scorer over a row-sharded normalized document matrix.

    Returns (scorer, sharded_entity_matrix); scorer(projected_queries) ->
    (scores [Q, k], doc_indices [Q, k]) with global document indices,
    replicated on every device.

    ``num_docs``: the true (unpadded) document count.  Must be passed when
    ``entity_norm`` was already row-padded by a previous call — otherwise
    the padding mask would treat the zero pad rows as real documents.
    """
    if num_docs is None:
        num_docs = entity_norm.shape[0]
    k = min(top_k, num_docs)
    n_shards = mesh.shape[MODEL_AXIS]

    # Row-pad so the document axis divides the model axis; padded rows are
    # masked out of the merge by their out-of-range global ids.  The input
    # may already be padded (a cached sharded copy from a previous call).
    padded = ((num_docs + n_shards - 1) // n_shards) * n_shards
    if entity_norm.shape[0] not in (num_docs, padded):
        raise ValueError(
            f"entity matrix has {entity_norm.shape[0]} rows; expected "
            f"{num_docs} (unpadded) or {padded} (padded for {n_shards} "
            "shards)"
        )
    if entity_norm.shape[0] != padded:
        entity_norm = jnp.concatenate(
            [
                entity_norm,
                jnp.zeros(
                    (padded - entity_norm.shape[0], entity_norm.shape[1]),
                    entity_norm.dtype,
                ),
            ]
        )
    shard_rows = padded // n_shards
    local_k = min(k, shard_rows)

    e_sh = NamedSharding(mesh, P(MODEL_AXIS, None))
    entity_sharded = jax.device_put(entity_norm, e_sh)
    repl = NamedSharding(mesh, P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(MODEL_AXIS, None)),
        out_specs=(P(), P()),
        # The merged top-k is value-replicated over the model axis (every
        # shard merges the same gathered candidates); the static checker
        # cannot infer that through all_gather + top_k.
        check_vma=False,
    )
    def _score(q_norm: jax.Array, e_shard: jax.Array):
        # Local scoring + local top-k: [Q, shard_rows] stays on-device.
        scores = jnp.dot(
            q_norm, e_shard.T, preferred_element_type=jnp.float32
        )
        values, local_idx = jax.lax.top_k(scores, local_k)
        shard = jax.lax.axis_index(MODEL_AXIS)
        global_idx = local_idx + shard * shard_rows
        # Mask row padding so it can never enter the merged ranking.
        values = jnp.where(global_idx < num_docs, values, -jnp.inf)
        # The only cross-shard traffic: k candidates per shard per query.
        all_values = jax.lax.all_gather(
            values, MODEL_AXIS, axis=1, tiled=True
        )  # [Q, n_shards * local_k]
        all_idx = jax.lax.all_gather(
            global_idx, MODEL_AXIS, axis=1, tiled=True
        )
        merged_values, merge_pos = jax.lax.top_k(all_values, k)
        merged_idx = jnp.take_along_axis(all_idx, merge_pos, axis=1)
        return merged_values, merged_idx

    @partial(jax.jit, out_shardings=(repl, repl))
    def scorer(q_norm: jax.Array) -> Tuple[jax.Array, jax.Array]:
        return _score(q_norm, entity_sharded)

    return scorer, entity_sharded
