"""On-device instance sampling: the fully on-device data path.

The host pipeline (instances.py) replicates the reference's epoch semantics
exactly but ships every batch over host->device transfer.  For stochastic
training (the canonical NVSM/LSE configuration) the sampling itself is just
"uniform document, uniform window position" — expressible in jax — so the
packed token array can live in HBM and the *training step samples its own
batch* inside the same compiled program.  The host sends nothing per step
but a PRNG key.

Two sampling modes:

* **epoch-exact** (default): reproduces the reference's
  StochasticInstanceGenerator semantics (data_indri.cpp:224-410) — every
  eligible document contributes exactly ceil(avg_len - w + 1) instances per
  epoch, globally shuffled.  The per-epoch document-pointer permutation is
  regenerated *on device* (one jitted permutation per epoch, carried across
  multi-step calls by a cursor); window positions are uniform per draw, as
  in the reference (data_indri.cpp:300-322 draws them fresh at each reset).
* **i.i.d.** (``epoch_exact=False``): documents drawn uniformly per batch —
  identical in expectation, without the per-epoch count guarantee; no
  per-epoch permutation state.

Weighting strategies are supported on device (UNIFORM -> 1;
INV_DOC_FREQUENCY -> avg_len/len; self-information feature weights via a
device table).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.data.corpus import Corpus
from cunvsm.data.instances import FeatureWeighting, Weighting
from cunvsm.models.objectives import TextEntityBatch


class DeviceCorpus(NamedTuple):
    """Device-resident packed corpus slices needed for sampling."""

    tokens: jax.Array  # [total_tokens] int32
    doc_offsets: jax.Array  # [num_docs] int64->int32 start offsets
    doc_lengths: jax.Array  # [num_docs] int32 in-vocab lengths
    eligible: jax.Array  # [num_eligible] int32 doc ids with len >= window
    # None under UNIFORM weighting (all ones — skipping the gather saves a
    # [B]-row per-row-rate-bound take per step).
    inv_doc_weight: Optional[jax.Array]  # [num_docs] float32 or None
    term_weights: Optional[jax.Array]  # [vocab] float32 or None
    window_size: int
    # (offset, length) packed per doc: ONE [B]-row gather per batch
    # instead of two (the gather emitter is per-row-rate-bound, so the
    # 2-wide row costs the same as a 1-wide one).
    doc_meta: Optional[jax.Array] = None  # [num_docs, 2] int32
    # Overlapped wide-row view of ``tokens``: row r = tokens[rG : rG+2G]
    # (G = WIDE_ROW_STRIDE), so any W <= G+1 window lives inside ONE row.
    # The gather emitter on this toolchain is per-ROW-rate-bound
    # (~14-20 ns/row regardless of row width), so fetching a [B, W]
    # window batch as B wide rows + an in-register shift costs ~W times
    # less than the B*W single-token gathers it replaces, for 2x token
    # memory.  None when window_size > G+1.
    tokens_wide: Optional[jax.Array] = None  # [ceil(N/G)+1, 2G] u16/int32
    # Same overlapped view of the per-token SELF_INFORMATION weights
    # (term_weights[tokens] precomputed host-side): the feature-weight
    # fetch rides the same one-row-per-instance gather + shift-selects
    # instead of a B*W per-element take.  None under UNIFORM weighting.
    term_weights_wide: Optional[jax.Array] = None  # [ceil(N/G)+1, 2G] f32


# Wide-row stride (G).  2G = 32 int32 per row; windows up to G+1 = 17
# tokens (the canonical configuration uses 10) resolve inside one row.
WIDE_ROW_STRIDE = 16


def prepare_device_corpus(
    corpus: Corpus,
    weighting: Weighting = Weighting.UNIFORM,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
) -> DeviceCorpus:
    w = corpus.window_size
    lengths = corpus.doc_lengths.astype(np.int32)
    eligible = np.flatnonzero(lengths >= w).astype(np.int32)
    if weighting == Weighting.INV_DOC_FREQUENCY:
        avg = float(lengths[eligible].mean()) if len(eligible) else 0.0
        inv = jnp.asarray((avg / np.maximum(lengths, 1)).astype(np.float32))
    else:
        inv = None  # uniform: weights are all ones, no per-batch gather
    term_weights = None
    if feature_weighting == FeatureWeighting.SELF_INFORMATION:
        term_weights = jnp.asarray(
            corpus.vocab.self_information().astype(np.float32)
        )
    tokens_wide = None
    term_weights_wide = None
    if w <= WIDE_ROW_STRIDE + 1:
        g = WIDE_ROW_STRIDE
        n = len(corpus.tokens)
        num_rows = -(-n // g) + 1

        def overlapped(flat, dt):
            padded = np.zeros(num_rows * g + g, dtype=dt)
            padded[:n] = flat
            wide = np.lib.stride_tricks.as_strided(
                padded,
                shape=(num_rows, 2 * g),
                strides=(g * padded.itemsize, padded.itemsize),
            )
            return jnp.asarray(np.ascontiguousarray(wide))

        # Word ids < 65536 fit uint16: half the gathered bytes per row
        # (the canonical vocabulary is capped at exactly 65536).
        tokens_wide = overlapped(
            corpus.tokens,
            np.uint16 if corpus.vocab.size <= 65536 else np.int32,
        )
        if term_weights is not None:
            term_weights_wide = overlapped(
                np.asarray(term_weights)[corpus.tokens], np.float32
            )
    return DeviceCorpus(
        tokens=jnp.asarray(corpus.tokens, jnp.int32),
        doc_offsets=jnp.asarray(corpus.doc_offsets[:-1], jnp.int32),
        doc_lengths=jnp.asarray(lengths),
        eligible=jnp.asarray(eligible),
        inv_doc_weight=inv,
        term_weights=term_weights,
        window_size=w,
        tokens_wide=tokens_wide,
        term_weights_wide=term_weights_wide,
        doc_meta=jnp.asarray(
            np.stack(
                [corpus.doc_offsets[:-1].astype(np.int32), lengths], axis=1
            )
        ),
    )


def epoch_doc_pointers(dc: DeviceCorpus) -> jax.Array:
    """The per-epoch instance multiset: every eligible document repeated
    samples_per_doc = max(ceil(avg_invocab_len - w + 1), 1) times
    (data_indri.cpp:337-344 — the count is the same for every document)."""
    import math

    lengths = np.asarray(dc.doc_lengths)[np.asarray(dc.eligible)]
    avg = float(lengths.mean()) if len(lengths) else 0.0
    samples_per_doc = max(int(math.ceil(avg - dc.window_size + 1)), 1)
    return jnp.asarray(
        np.repeat(np.asarray(dc.eligible), samples_per_doc), jnp.int32
    )


def _perm_slice(doc_perm: jax.Array, cursor, batch_size: int) -> jax.Array:
    """Next batch_size pointers from the shuffled epoch array.

    The trainer's epoch accounting guarantees cursor + B <= len(doc_perm)
    (steps_epoch = min(batches, ptrs // B)), so the in-contract fetch is a
    CONTIGUOUS slice — lax.dynamic_slice is bandwidth-bound (~200 KB at the
    canonical batch) where the previous modular take was a B-row gather on
    the per-row-rate-bound gather emitter (~0.4 ms/step).  The modular wrap
    survives only for corpora smaller than one batch, where dynamic_slice
    could not produce B elements.

    ``doc_perm`` is either [n] doc ids or [n, 3] packed pointer meta rows
    (doc, offset, length — see ``epoch_ptr_meta``); the slice is contiguous
    either way.
    """
    if doc_perm.ndim == 2:
        if doc_perm.shape[0] >= batch_size:
            cursor = jnp.asarray(cursor)
            return jax.lax.dynamic_slice(
                doc_perm,
                (cursor, jnp.zeros((), cursor.dtype)),
                (batch_size, doc_perm.shape[1]),
            )
        idx = (
            cursor + jnp.arange(batch_size, dtype=jnp.int32)
        ) % doc_perm.shape[0]
        return jnp.take(doc_perm, idx, axis=0)
    if doc_perm.shape[0] >= batch_size:
        return jax.lax.dynamic_slice(doc_perm, (cursor,), (batch_size,))
    idx = (cursor + jnp.arange(batch_size, dtype=jnp.int32)) % doc_perm.shape[0]
    return jnp.take(doc_perm, idx)


def sample_batch(
    dc: DeviceCorpus,
    key: jax.Array,
    batch_size: int,
    docs: Optional[jax.Array] = None,
) -> TextEntityBatch:
    """Sample one training batch on device (jit-compatible).

    ``docs`` overrides document selection (the epoch-exact path feeds a
    slice of the shuffled per-epoch pointer array); positions are always
    uniform per draw.  A 2-D ``docs`` of [B, 3] packed pointer-meta rows
    (doc, offset, length — ``epoch_ptr_meta``) carries the document
    metadata inline, skipping the per-step [B]-row doc-meta gather
    entirely (~0.4 ms/step at the canonical batch: the meta rides the
    per-epoch permutation's row gather instead, where extra row width is
    free on the per-row-rate-bound gather emitter).
    """
    k_doc, k_pos = jax.random.split(key)
    if docs is not None and docs.ndim == 2:
        docs, offsets, lengths = docs[:, 0], docs[:, 1], docs[:, 2]
    else:
        if docs is None:
            eligible_idx = jax.random.randint(
                k_doc, (batch_size,), 0, dc.eligible.shape[0]
            )
            docs = jnp.take(dc.eligible, eligible_idx)
        if dc.doc_meta is not None:
            meta = jnp.take(dc.doc_meta, docs, axis=0)  # [B,2] (offset,len)
            offsets, lengths = meta[:, 0], meta[:, 1]
        else:
            offsets = jnp.take(dc.doc_offsets, docs)
            lengths = jnp.take(dc.doc_lengths, docs)
    max_pos = lengths - dc.window_size + 1
    # floor(u * n) with the maximal f32 u < 1 can round UP to exactly n
    # (the product lands half an ulp below n and ties-to-even) — clamp,
    # or ~2^-24 of draws sample a window one token past the doc end.
    pos = jnp.minimum(
        jnp.floor(
            jax.random.uniform(k_pos, (batch_size,))
            * max_pos.astype(jnp.float32)
        ).astype(jnp.int32),
        max_pos - 1,
    )
    base = offsets + pos
    feature_weights = None
    if dc.tokens_wide is not None:
        # Wide-row fetch: the gather emitter is per-ROW-rate-bound, so
        # fetch each instance's window as ONE row of the overlapped
        # [.., 2G] token view (B rows instead of B*W), then align the
        # window to the row head with log2(G) constant-shift selects —
        # pure elementwise ops that fuse, no per-element gather.
        g = WIDE_ROW_STRIDE
        row = base // g
        off = base - row * g

        def align(rows):
            bit = g // 2
            while bit:
                take_hi = (off & bit).astype(bool)[:, None]
                rows = jnp.where(
                    take_hi, rows[:, bit:], rows[:, : rows.shape[1] - bit]
                )
                bit //= 2
            return rows[:, : dc.window_size]

        features = align(
            jnp.take(dc.tokens_wide, row, axis=0)
        ).astype(jnp.int32)
        if dc.term_weights_wide is not None:
            # SELF_INFORMATION weights ride the same row fetch.
            feature_weights = align(
                jnp.take(dc.term_weights_wide, row, axis=0)
            )
    else:
        # Fallback for windows wider than one row: W independent [B]-row
        # 1-D gathers (this toolchain's gather emitter handles a [B,W]
        # 2-D-index take poorly — 8.6 vs 1.4 ms microbenched at the
        # canonical 51200x10 batch).
        features = jnp.stack(
            [jnp.take(dc.tokens, base + j) for j in range(dc.window_size)],
            axis=1,
        )
    if feature_weights is None:
        if dc.term_weights is not None:
            feature_weights = jnp.take(dc.term_weights, features)
        else:
            feature_weights = jnp.ones_like(features, jnp.float32)
    if dc.inv_doc_weight is not None:
        weights = jnp.take(dc.inv_doc_weight, docs)
    else:
        weights = jnp.ones((batch_size,), jnp.float32)
    return TextEntityBatch(
        features=features,
        feature_weights=feature_weights,
        labels=docs,
        weights=weights,
    )


def make_device_sampled_sharded_multistep(
    desc,
    cfg,
    dc: DeviceCorpus,
    num_steps: int,
    mesh,
    params,
    opt_state,
    num_entities: Optional[int] = None,
    epoch_exact: bool = True,
):
    """Mesh x on-device-sampling composition: K sharded steps per compiled
    call, each sampling its own batch from the (replicated) device corpus;
    sampled batches are sharding-constrained over the data axis so GSPMD
    partitions the step exactly like the host-fed sharded path.  With
    ``epoch_exact`` the runner takes the replicated shuffled pointer array
    and a cursor (see make_device_sampled_multistep)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cunvsm.parallel.mesh import (
        DATA_AXIS,
        opt_state_shardings,
        param_shardings,
        shard_tree,
    )
    from cunvsm.train.step import make_train_step

    # The shard_mapped word accumulation (optim.updates.
    # _data_sharded_accumulate) splits the update stream over EVERY mesh
    # axis; validate the divisibility up front with a clear message (the
    # same check trainer.py applies to the host-fed path).
    n_devices = int(np.prod(list(mesh.shape.values())))
    if cfg.batch_size % n_devices:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by the total "
            f"device count {n_devices} (mesh {dict(mesh.shape)}): the "
            f"sharded word accumulation splits the update stream over "
            f"every mesh axis"
        )

    p_sh = param_shardings(mesh, params)
    o_sh = opt_state_shardings(mesh, opt_state, params.num_entities)
    repl = NamedSharding(mesh, P())
    # mesh= engages the shard_mapped word-gradient accumulation.  Without
    # it GSPMD hits its replicate-on-unpartitionable fallback on the
    # accumulation sort and all-reduces the FULL B*W word update stream
    # (~614 MB/step at canonical shapes) — asserted against in
    # tests/test_sharding.py::test_device_sampled_sharded_comm_volume.
    step = make_train_step(
        desc, cfg, jit=False, num_entities=num_entities, mesh=mesh
    )

    def constrain(batch):
        return jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(
                x,
                NamedSharding(
                    mesh, P(DATA_AXIS, *([None] * (x.ndim - 1)))
                ),
            ),
            batch,
        )

    if epoch_exact:

        def multistep(params, opt_state, key, doc_perm, start):
            keys = jax.random.split(key, num_steps)

            def body(carry, k):
                p, o, cursor = carry
                k_batch, k_step = jax.random.split(k)
                docs = _perm_slice(doc_perm, cursor, cfg.batch_size)
                batch = constrain(
                    sample_batch(dc, k_batch, cfg.batch_size, docs=docs)
                )
                p, o, cost = step(p, o, batch, k_step)
                return (p, o, cursor + cfg.batch_size), cost

            (params, opt_state, _), costs = jax.lax.scan(
                body,
                (params, opt_state, jnp.asarray(start, jnp.int32)),
                keys,
            )
            return params, opt_state, costs

        sharded = jax.jit(
            multistep,
            in_shardings=(p_sh, o_sh, repl, repl, repl),
            out_shardings=(p_sh, o_sh, repl),
            donate_argnums=(0, 1),
        )
    else:

        def multistep(params, opt_state, key):
            keys = jax.random.split(key, num_steps)

            def body(carry, k):
                p, o = carry
                k_batch, k_step = jax.random.split(k)
                batch = constrain(sample_batch(dc, k_batch, cfg.batch_size))
                p, o, cost = step(p, o, batch, k_step)
                return (p, o), cost

            (params, opt_state), costs = jax.lax.scan(
                body, (params, opt_state), keys
            )
            return params, opt_state, costs

        sharded = jax.jit(
            multistep,
            in_shardings=(p_sh, o_sh, repl),
            out_shardings=(p_sh, o_sh, repl),
            donate_argnums=(0, 1),
        )
    return sharded, shard_tree(params, p_sh), shard_tree(opt_state, o_sh)


def make_device_sampled_multistep(
    desc,
    cfg,
    dc: DeviceCorpus,
    num_steps: int,
    num_entities: Optional[int] = None,
    epoch_exact: bool = True,
):
    """K training steps per compiled call, each sampling its own batch from
    the device-resident corpus.  The host's only per-call work is a PRNG
    key (plus, in epoch-exact mode, the shuffled pointer array and cursor).

    Returns the jitted runner:
      epoch-exact: step(params, opt_state, key, doc_perm, start)
      i.i.d.:      step(params, opt_state, key)
    both -> (params, opt_state, costs[K]).  Pair the exact runner with
    ``make_epoch_permuter`` — the trainer regenerates the permutation once
    per epoch on device and advances ``start`` by K * batch_size per call.
    """
    from cunvsm.train.step import make_train_step

    step = make_train_step(
        desc, cfg, jit=False, num_entities=num_entities
    )

    if epoch_exact:

        def multistep(params, opt_state, key, doc_perm, start):
            keys = jax.random.split(key, num_steps)

            def body(carry, inputs):
                p, o, cursor = carry
                k = inputs
                k_batch, k_step = jax.random.split(k)
                docs = _perm_slice(doc_perm, cursor, cfg.batch_size)
                batch = sample_batch(dc, k_batch, cfg.batch_size, docs=docs)
                p, o, cost = step(p, o, batch, k_step)
                return (p, o, cursor + cfg.batch_size), cost

            (params, opt_state, _), costs = jax.lax.scan(
                body, (params, opt_state, jnp.asarray(start, jnp.int32)), keys
            )
            return params, opt_state, costs

        return jax.jit(multistep, donate_argnums=(0, 1))

    def multistep(params, opt_state, key):
        keys = jax.random.split(key, num_steps)

        def body(carry, k):
            p, o = carry
            k_batch, k_step = jax.random.split(k)
            batch = sample_batch(dc, k_batch, cfg.batch_size)
            p, o, cost = step(p, o, batch, k_step)
            return (p, o), cost

        (params, opt_state), costs = jax.lax.scan(
            body, (params, opt_state), keys
        )
        return params, opt_state, costs

    return jax.jit(multistep, donate_argnums=(0, 1))


def _token_balanced_groups(eligible, elig_lengths, n_groups):
    """Split eligible documents into ``n_groups`` contiguous-by-id groups
    with near-equal token mass: cut the token cumsum at multiples of
    total/n_groups."""
    cum = np.cumsum(elig_lengths)
    bounds = [0]
    for s in range(1, n_groups):
        bounds.append(
            int(np.searchsorted(cum, cum[-1] * s / n_groups, side="left"))
            + 1
        )
    bounds.append(len(eligible))
    bounds = np.maximum.accumulate(np.asarray(bounds))  # monotone guard
    groups = [eligible[bounds[s]:bounds[s + 1]] for s in range(n_groups)]
    if any(len(g) == 0 for g in groups):
        raise ValueError(
            "token-balanced split produced an empty shard; fewer data "
            "shards or more documents required"
        )
    return groups


class ShardedDeviceCorpus(NamedTuple):
    """Device corpus sharded over the mesh's data axis for multi-card scale.

    The replicated ``DeviceCorpus`` holds every chip a full copy of the
    packed token stream (2x token memory with the wide-row view) — fine at
    524k docs, a wall at collection scale.  Here documents are split into
    ``num_shards`` contiguous groups balanced by token count, each group's
    tokens RE-PACKED into a local stream, and every per-shard array is laid
    out ``[num_shards, ...]`` and device_put sharded over the data axis:
    chip (d, m) holds only data-group d's tokens.  Sampling runs inside a
    shard_map, so each data group draws its batch shard from purely local
    memory — no cross-chip token fetch, no replicated token array (asserted
    on compiled HLO in tests/test_sharding.py).

    Epoch semantics relative to the reference's StochasticInstanceGenerator
    (data_indri.cpp:224-410): every eligible document still contributes
    exactly ``samples_per_doc`` instances per epoch, but the shuffle is
    per-data-group rather than global, so each global batch is stratified
    (exactly B/n_data instances from every group) instead of exchangeable —
    the standard data-parallel relaxation.  Shards whose pointer arrays are
    shorter than the longest are padded by wrapping their own shuffled
    stream (<= samples_per_doc extra draws per shard per epoch).
    """

    tokens_wide: jax.Array  # [S, rows_pad, 2G] u16/i32, P(data, None, None)
    term_weights_wide: Optional[jax.Array]  # [S, rows_pad, 2G] f32 or None
    doc_meta: jax.Array  # [S, d_pad, 2] int32 (LOCAL offset, length)
    global_doc_id: jax.Array  # [S, d_pad] int32 (labels / entity rows)
    inv_doc_weight: Optional[jax.Array]  # [S, d_pad] f32 or None
    local_pointers: jax.Array  # [S, p_pad] int32 local doc indices
    window_size: int
    num_shards: int


def prepare_sharded_device_corpus(
    corpus: Corpus,
    mesh,
    weighting: Weighting = Weighting.UNIFORM,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
) -> ShardedDeviceCorpus:
    """Build the data-axis-sharded device corpus (see ShardedDeviceCorpus).

    Only the wide-row window fetch is supported (window <= G+1 — the
    canonical configuration); document groups are contiguous by id and
    balanced greedily by token count.
    """
    import math

    from jax.sharding import NamedSharding, PartitionSpec as P

    from cunvsm.parallel.mesh import DATA_AXIS

    w = corpus.window_size
    g = WIDE_ROW_STRIDE
    if w > g + 1:
        raise ValueError(
            f"sharded device corpus requires window_size <= {g + 1} "
            f"(wide-row fetch); got {w}"
        )
    n_data = mesh.shape[DATA_AXIS]
    lengths = corpus.doc_lengths.astype(np.int64)
    eligible = np.flatnonzero(lengths >= w).astype(np.int32)
    if len(eligible) < n_data:
        raise ValueError(
            f"{len(eligible)} eligible documents < data axis {n_data}"
        )
    elig_lengths = lengths[eligible]
    avg = float(elig_lengths.mean())
    samples_per_doc = max(int(math.ceil(avg - w + 1)), 1)
    shards = _token_balanced_groups(eligible, elig_lengths, n_data)

    d_pad = max(len(s) for s in shards)
    tok_counts = [int(lengths[s].sum()) for s in shards]
    rows_pad = max(-(-t // g) + 1 for t in tok_counts)
    p_pad = d_pad * samples_per_doc

    token_dt = np.uint16 if corpus.vocab.size <= 65536 else np.int32
    tokens_wide = np.zeros((n_data, rows_pad, 2 * g), token_dt)
    tw_wide = None
    term_weights = None
    if feature_weighting == FeatureWeighting.SELF_INFORMATION:
        term_weights = corpus.vocab.self_information().astype(np.float32)
        tw_wide = np.zeros((n_data, rows_pad, 2 * g), np.float32)
    doc_meta = np.zeros((n_data, d_pad, 2), np.int32)
    global_doc_id = np.zeros((n_data, d_pad), np.int32)
    inv_w = None
    if weighting == Weighting.INV_DOC_FREQUENCY:
        inv_w = np.ones((n_data, d_pad), np.float32)
    local_pointers = np.zeros((n_data, p_pad), np.int32)

    def overlapped(flat, dt):
        n = len(flat)
        padded = np.zeros(rows_pad * g + g, dtype=dt)
        padded[:n] = flat
        wide = np.lib.stride_tricks.as_strided(
            padded,
            shape=(rows_pad, 2 * g),
            strides=(g * padded.itemsize, padded.itemsize),
        )
        return np.ascontiguousarray(wide)

    for s, docs in enumerate(shards):
        # Re-pack this group's tokens contiguously with LOCAL offsets.
        pieces = [
            corpus.tokens[corpus.doc_offsets[d]:corpus.doc_offsets[d] +
                          lengths[d]]
            for d in docs
        ]
        flat = np.concatenate(pieces) if pieces else np.zeros(0, np.int32)
        tokens_wide[s] = overlapped(flat, token_dt)
        if tw_wide is not None:
            tw_wide[s] = overlapped(term_weights[flat], np.float32)
        local_off = np.concatenate(
            [[0], np.cumsum(lengths[docs])[:-1]]
        ).astype(np.int32)
        doc_meta[s, :len(docs), 0] = local_off
        doc_meta[s, :len(docs), 1] = lengths[docs]
        # Padded doc rows keep length >= window so a (never-pointed-at)
        # sample could not index out of bounds.
        doc_meta[s, len(docs):, 1] = w
        global_doc_id[s, :len(docs)] = docs
        if inv_w is not None:
            inv_w[s, :len(docs)] = (avg / np.maximum(lengths[docs], 1)
                                    ).astype(np.float32)
        ptrs = np.repeat(
            np.arange(len(docs), dtype=np.int32), samples_per_doc
        )
        # Pad short shards by wrapping their own stream (<= samples_per_doc
        # extra instances per shard per epoch, documented above).
        local_pointers[s] = np.resize(ptrs, p_pad)

    def put(arr, ndim_tail):
        sh = NamedSharding(mesh, P(DATA_AXIS, *([None] * ndim_tail)))
        return jax.device_put(jnp.asarray(arr), sh)

    return ShardedDeviceCorpus(
        tokens_wide=put(tokens_wide, 2),
        term_weights_wide=(
            put(tw_wide, 2) if tw_wide is not None else None
        ),
        doc_meta=put(doc_meta, 2),
        global_doc_id=put(global_doc_id, 1),
        inv_doc_weight=put(inv_w, 1) if inv_w is not None else None,
        local_pointers=put(local_pointers, 1),
        window_size=w,
        num_shards=n_data,
    )


def _make_sharded_sampler(sdc: ShardedDeviceCorpus, mesh, batch_size: int):
    """shard_mapped batch sampler: each data group draws its B/n_data batch
    shard from its local corpus shard; model-axis chips replicate the draw
    (same folded key, same local data)."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cunvsm.parallel.mesh import DATA_AXIS

    n_data = sdc.num_shards
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the corpus shard "
            f"count {n_data}"
        )
    b_local = batch_size // n_data
    g = WIDE_ROW_STRIDE
    w = sdc.window_size

    has_tw = sdc.term_weights_wide is not None
    has_invw = sdc.inv_doc_weight is not None

    data3 = P(DATA_AXIS, None, None)
    data2 = P(DATA_AXIS, None)
    repl = P()
    in_specs = [repl, repl, data3, data3, data2, data2]
    if has_tw:
        in_specs.insert(4, data3)
    if has_invw:
        in_specs.append(data2)
    out_specs = (data2, data2, P(DATA_AXIS), P(DATA_AXIS))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    def sample(key, cursor, *arrays):
        it = iter(arrays)
        tokens_wide = next(it)[0]
        tw_wide = next(it)[0] if has_tw else None
        doc_meta = next(it)[0]
        gdoc = next(it)[0]
        perm_row = next(it)[0]
        invw = next(it)[0] if has_invw else None

        di = jax.lax.axis_index(DATA_AXIS)
        k = jax.random.fold_in(key, di)
        # Contiguous pointer fetch (see _perm_slice): the global cursor //
        # n_data stays <= p_pad - b_local within an epoch because
        # num_calls is bounded by ptrs_per_epoch // batch_size.
        local_docs = _perm_slice(perm_row, cursor, b_local)
        meta = jnp.take(doc_meta, local_docs, axis=0)
        offsets, lengths = meta[:, 0], meta[:, 1]
        max_pos = lengths - w + 1
        pos = jnp.minimum(
            jnp.floor(
                jax.random.uniform(k, (b_local,))
                * max_pos.astype(jnp.float32)
            ).astype(jnp.int32),
            max_pos - 1,
        )
        base = offsets + pos
        row = base // g
        off = base - row * g

        def align(rows):
            bit = g // 2
            while bit:
                take_hi = (off & bit).astype(bool)[:, None]
                rows = jnp.where(
                    take_hi, rows[:, bit:], rows[:, : rows.shape[1] - bit]
                )
                bit //= 2
            return rows[:, :w]

        features = align(jnp.take(tokens_wide, row, axis=0)).astype(
            jnp.int32
        )
        if tw_wide is not None:
            feature_weights = align(jnp.take(tw_wide, row, axis=0))
        else:
            feature_weights = jnp.ones_like(features, jnp.float32)
        labels = jnp.take(gdoc, local_docs)
        if invw is not None:
            weights = jnp.take(invw, local_docs)
        else:
            weights = jnp.ones((b_local,), jnp.float32)
        return features, feature_weights, labels, weights

    def sampler(key, cursor):
        arrays = [sdc.tokens_wide]
        if has_tw:
            arrays.append(sdc.term_weights_wide)
        arrays += [sdc.doc_meta, sdc.global_doc_id, sdc.local_pointers]
        if has_invw:
            arrays.append(sdc.inv_doc_weight)
        f, fw, lab, wts = sample(key, cursor, *arrays)
        return TextEntityBatch(
            features=f, feature_weights=fw, labels=lab, weights=wts
        )

    return sampler, b_local


def make_corpus_sharded_multistep(
    desc,
    cfg,
    sdc: ShardedDeviceCorpus,
    num_steps: int,
    mesh,
    params,
    opt_state,
    num_entities: Optional[int] = None,
):
    """Mesh multistep whose corpus is data-axis-sharded (ShardedDeviceCorpus):
    same runner signature as the epoch-exact
    ``make_device_sampled_sharded_multistep`` — step(params, opt_state, key,
    doc_perm, start) with ``doc_perm`` the [n_data, p_pad] per-shard
    permutation from ``make_sharded_epoch_permuter`` and ``start`` the
    GLOBAL instance cursor (divided into the per-shard cursor inside)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cunvsm.parallel.mesh import (
        DATA_AXIS,
        opt_state_shardings,
        param_shardings,
        shard_tree,
    )
    from cunvsm.train.step import make_train_step

    n_devices = int(np.prod(list(mesh.shape.values())))
    if cfg.batch_size % n_devices:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by the total "
            f"device count {n_devices} (mesh {dict(mesh.shape)})"
        )

    p_sh = param_shardings(mesh, params)
    o_sh = opt_state_shardings(mesh, opt_state, params.num_entities)
    repl = NamedSharding(mesh, P())
    perm_sh = NamedSharding(mesh, P(DATA_AXIS, None))
    step = make_train_step(
        desc, cfg, jit=False, num_entities=num_entities, mesh=mesh
    )
    n_data = sdc.num_shards

    # The corpus arrays are explicit jit ARGUMENTS with data-axis
    # shardings: closure-captured device arrays lower to embedded HLO
    # constants at the full GLOBAL shape on every device — exactly the
    # replicated token array this path exists to eliminate (caught on
    # compiled HLO while building this).
    has_tw = sdc.term_weights_wide is not None
    has_invw = sdc.inv_doc_weight is not None
    corpus_arrays = [sdc.tokens_wide]
    if has_tw:
        corpus_arrays.append(sdc.term_weights_wide)
    corpus_arrays += [sdc.doc_meta, sdc.global_doc_id]
    if has_invw:
        corpus_arrays.append(sdc.inv_doc_weight)
    corpus_shs = tuple(
        NamedSharding(mesh, P(DATA_AXIS, *([None] * (a.ndim - 1))))
        for a in corpus_arrays
    )

    def multistep(params, opt_state, key, doc_perm, start, *arrays):
        it = iter(arrays)
        sdc_t = sdc._replace(
            tokens_wide=next(it),
            term_weights_wide=next(it) if has_tw else None,
            doc_meta=next(it),
            global_doc_id=next(it),
            inv_doc_weight=next(it) if has_invw else None,
            local_pointers=doc_perm,
        )
        keys = jax.random.split(key, num_steps)
        sampler, b_local = _make_sharded_sampler(
            sdc_t, mesh, cfg.batch_size
        )

        def body(carry, k):
            p, o, cursor = carry
            k_batch, k_step = jax.random.split(k)
            batch = sampler(k_batch, cursor)
            p, o, cost = step(p, o, batch, k_step)
            return (p, o, cursor + b_local), cost

        (params, opt_state, _), costs = jax.lax.scan(
            body,
            (params, opt_state,
             jnp.asarray(start, jnp.int32) // n_data),
            keys,
        )
        return params, opt_state, costs

    jitted = jax.jit(
        multistep,
        in_shardings=(p_sh, o_sh, repl, perm_sh, repl) + corpus_shs,
        out_shardings=(p_sh, o_sh, repl),
        donate_argnums=(0, 1),
    )

    class _Runner:
        """step(params, opt_state, key, doc_perm, start) with the corpus
        arrays bound as trailing jit arguments."""

        def __call__(self, params, opt_state, key, doc_perm, start):
            return jitted(
                params, opt_state, key, doc_perm, start, *corpus_arrays
            )

        def lower(self, params, opt_state, key, doc_perm, start):
            return jitted.lower(
                params, opt_state, key, doc_perm, start, *corpus_arrays
            )

    return _Runner(), shard_tree(params, p_sh), shard_tree(opt_state, o_sh)


def make_sharded_epoch_permuter(sdc: ShardedDeviceCorpus, mesh):
    """(jitted permute_fn, pointers_per_epoch): permute_fn(key) reshuffles
    every shard's local pointer array on device with a per-shard key
    (the per-group DataSource::reset)."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cunvsm.parallel.mesh import DATA_AXIS

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def go(key, ptrs):
        di = jax.lax.axis_index(DATA_AXIS)
        return jax.random.permutation(
            jax.random.fold_in(key, di), ptrs[0]
        )[None]

    # ptrs rides as an argument (a closure capture would lower to a
    # replicated full-shape HLO constant — see make_corpus_sharded_multistep).
    jitted = jax.jit(go)
    permute = lambda k: jitted(k, sdc.local_pointers)  # noqa: E731
    return permute, int(sdc.local_pointers.shape[1]) * sdc.num_shards


def epoch_ptr_meta(dc: DeviceCorpus) -> jax.Array:
    """The per-epoch pointer multiset with document metadata packed inline:
    [n_ptrs, 3] int32 rows of (doc, offset, length).  Shuffling these rows
    per epoch instead of bare doc ids costs nothing extra (the permutation's
    row gather is per-row-rate-bound, so a 12-byte row prices like a 4-byte
    one) and lets the per-step batch fetch carry offsets/lengths in the same
    contiguous ``dynamic_slice`` — no per-step [B]-row doc-meta gather."""
    ptrs = np.asarray(epoch_doc_pointers(dc))
    meta = np.asarray(dc.doc_meta)[ptrs]  # [n_ptrs, 2] (offset, length)
    return jnp.asarray(
        np.concatenate([ptrs[:, None], meta], axis=1), jnp.int32
    )


def _shuffle_columns(key, cols):
    """Shuffle N aligned [n] columns by one shared random order, reproducing
    ``jax.random.permutation``'s order exactly (same split sequence, same
    per-round 32-bit sort keys, same stable sorts — pinned by test against
    the 1-D permutation) while carrying every column as a sort PAYLOAD.
    This avoids the [n]-ROW gather jax's 2-D row permutation performs
    (``take(x, shuffled_arange)``) — at 29M pointer rows per canonical
    epoch that gather costs 0.15-0.4 s/epoch on the per-row-rate-bound
    gather emitter, more than the per-step doc-meta gathers it replaces."""
    n = int(cols[0].shape[0])
    # jax._src.random._shuffle's static round count (tjablin's analysis):
    # enough fresh-32-bit-key sorts that all pairwise collisions resolve.
    num_rounds = int(
        np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max))
    )
    for _ in range(num_rounds):
        key, subkey = jax.random.split(key)
        sort_keys = jax.random.bits(subkey, (n,), jnp.uint32)
        cols = jax.lax.sort(
            (sort_keys, *cols), dimension=0, is_stable=True, num_keys=1
        )[1:]
    return cols


def make_epoch_permuter(dc: DeviceCorpus):
    """(jitted permute_fn, pointers_per_epoch): permute_fn(key) shuffles the
    per-epoch document-pointer array on device (the DataSource::reset
    reshuffle, data_indri.cpp:328-398).  The shuffled array is [n_ptrs, 3]
    packed pointer-meta rows (``epoch_ptr_meta``), shuffled as three sort
    payloads sharing one key stream — the document order is seed-for-seed
    identical to the bare-id ``jax.random.permutation`` shuffle."""
    ptr_meta = epoch_ptr_meta(dc)
    cols = tuple(ptr_meta[:, j] for j in range(3))

    def permute(k):
        return jnp.stack(_shuffle_columns(k, cols), axis=1)

    return jax.jit(permute), int(ptr_meta.shape[0])


def make_stratified_epoch_permuter(
    dc: DeviceCorpus, num_groups: int, batch_size: int
):
    """Single-device permuter reproducing the data-axis-sharded corpus's
    epoch semantics, so the ``shard_corpus`` shuffle relaxation can be
    quality-A/B'd against the global shuffle without a mesh.

    Mirrors ``prepare_sharded_device_corpus`` + ``_make_sharded_sampler``:
    documents split into the same token-balanced contiguous groups, each
    group's wrap-padded pointer stream shuffled independently per epoch,
    and the flat stream interleaving ``b_local = batch_size/num_groups``
    consecutive pointers per group — every batch therefore draws exactly
    b_local instances from each group (stratified), exactly the sharded
    sampler's batch composition.  Group streams are wrap-padded to a
    common multiple of b_local (<= samples_per_doc + b_local - 1 extra
    draws per group per epoch); per-doc sample counts are otherwise exact.
    """
    import math

    if batch_size % num_groups:
        raise ValueError(
            f"batch_size {batch_size} not divisible by num_groups "
            f"{num_groups}"
        )
    b_local = batch_size // num_groups
    lengths = np.asarray(dc.doc_lengths)
    eligible = np.asarray(dc.eligible)
    elig_lengths = lengths[eligible]
    avg = float(elig_lengths.mean()) if len(elig_lengths) else 0.0
    samples_per_doc = max(int(math.ceil(avg - dc.window_size + 1)), 1)
    groups = _token_balanced_groups(eligible, elig_lengths, num_groups)
    d_pad = max(len(g) for g in groups)
    p_pad = -(-(d_pad * samples_per_doc) // b_local) * b_local
    ptrs = np.zeros((num_groups, p_pad), np.int32)
    for g, docs in enumerate(groups):
        ptrs[g] = np.resize(
            np.repeat(docs.astype(np.int32), samples_per_doc), p_pad
        )
    ptrs = jnp.asarray(ptrs)

    def permute(key):
        keys = jax.random.split(key, num_groups)
        shuffled = jax.vmap(jax.random.permutation)(keys, ptrs)
        blocks = shuffled.reshape(num_groups, p_pad // b_local, b_local)
        return jnp.transpose(blocks, (1, 0, 2)).reshape(-1)

    return jax.jit(permute), int(num_groups * p_pad)
