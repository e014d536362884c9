"""NVSM/LSE objectives as pure jax functions.

This module replaces the reference's Objective/ForwardResult/Gradients class
hierarchy (objective.cu, intermediate_results.cu) with pure functions and
``jax.value_and_grad``.  The hand-written CUDA backward passes (multipliers,
column negation, fold_columns, the transposed GEMMs) fall out of autodiff; the
deliberate asymmetries (surrogate sigmoid gradient, hard-tanh mask) live in
``cunvsm.ops.activations`` as custom-VJP ops.

Gradient contract: the reference performs gradient *ascent* on the
log-likelihood (model.cu:187-220 adds lr*grad).  We therefore expose
"ascent gradients" (the negation of d cost / d theta) so the optimizer
formulas in ``cunvsm.optim`` can mirror the CUDA update rules verbatim.

Sparse representation gradients keep the reference's descriptor structure
(intermediate_results.cu:283-317): a per-instance gradient matrix plus the
(indices, window, weights) needed for scatter-add — this is what the sparse
Adagrad/Adam modes consume.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cunvsm.config import ModelDesc, Nonlinearity, TrainConfig
from cunvsm.models.params import ModelParams
from cunvsm.ops.activations import (
    hard_tanh,
    l2_normalize_rows,
    log_truncated_sigmoid,
    truncated_sigmoid,
)
from cunvsm.ops.batchnorm import batch_norm_train


class TextEntityBatch(NamedTuple):
    """SoA batch for the text->entity objective (data.cu:8-60).

    features:        [B, W] int32 word ids.
    feature_weights: [B, W] per-term weights (uniform -> all ones;
                     self-information -> -log(tf/total), data.h:464-488).
    labels:          [B] int32 entity (document) ids.
    weights:         [B] per-instance weights.  Padding rows carry weight 0.
    negatives:       optional [B, k] int32 pre-drawn negative entity ids
                     (reference-RNG replay: the host minstd_rand0 stream,
                     labels.cu:3-22); None -> the step draws on device.
    """

    features: jax.Array
    feature_weights: jax.Array
    labels: jax.Array
    weights: jax.Array
    negatives: Optional[jax.Array] = None


class SimilarityBatch(NamedTuple):
    """Batch of (id, id, weight) pairs (data.cu:154-188)."""

    ids: jax.Array  # [B, 2] int32
    weights: jax.Array  # [B]


class SparseGrad(NamedTuple):
    """Sparse ascent-gradient descriptor for a representations table.

    Mirrors RepresentationsStorage::SingleGradientType
    (storage.h / intermediate_results.cu:283-317): scatter semantics are
    ``table[indices[i, w]] += lr * weights[i, w] * grad[i]`` for every
    instance i and window slot w (update_repr_kernel, storage.cu:37-49;
    duplicate indices accumulate).
    """

    grad: jax.Array  # [num_instances, dim]
    indices: jax.Array  # [num_instances, window] int32
    weights: Optional[jax.Array]  # [num_instances, window] or None


class AscentGrads(NamedTuple):
    """All gradients for one training step (cf. Gradients<FloatT>)."""

    word: Tuple[SparseGrad, ...]
    entity: Tuple[SparseGrad, ...]
    transform_w: Optional[jax.Array]
    transform_b: Optional[jax.Array]


def sample_negative_entities(
    key: jax.Array, labels: jax.Array, num_entities: int, num_negative: int
) -> jax.Array:
    """[positive, neg_1..neg_k] per instance (labels.cu:3-22).

    Negatives are uniform over [0, num_entities); the reference samples on
    the host with minstd_rand0, we use the jax PRNG on device.
    """
    negatives = jax.random.randint(
        key, (labels.shape[0], num_negative), 0, num_entities, dtype=labels.dtype
    )
    return jnp.concatenate([labels[:, None], negatives], axis=1)


def gather_phrase_reprs(
    word_reprs: jax.Array,
    features: jax.Array,
    feature_weights: Optional[jax.Array],
    window_sum_dtype=None,
) -> jax.Array:
    """Windowed weighted average of word representations.

    out[i] = (1/window) * sum_w feature_weights[i, w] * word_reprs[features[i, w]]
    (average_repr_kernel, params.cu:77-95; note division by window, not by the
    weight sum).  ``feature_weights=None`` means statically-uniform weights
    (all ones) and skips the multiply.

    When ``word_reprs`` is bfloat16 (mixed-precision streams) the gather and
    multiply run at half traffic while the window reduction accumulates in
    float32.
    """
    window = features.shape[1]
    # mode="clip": ids are in-range by construction; the default fill mode
    # adds a bounds mask + NaN select on every gathered element.  The
    # gather stays in its native flat [B*W, d] layout and the window sum
    # runs as a strided reduce_window over consecutive row groups — a 3D
    # [B, W, d] view would force a full retile copy of the gathered stream
    # on this toolchain (~1.6 ms/step at canonical shapes, trace-verified),
    # and a dtype-widening jnp.sum additionally materializes a full-width
    # f32 copy before the reduce.
    flat = jnp.take(
        word_reprs, features.reshape(-1), axis=0, mode="clip"
    )  # [B*W, d]
    acc_dtype = jnp.float32 if flat.dtype == jnp.bfloat16 else flat.dtype
    if feature_weights is not None:
        flat = flat * feature_weights.reshape(-1).astype(flat.dtype)[:, None]
    if (
        window_sum_dtype is not None
        and jnp.dtype(window_sum_dtype) == flat.dtype
    ):
        # Stream-width window accumulation (TrainConfig.window_sum_dtype):
        # the 10-element sum runs at stream width and widens after.
        sum_dtype = flat.dtype
    else:
        flat = flat.astype(acc_dtype)
        sum_dtype = acc_dtype
    summed = jax.lax.reduce_window(
        flat,
        jnp.zeros((), sum_dtype),
        jax.lax.add,
        window_dimensions=(window, 1),
        window_strides=(window, 1),
        padding="VALID",
    )  # [B, d]
    return (summed / window).astype(acc_dtype)


def apply_transform(
    phrase: jax.Array,
    transform_w: jax.Array,
    transform_b: jax.Array,
    desc: ModelDesc,
    batch_normalization: bool,
) -> jax.Array:
    """phrase -> entity-space projection (Transform::transform, params.cu:377-451).

    Either ``tanh/hard_tanh(x @ W + b)`` or, with batch normalization,
    ``tanh/hard_tanh(BN(x @ W) + b)`` where the bias is BN's beta
    (cudnn_utils.cu:107-124).
    """
    projected = jnp.dot(
        phrase, transform_w, preferred_element_type=phrase.dtype
    )
    if batch_normalization:
        projected = batch_norm_train(projected, transform_b, desc.batch_norm_eps)
    else:
        projected = projected + transform_b[None, :]
    if desc.nonlinearity == Nonlinearity.TANH:
        return jnp.tanh(projected)
    elif desc.nonlinearity == Nonlinearity.HARD_TANH:
        return hard_tanh(projected)
    raise ValueError(f"unknown nonlinearity {desc.nonlinearity}")


def nce_instance_weights(
    weights: jax.Array, num_negative: int, desc: ModelDesc
) -> jax.Array:
    """Broadcast instance weights over the (k+1) slots with the
    negative-sampling bias correction (objective.cu:258-290).

    When ``bias_negative_samples`` is off and k > 1, every weight is scaled by
    (k+1)/(2k) and positives are additionally scaled by k, keeping the total
    mass constant while balancing positive/negative contributions.
    """
    k = num_negative
    broadcast = jnp.repeat(weights[:, None], k + 1, axis=1)
    if not desc.bias_negative_samples and k > 1:
        broadcast = broadcast * ((k + 1.0) / (2.0 * k))
        positive_scale = jnp.concatenate(
            [jnp.full((1,), float(k)), jnp.ones((k,))]
        ).astype(broadcast.dtype)
        broadcast = broadcast * positive_scale[None, :]
    return broadcast


class TextEntityIntermediates(NamedTuple):
    """Pre-gathered tensors that gradients are taken with respect to.

    ``phrase_pre`` is the windowed average *before* the optional L2
    normalizer; the reference's sparse word-gradient descriptor is
    d cost / d phrase_pre divided by the window (objective.cu:444-478).
    ``entity_pre`` are the gathered entity vectors before normalization /
    negation (objective.cu:164-189).
    """

    phrase_pre: jax.Array  # [B, d_w]
    entity_pre: jax.Array  # [B, K+1, d_e]


def text_entity_loss(
    inter: TextEntityIntermediates,
    transform_w: jax.Array,
    transform_b: jax.Array,
    nce_weights: jax.Array,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float,
):
    """NCE loss given gathered tensors (objective.cu:30-313).

    Returns (cost, similarity_probs).  cost = -(sum of weighted log
    probabilities) / batch_size (SimpleForwardResult::get_cost,
    intermediate_results.cu:81-124).
    """
    phrase = inter.phrase_pre
    if desc.l2_normalize_phrase_reprs:
        phrase = l2_normalize_rows(phrase)

    projections = apply_transform(
        phrase, transform_w, transform_b, desc, desc.batch_normalization
    )  # [B, d_e]

    entity = inter.entity_pre
    if desc.l2_normalize_entity_reprs:
        entity = l2_normalize_rows(entity)

    k_plus_1 = entity.shape[1]
    # Negate non-positive columns: sigmoid(-x) = 1 - sigmoid(x)
    # (objective.cu:176-189).
    signs = jnp.concatenate(
        [jnp.ones((1,)), -jnp.ones((k_plus_1 - 1,))]
    ).astype(entity.dtype)
    dots = jnp.einsum("bd,bkd->bk", projections, entity) * signs[None, :]

    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0
    log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
    similarity_probs = truncated_sigmoid(dots, eps_f)

    pointwise_mass = nce_weights * log_probs
    cost = -jnp.sum(pointwise_mass) / batch_size_normalizer
    return cost, similarity_probs


def text_entity_cost(
    params: ModelParams,
    batch: TextEntityBatch,
    entity_ids: jax.Array,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float | None = None,
):
    """Forward-only cost (Model::get_cost parity)."""
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    inter = TextEntityIntermediates(
        phrase_pre=gather_phrase_reprs(
            params.word_reprs, batch.features, batch.feature_weights
        ),
        entity_pre=jnp.take(
            params.entity_reprs, entity_ids, axis=0, mode="clip"
        ),
    )
    nce_w = nce_instance_weights(batch.weights, entity_ids.shape[1] - 1, desc)
    return text_entity_loss(
        inter,
        params.transform_w,
        params.transform_b,
        nce_w,
        desc,
        batch_size_normalizer,
    )


def text_entity_cost_and_grads(
    params: ModelParams,
    batch: TextEntityBatch,
    entity_ids: jax.Array,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float | None = None,
    factored_entity_grads: bool = False,
    stream_dtype=None,
    uniform_feature_weights: bool = False,
    window_sum_dtype=None,
):
    """Cost + ascent gradients in the reference's sparse-descriptor form.

    Word descriptor: (d ascent / d phrase_pre) / window with the batch's word
    indices and feature weights (objective.cu:444-478 + the scatter contract
    in intermediate_results.cu:283-298).
    Entity descriptor: d ascent / d entity_pre — either flattened to one row
    per (instance, slot) with window 1 (the reference layout,
    intermediate_results.cu:300-308), or, with ``factored_entity_grads``,
    in rank-1 factored form: the per-entity gradient is
    sign * multiplier * projection (objective.cu:380-403), so the descriptor
    carries (projections [B, d], entity_ids [B, K+1], signed multipliers) —
    the scatter accumulates identically while never materializing the
    [B, K+1, d] gradient.  Exact for accumulate-only optimizer paths (SGD,
    full_adam); the window-averaged statistics of sparse Adagrad/Adam and
    the entity L2-normalizer need the expanded layout.
    ``uniform_feature_weights`` statically promises batch.feature_weights
    are all ones (TrainConfig.uniform_feature_weights): the window average
    skips its multiply and the word descriptor carries ``weights=None``,
    enabling the packed single-operand accumulation sort.
    """
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    window = batch.features.shape[1]
    num_negative = entity_ids.shape[1] - 1
    feature_weights = (
        None if uniform_feature_weights else batch.feature_weights
    )

    use_factored = factored_entity_grads and not desc.l2_normalize_entity_reprs

    word_table = params.word_reprs
    entity_table = params.entity_reprs
    if (
        stream_dtype is not None
        and use_factored
        and jnp.dtype(stream_dtype) != word_table.dtype
    ):
        # Mixed-precision streams (factored path): bf16 table copies feed
        # the gathers and NCE dots, so the per-instance streams move half
        # the bytes.  Masters stay float32.
        word_table = word_table.astype(stream_dtype)
        entity_table = entity_table.astype(stream_dtype)

    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    entity_pre = jnp.take(entity_table, entity_ids, axis=0, mode="clip")
    nce_w = nce_instance_weights(batch.weights, num_negative, desc)

    if use_factored:
        return _cost_and_grads_factored(
            phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
            batch_size_normalizer, window, feature_weights,
        )

    inter = TextEntityIntermediates(
        phrase_pre=phrase_pre, entity_pre=entity_pre
    )

    def loss_fn(inter_, w_, b_):
        return text_entity_loss(
            inter_, w_, b_, nce_w, desc, batch_size_normalizer
        )

    (cost, similarity_probs), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True
    )(inter, params.transform_w, params.transform_b)
    g_inter, g_w, g_b = grads

    entity_dim = inter.entity_pre.shape[-1]
    ascent = AscentGrads(
        word=(
            SparseGrad(
                grad=-g_inter.phrase_pre / window,
                indices=batch.features,
                weights=feature_weights,
            ),
        ),
        entity=(
            SparseGrad(
                grad=-g_inter.entity_pre.reshape(-1, entity_dim),
                indices=entity_ids.reshape(-1, 1),
                weights=None,
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent


def _cost_and_grads_factored(
    phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
    batch_size_normalizer, window, feature_weights,
):
    """Rank-1 entity-gradient variant with explicitly staged VJPs.

    The entity gathers stay out of every differentiated graph, and the two
    large einsums over ``entity_pre`` (the NCE dots and their transpose)
    are written out by hand with both operands at the stream dtype — under
    mixed precision, autodiff's transpose would otherwise promote the
    bfloat16 entity stream to a materialized float32 copy, re-spending the
    bandwidth the stream dtype saves.  Gradient math:

      d cost / d proj[b]        = sum_k g_dots_raw[b, k] * entity_pre[b, k]
      d ascent / d entity[b, k] = -g_dots_raw[b, k] * proj[b]   (rank-1)

    where g_dots_raw is the cotangent of the *pre-sign* dot products
    (equal to multiplier * sign, objective.cu:354-403).
    """
    k_plus_1 = entity_ids.shape[1]
    acc_dtype = (
        jnp.float32
        if entity_pre.dtype == jnp.bfloat16
        else entity_pre.dtype
    )
    signs = jnp.concatenate(
        [jnp.ones((1,)), -jnp.ones((k_plus_1 - 1,))]
    ).astype(acc_dtype)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0

    def project(phrase_pre_, w_, b_):
        phrase = phrase_pre_
        if desc.l2_normalize_phrase_reprs:
            phrase = l2_normalize_rows(phrase)
        return apply_transform(
            phrase, w_, b_, desc, desc.batch_normalization
        )

    projections, project_vjp = jax.vjp(
        project, phrase_pre, params.transform_w, params.transform_b
    )

    # NCE dots: both operands at stream width; multiply + dtype-widening
    # sum rather than einsum-with-preferred-type so the f32 convert fuses
    # into the reduction instead of materializing an f32 copy of the
    # gathered entity stream.
    proj_s = projections.astype(entity_pre.dtype)
    dots_raw = jnp.sum(
        proj_s[:, None, :] * entity_pre, axis=-1, dtype=acc_dtype
    )

    def tail(dots_raw_):
        dots = dots_raw_ * signs[None, :]
        log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
        cost = -jnp.sum(nce_w * log_probs) / batch_size_normalizer
        return cost, truncated_sigmoid(dots, eps_f)

    (cost, tail_vjp, similarity_probs) = jax.vjp(tail, dots_raw, has_aux=True)
    (g_dots_raw,) = tail_vjp(jnp.ones((), cost.dtype))

    # Transposed dot, again with both operands at stream width and the
    # widening convert fused into the reduction.
    g_projections = jnp.sum(
        g_dots_raw.astype(entity_pre.dtype)[:, :, None] * entity_pre,
        axis=1,
        dtype=acc_dtype,
    ).astype(projections.dtype)
    g_phrase, g_w, g_b = project_vjp(g_projections)

    ascent = AscentGrads(
        word=(
            SparseGrad(
                grad=-g_phrase / window,
                indices=batch.features,
                weights=feature_weights,
            ),
        ),
        entity=(
            SparseGrad(
                grad=projections,
                indices=entity_ids,
                weights=-g_dots_raw,
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent


def sample_shared_negative_entities(
    key: jax.Array, num_entities: int, num_negative: int
) -> jax.Array:
    """One batch-shared pool of k uniform negative entity ids.

    GEMM-shaped variant of per-instance sampling (labels.cu:3-22): every
    instance in the batch scores against the *same* k negatives, which turns
    the NCE negative dots and the negative entity gradients into dense
    [B, k] x [k, d] GEMMs and shrinks the negative side of the
    sparse update from B*k scattered rows to k dense rows.  The per-example
    loss has the identical form (1 positive + k uniform negatives with the
    same bias correction); only the cross-instance correlation of the
    negative draws differs.  Quality parity is validated empirically
    (PERFORMANCE.md).
    """
    return jax.random.randint(key, (num_negative,), 0, num_entities, jnp.int32)


def text_entity_cost_and_grads_shared(
    params: ModelParams,
    batch: TextEntityBatch,
    neg_ids: jax.Array,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float | None = None,
    stream_dtype=None,
    uniform_feature_weights: bool = False,
    window_sum_dtype=None,
):
    """Cost + ascent gradients with batch-shared negatives.

    Same loss form as the reference objective (objective.cu:30-313) with the
    [pos, neg_1..neg_k] slots, but the k negatives are shared across the
    batch (see sample_shared_negative_entities).  The gradient math mirrors
    the factored path with the per-slot structure replaced by GEMMs:

      dots_raw[b, 0]   = <proj_b, pos_b>         (gathered labels rows)
      dots_raw[b, 1+n] = <proj_b, neg_n>         (one [B,d] @ [d,k] GEMM)
      d cost/d proj_b  = g0_b * pos_b + g_neg[b] @ negs
      d ascent/d pos_b = -g0_b * proj_b           (rank-1 sparse descriptor)
      d ascent/d neg_n = -sum_b g_neg[b,n] proj_b ([k,B] @ [B,d] GEMM, a
                         dense k-row descriptor)

    Unsupported here: entity L2 normalization (the per-row normalizer
    backward does not share the GEMM structure).
    """
    if desc.l2_normalize_entity_reprs:
        raise ValueError(
            "shared negatives do not support l2_normalize_entity_reprs"
        )
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    window = batch.features.shape[1]
    num_negative = neg_ids.shape[0]
    feature_weights = (
        None if uniform_feature_weights else batch.feature_weights
    )

    word_table = params.word_reprs
    entity_table = params.entity_reprs
    cast = (
        stream_dtype is not None
        and jnp.dtype(stream_dtype) != word_table.dtype
    )
    if cast:
        word_table = word_table.astype(stream_dtype)

    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Gather from the float32 master, cast only the B + k gathered rows
    # (see the pooled variant).
    pos = jnp.take(entity_table, batch.labels, axis=0, mode="clip")  # [B, d]
    negs = jnp.take(entity_table, neg_ids, axis=0, mode="clip")  # [k, d]
    if cast:
        pos = pos.astype(stream_dtype)
        negs = negs.astype(stream_dtype)
    nce_w = nce_instance_weights(batch.weights, num_negative, desc)

    acc_dtype = (
        jnp.float32 if pos.dtype == jnp.bfloat16 else pos.dtype
    )
    signs = jnp.concatenate(
        [jnp.ones((1,)), -jnp.ones((num_negative,))]
    ).astype(acc_dtype)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0

    def project(phrase_pre_, w_, b_):
        phrase = phrase_pre_
        if desc.l2_normalize_phrase_reprs:
            phrase = l2_normalize_rows(phrase)
        return apply_transform(
            phrase, w_, b_, desc, desc.batch_normalization
        )

    projections, project_vjp = jax.vjp(
        project, phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.astype(pos.dtype)

    pos_dots = jnp.sum(proj_s * pos, axis=-1, dtype=acc_dtype)  # [B]
    # GEMM with native mixed-precision accumulation.
    neg_dots = jax.lax.dot_general(
        proj_s, negs, (((1,), (1,)), ((), ())),
        preferred_element_type=acc_dtype,
    )  # [B, k]
    dots_raw = jnp.concatenate([pos_dots[:, None], neg_dots], axis=1)

    def tail(dots_raw_):
        dots = dots_raw_ * signs[None, :]
        log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
        cost = -jnp.sum(nce_w * log_probs) / batch_size_normalizer
        return cost, truncated_sigmoid(dots, eps_f)

    (cost, tail_vjp, similarity_probs) = jax.vjp(tail, dots_raw, has_aux=True)
    (g_dots_raw,) = tail_vjp(jnp.ones((), cost.dtype))
    g0 = g_dots_raw[:, 0]  # [B]
    g_neg = g_dots_raw[:, 1:].astype(pos.dtype)  # [B, k]

    g_projections = (
        g0.astype(acc_dtype)[:, None] * pos.astype(acc_dtype)
        + jax.lax.dot_general(
            g_neg, negs, (((1,), (0,)), ((), ())),
            preferred_element_type=acc_dtype,
        )
    ).astype(projections.dtype)
    g_phrase, g_w, g_b = project_vjp(g_projections)

    # Dense negative-rows gradient: [k, B] @ [B, d] GEMM.
    g_negs_rows = jax.lax.dot_general(
        g_neg, proj_s, (((0,), (0,)), ((), ())),
        preferred_element_type=acc_dtype,
    )  # [k, d]

    ascent = AscentGrads(
        word=(
            SparseGrad(
                grad=-g_phrase / window,
                indices=batch.features,
                weights=feature_weights,
            ),
        ),
        entity=(
            # Weight-free rank-1 label rows (see the pooled variant).
            SparseGrad(
                grad=-g_dots_raw[:, :1] * projections.astype(acc_dtype),
                indices=batch.labels[:, None],
                weights=None,
            ),
            SparseGrad(
                grad=-g_negs_rows.astype(acc_dtype),
                indices=neg_ids[:, None],
                weights=None,
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent


def sample_negative_pool(
    key: jax.Array, num_entities: int, pool_size: int
) -> jax.Array:
    """Per-step pool of uniform negative ids for the rolled-pool scheme."""
    return jax.random.randint(key, (pool_size,), 0, num_entities, jnp.int32)


def rolled_pool_negative_ids(
    pool_ids: jax.Array, batch_size: int, num_negative: int, stride: int = 1
) -> jax.Array:
    """The per-instance negative ids the rolled-pool scheme assigns:
    instance b has residue r = b // (B/P) and uses pool slots
    (r + j*stride) % P for j in [0, k).

    The residue is the *contiguous-block* index (b // Q with Q = B/P), not
    b % P: blocks keep the batch axis contiguous per residue, so under a
    data-sharded mesh the residue-major view [P, Q, d] is a plain reshape
    whose leading axis GSPMD shards cleanly — no projections all-gather
    (round 4; tests/test_sharding.py asserts it).  The instance order is
    already a global per-epoch shuffle, so which instances share a slot
    window is statistically identical either way; every instance still
    scores k distinct iid-uniform pool slots."""
    P = pool_ids.shape[0]
    q = batch_size // P
    if q == 0 or batch_size % P:
        raise ValueError(
            f"batch size {batch_size} must be a positive multiple of the "
            f"pool size {P}"
        )
    r = jnp.arange(batch_size, dtype=jnp.int32) // q
    slots = (
        r[:, None]
        + stride * jnp.arange(num_negative, dtype=jnp.int32)[None, :]
    ) % P
    return pool_ids[slots]


def text_entity_cost_and_grads_pooled(
    params: ModelParams,
    batch: TextEntityBatch,
    pool_ids: jax.Array,
    num_negative: int,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float | None = None,
    stream_dtype=None,
    uniform_feature_weights: bool = False,
    window_sum_dtype=None,
    pool_stride: int = 1,
):
    """Cost + ascent gradients with rolled-pool negatives.

    The middle ground between per-instance sampling (exact
    reference semantics, B*k scattered gradient rows) and fully-shared
    negatives (GEMM structure, but one pool for the whole batch): a pool of
    P uniform negative ids is drawn per step and instance b (residue
    r = b // Q, Q = B/P) scores against the k *cyclically-shifted* pool
    slots (r + j*stride) % P.  Every instance keeps the reference's
    per-example loss form — exactly k uniform negatives with the same bias
    correction (objective.cu:258-290) — while per step P distinct
    documents receive negative updates and all heavy ops stay dense:

      * negative dots: one [P]-batched (Q x d) @ (d x k) GEMM over the
        residue-major view proj.reshape(P, Q, d) — a FREE contiguous
        reshape (residues are contiguous blocks of the batch axis, see
        rolled_pool_negative_ids), so under a data-sharded mesh the
        batched GEMM shards over residues with no projections all-gather
        (round 4) — and the pool windows pool_windows[P, k, d] (window
        r = pool rows (r + j*stride) % P);
      * negative-row gradients: the transposed batched GEMM into
        window-gradient form [P, k, d], folded back onto pool rows with k
        rolls: pool_grad[p] = sum_j window_grads[(p - j*stride) % P, j];
      * the entity-side sparse update is B label rows (rank-1 descriptor)
        plus P dense pool rows.

    Requires batch_size % P == 0 and P >= k; entity L2 normalization is
    unsupported (as in the shared mode).
    """
    if desc.l2_normalize_entity_reprs:
        raise ValueError(
            "pooled negatives do not support l2_normalize_entity_reprs"
        )
    B = batch.features.shape[0]
    P = pool_ids.shape[0]
    if B % P != 0:
        raise ValueError(f"batch size {B} not divisible by pool size {P}")
    if P < num_negative:
        raise ValueError(f"pool size {P} < num negatives {num_negative}")
    Q = B // P
    k = num_negative
    S = pool_stride
    if len({(j * S) % P for j in range(k)}) != k:
        raise ValueError(
            f"pool stride {S} does not give {k} distinct slots mod {P}"
        )
    if batch_size_normalizer is None:
        batch_size_normalizer = B
    window = batch.features.shape[1]
    feature_weights = (
        None if uniform_feature_weights else batch.feature_weights
    )

    word_table = params.word_reprs
    entity_table = params.entity_reprs
    cast = (
        stream_dtype is not None
        and jnp.dtype(stream_dtype) != word_table.dtype
    )
    if cast:
        word_table = word_table.astype(stream_dtype)

    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Gather from the float32 master and cast only the gathered rows: the
    # pooled mode reads just B + P entity rows, so a full-table bf16 copy
    # (the right choice when B*(k+1) rows are gathered) would convert 5x
    # more bytes than are ever read.
    pos = jnp.take(entity_table, batch.labels, axis=0, mode="clip")  # [B, d]
    pool = jnp.take(entity_table, pool_ids, axis=0, mode="clip")  # [P, d]
    if cast:
        pos = pos.astype(stream_dtype)
        pool = pool.astype(stream_dtype)
    # Window r holds pool rows (r + j*stride) % P for j in [0, k): a tiny
    # [P*k]-row gather from the pool.
    win_slots = (
        jnp.arange(P, dtype=jnp.int32)[:, None]
        + S * jnp.arange(k, dtype=jnp.int32)[None, :]
    ) % P
    pool_windows = jnp.take(pool, win_slots, axis=0, mode="clip")  # [P, k, d]
    nce_w = nce_instance_weights(batch.weights, k, desc)

    acc_dtype = jnp.float32 if pos.dtype == jnp.bfloat16 else pos.dtype
    signs = jnp.concatenate(
        [jnp.ones((1,)), -jnp.ones((k,))]
    ).astype(acc_dtype)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0

    def project(phrase_pre_, w_, b_):
        phrase = phrase_pre_
        if desc.l2_normalize_phrase_reprs:
            phrase = l2_normalize_rows(phrase)
        return apply_transform(
            phrase, w_, b_, desc, desc.batch_normalization
        )

    projections, project_vjp = jax.vjp(
        project, phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.astype(pos.dtype)
    # Residue-major view: residue r owns rows [r*Q, (r+1)*Q) — a free
    # contiguous reshape (no transpose, and the leading axis is the
    # sharded batch axis under a mesh).
    proj_r = proj_s.reshape(P, Q, -1)

    pos_dots = jnp.sum(proj_s * pos, axis=-1, dtype=acc_dtype)  # [B]
    # [P]-batched GEMM: [Q, d] @ [d, k] per residue.
    neg_dots = jax.lax.dot_general(
        proj_r,  # [P, Q, d]
        pool_windows,  # [P, k, d]
        (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=acc_dtype,
    )  # [P, Q, k]
    neg_dots = neg_dots.reshape(B, k)
    dots_raw = jnp.concatenate([pos_dots[:, None], neg_dots], axis=1)

    def tail(dots_raw_):
        dots = dots_raw_ * signs[None, :]
        log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
        cost = -jnp.sum(nce_w * log_probs) / batch_size_normalizer
        return cost, truncated_sigmoid(dots, eps_f)

    (cost, tail_vjp, similarity_probs) = jax.vjp(tail, dots_raw, has_aux=True)
    (g_dots_raw,) = tail_vjp(jnp.ones((), cost.dtype))
    g0 = g_dots_raw[:, 0]  # [B]
    g_neg = g_dots_raw[:, 1:].astype(pos.dtype)  # [B, k]
    g_neg_r = g_neg.reshape(P, Q, k)  # free reshape, batch axis leading

    # d cost / d proj: batched [Q, k] @ [k, d] against the pool windows.
    g_proj_neg = jax.lax.dot_general(
        g_neg_r, pool_windows,
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=acc_dtype,
    )  # [P, Q, d]
    g_projections = (
        g0.astype(acc_dtype)[:, None] * pos.astype(acc_dtype)
        + g_proj_neg.reshape(B, -1)
    ).astype(projections.dtype)
    g_phrase, g_w, g_b = project_vjp(g_projections)

    # Window-gradient form, then fold windows back onto pool rows:
    # pool_grad[p] = sum_j window_grads[(p - j*stride) % P, j].
    window_grads = jax.lax.dot_general(
        g_neg_r,  # [P, Q, k] — contract Q
        proj_r,  # [P, Q, d]
        (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=acc_dtype,
    )  # [P, k, d]
    pool_grad = window_grads[:, 0, :]
    for j in range(1, k):
        pool_grad = pool_grad + jnp.roll(window_grads[:, j, :], j * S, axis=0)

    ascent = AscentGrads(
        word=(
            SparseGrad(
                grad=-g_phrase / window,
                indices=batch.features,
                weights=feature_weights,
            ),
        ),
        entity=(
            # Rank-1 label rows with the multiplier folded into the grad
            # (window 1, so w*g folds exactly): every entity descriptor is
            # then weight-free and the accumulation sort drops its third
            # operand (optim/updates.py).
            SparseGrad(
                grad=-g_dots_raw[:, :1] * projections.astype(acc_dtype),
                indices=batch.labels[:, None],
                weights=None,
            ),
            SparseGrad(
                grad=-pool_grad.astype(acc_dtype),
                indices=pool_ids[:, None],
                weights=None,
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent


def similarity_loss(
    gathered: jax.Array,
    weights: jax.Array,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float,
):
    """Representation-similarity loss (objective.cu:487-575).

    gathered: [B, 2, d] representation pairs; cost =
    -(sum_i weights[i] * log trunc_sigmoid(<r_i1, r_i2>)) / B.
    """
    dots = jnp.sum(gathered[:, 0, :] * gathered[:, 1, :], axis=-1)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0
    log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
    similarity_probs = truncated_sigmoid(dots, eps_f)
    cost = -jnp.sum(weights * log_probs) / batch_size_normalizer
    return cost, similarity_probs


def similarity_cost_and_grads(
    table: jax.Array,
    batch: SimilarityBatch,
    desc: ModelDesc,
    batch_size_normalizer: jax.Array | float | None = None,
):
    """Cost + sparse ascent gradient for one representations table.

    The gradient of each representation is the *other* member of the pair
    scaled by the multiplier (flip_adjacent_columns, objective.cu:641-661) —
    produced here by autodiff.
    """
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.ids.shape[0]
    gathered = jnp.take(table, batch.ids, axis=0)  # [B, 2, d]

    def loss_fn(g):
        return similarity_loss(g, batch.weights, desc, batch_size_normalizer)

    (cost, similarity_probs), g = jax.value_and_grad(loss_fn, has_aux=True)(
        gathered
    )
    desc_grad = SparseGrad(
        grad=-g.reshape(-1, table.shape[1]),
        indices=batch.ids.reshape(-1, 1),
        weights=None,
    )
    return cost, similarity_probs, desc_grad


def scale_sparse(g: SparseGrad, scale: float) -> SparseGrad:
    return g._replace(grad=g.grad * scale)


def merge_ascent_grads(
    grads_and_weights: Tuple[Tuple[AscentGrads, float], ...]
) -> AscentGrads:
    """Weighted merge of constituent gradients (MergeGradientsFn,
    intermediate_results.cu:3-60): every gradient is scaled by
    weight / sum(weights); dense transform gradients are summed; sparse
    representation descriptors are concatenated.
    """
    total = sum(w for _, w in grads_and_weights)
    word: list = []
    entity: list = []
    t_w = None
    t_b = None
    for g, w in grads_and_weights:
        s = w / total
        word.extend(scale_sparse(sg, s) for sg in g.word)
        entity.extend(scale_sparse(sg, s) for sg in g.entity)
        if g.transform_w is not None:
            t_w = g.transform_w * s if t_w is None else t_w + g.transform_w * s
        if g.transform_b is not None:
            t_b = g.transform_b * s if t_b is None else t_b + g.transform_b * s
    return AscentGrads(
        word=tuple(word), entity=tuple(entity), transform_w=t_w, transform_b=t_b
    )


def infer(
    params: ModelParams,
    features: jax.Array,
    desc: ModelDesc,
    feature_weights: Optional[jax.Array] = None,
) -> jax.Array:
    """Project word windows into entity space (Model::infer, model.cu:105-133).

    Batch normalization is *never* applied at inference (the reference passes
    nullptr); the configured nonlinearity is.
    """
    if feature_weights is None:
        feature_weights = jnp.ones(features.shape, params.word_reprs.dtype)
    phrase = gather_phrase_reprs(params.word_reprs, features, feature_weights)
    if desc.l2_normalize_phrase_reprs:
        phrase = l2_normalize_rows(phrase)
    return apply_transform(
        phrase, params.transform_w, params.transform_b, desc,
        batch_normalization=False,
    )
