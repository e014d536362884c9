"""Optimizers with the reference's exact update semantics.

Replaces updates.cu / updates_adagrad.cu / updates_adam.cu.  The update rules
are *not* textbook — the notable quirks, all reproduced deliberately:

* The reference performs gradient **ascent**: ``param += lr * grad`` where
  grad is d(log-likelihood)/d(theta) (model.cu:187-220).  All gradients
  flowing in here are "ascent gradients" (see models/objectives.py).
* L2 regularization folds into a multiplicative decay applied to the whole
  tensor before the (possibly sparse) addition:
  ``param = param * (1 - lambda_scaled * lr) + lr * update``
  (storage.cu:65-67, storage_inl.h:8-32); the bias is never regularized
  (updates.h:39-62, storage.cu:222-227).
* Adam adds epsilon *outside* the square root: ``m_hat / (sqrt(v) + eps)``
  for the representation paths (updates_adam.cu:150,306-307) and transform
  (updates_adam.cu:37-43: divide by ``sqrt(v) + eps``).  Adagrad divides by
  ``sqrt(acc + eps)`` — epsilon *inside* (updates_adagrad.cu:21-31,96).
* Sparse Adagrad keeps ONE scalar accumulator per object, fed with the
  dimension-averaged squared gradient, and reads it back averaged over the
  window (updates_adagrad.cu:72-97,132-158).
* Sparse Adam (SPARSE / DENSE_UPDATE modes) keeps a full-size first moment
  and a scalar-per-object second moment; both decay **globally** every step
  (the m/v "storages" are updated through the same decay-fold path,
  updates_adam.cu:196-252) while only touched rows receive additions.
* DENSE_UPDATE_DENSE_VARIANCE ("full_adam", the canonical NVSM config,
  functions.sh:369-400) keeps dense m and v, folds the L2 term into the
  moments (updates_adam.cu:203-213,253-282), and applies a dense update with
  no extra decay (updates_adam.cu:312-328).

Scatter-adds use ``Array.at[].add``; duplicate indices accumulate exactly
like the reference's atomicAdd (storage.cu:37-49).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.config import AdamMode, TrainConfig, UpdateMethod
from cunvsm.models.objectives import AscentGrads, SparseGrad
from cunvsm.models.params import ModelParams


# ---------------------------------------------------------------------------
# Optimizer state pytrees.
# ---------------------------------------------------------------------------


class SGDState(NamedTuple):
    pass


class TransformAdagradState(NamedTuple):
    acc_w: jax.Array
    acc_b: jax.Array


class TransformAdamState(NamedTuple):
    m_w: jax.Array
    m_b: jax.Array
    v_w: jax.Array
    v_b: jax.Array
    t: jax.Array  # scalar int32, starts at 1 (updates.h:197, t_=1)


class ReprAdagradState(NamedTuple):
    acc: jax.Array  # [num_objects] scalar accumulator per object


class ReprAdamState(NamedTuple):
    m: jax.Array  # [num_objects, dim]
    v: jax.Array  # [num_objects] (SPARSE/DENSE_UPDATE) or [num_objects, dim]
    t: jax.Array


TransformState = Union[SGDState, TransformAdagradState, TransformAdamState]
ReprState = Union[SGDState, ReprAdagradState, ReprAdamState]


class OptState(NamedTuple):
    word: ReprState
    entity: ReprState
    transform: TransformState


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------


def _scatter_updates(desc: SparseGrad) -> Tuple[jax.Array, jax.Array]:
    """Flatten a sparse descriptor into (flat_indices, flat_updates).

    flat_updates[i*W + w] = weights[i, w] * grad[i]  (update_repr_kernel,
    storage.cu:37-49).
    """
    num_instances, window = desc.indices.shape
    dim = desc.grad.shape[1]
    upd = jnp.broadcast_to(
        desc.grad[:, None, :], (num_instances, window, dim)
    )
    if desc.weights is not None:
        upd = upd * desc.weights[:, :, None].astype(upd.dtype)
    return desc.indices.reshape(-1), upd.reshape(-1, dim)


def _scatter_add(table: jax.Array, desc: SparseGrad, scale) -> jax.Array:
    idx, upd = _scatter_updates(desc)
    return table.at[idx].add(scale * upd)


def _data_sharded_accumulate(
    num_rows: int,
    descs: Tuple[SparseGrad, ...],
    mesh,
    stream_dtype=None,
    accum_dtype=None,
    reduce_dtype=None,
) -> jax.Array:
    """Data-parallel dense accumulation for a *replicated* table under a
    device mesh.

    The instance dimension shards over EVERY mesh axis (data and model
    together): the destination table is replicated, so splitting the
    update stream 8 ways on an 8-chip mesh is free resharding, while
    leaving the model axis out would make the chips of one data group
    redo identical sort/scatter work.

    The single-chip accumulation sorts the flat update stream, and GSPMD
    cannot partition a global sort: it replicates the whole stream with a
    masked all-reduce — B*W*d bytes of interconnect per step (614 MB at the
    canonical word shapes), the exact "sharded embedding gather/scatter"
    hazard SURVEY §7 flags.  This wrapper shard_maps the accumulation over
    ALL mesh axes instead: every chip reduces its *local* slice of the
    stream into a local dense [num_rows, dim] partial (sorted scatter or
    prefix-diff, unchanged math) and one psum of the table-sized partial
    crosses the interconnect — V*d bytes (78 MB at canonical shapes), the
    same volume as the data-parallel word-gradient sync itself.  Requires
    the instance count divisible by the TOTAL device count.  Summation is exact:
    only the order of partial sums changes.  Asserted on the compiled HLO
    in tests/test_sharding.py.

    ``reduce_dtype`` (e.g. "bfloat16") narrows ONLY the cross-chip psum:
    each chip's local partial still accumulates at full width; the
    N_dev-way sum of partials runs at stream width, halving the largest
    per-step collective (the [V, d_w] all-reduce, PERFORMANCE.md comm
    table).  Sound when the stream entries are bf16-quantized anyway
    (stream_dtype bfloat16): the extra rounding is one bf16 quantization
    of values that are themselves sums of bf16-quantized terms."""
    from functools import partial

    from jax import shard_map

    n_devices = int(np.prod(list(mesh.shape.values())))
    for d in descs:
        if d.indices.shape[0] % n_devices:
            raise ValueError(
                f"data-sharded accumulation: instance count "
                f"{d.indices.shape[0]} not divisible by the total device "
                f"count {n_devices} (mesh {dict(mesh.shape)}); pick a batch "
                f"size divisible by data*model"
            )

    grads = tuple(d.grad for d in descs)
    indices = tuple(d.indices for d in descs)
    weights = tuple(d.weights for d in descs)

    axes = tuple(mesh.axis_names)
    spec = jax.sharding.PartitionSpec(axes, None)
    # None weights are empty pytrees; the per-leaf spec simply never
    # applies to them.
    specs = (
        tuple(spec for _ in grads),
        tuple(spec for _ in indices),
        tuple(spec for _ in weights),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=specs,
        out_specs=jax.sharding.PartitionSpec(),
        check_vma=False,
    )
    def acc(grads_, indices_, weights_):
        local = tuple(
            SparseGrad(g, i, w)
            for g, i, w in zip(grads_, indices_, weights_)
        )
        dense = _sorted_segment_accumulate(
            num_rows, local, stream_dtype, accum_dtype
        )
        if reduce_dtype is not None:
            out_dtype = dense.dtype
            return jax.lax.psum(
                dense.astype(reduce_dtype), axes
            ).astype(out_dtype)
        return jax.lax.psum(dense, axes)

    return acc(grads, indices, weights)


def _sorted_segment_accumulate(
    num_rows: int,
    descs: Tuple[SparseGrad, ...],
    stream_dtype=None,
    accum_dtype=None,
) -> jax.Array:
    """Dense accumulation of sparse descriptors: S[v] = sum over (i, w) with
    indices[i, w] == v of weights[i, w] * grad[i].

    Sorting the flat indices first lets XLA use its sorted-scatter path
    instead of the unsorted scatter the reference's atomicAdd semantics
    would naively map to (PERF.md "Kernels on the H100" compares the two).
    Duplicate indices still accumulate exactly.

    The sort makes ~log n passes over every operand, so the layouts
    minimize operand count:

    * weight-free single descriptor with row ids and instance ids that both
      fit 16 bits (the canonical word table: vocab 65536, batch 51200 under
      uniform feature weighting) — ONE packed uint32 operand
      ``(row_id << 16) | instance_id``; unpacking is two cheap vector ops.
    * weight-free otherwise — two operands (row_id, instance_id).
    * weighted single descriptor — by default three operands
      (row_id, instance_id, weight); ``CUNVSM_ACCUM_VARIANT=twoop`` sorts
      (row_id, flat_position) and re-derives the instance id arithmetically
      + the weight through a post-sort element gather.

    The per-instance gradient rows are gathered *after* the sort: the
    gradient array ([instances, dim]) is window-times smaller than the
    materialized update matrix, so the random access happens on a much
    smaller working set.
    """
    import os

    from cunvsm.ops.prefix_diff import (
        prefix_diff_applicable,
        prefix_diff_segment_sum,
    )
    from cunvsm.ops.segment_kernels import sorted_segment_sum

    variant = os.environ.get("CUNVSM_ACCUM_VARIANT", "auto")

    def _finish(grads, idx_s, ptr_s, wts_s):
        out_dtype = accum_dtype or grads.dtype
        if (
            stream_dtype is not None
            and jnp.dtype(stream_dtype) != grads.dtype
        ):
            # Mixed-precision stream: the permuted gather moves half the
            # bytes.  When the accumulator stays float32, XLA may
            # materialize a full-width update stream for the up-convert.
            # accum_dtype="bfloat16" keeps the scatter itself at stream
            # width (the consumer up-converts), at the cost of
            # half-precision partial sums.
            grads = grads.astype(stream_dtype)
        upd_s = jnp.take(grads, ptr_s, axis=0, mode="clip")
        if wts_s is not None:
            upd_s = upd_s * wts_s[:, None].astype(grads.dtype)
        if upd_s.dtype != out_dtype:
            upd_s = upd_s.astype(out_dtype)
        return sorted_segment_sum(upd_s, idx_s, num_rows)

    if len(descs) == 1:
        d = descs[0]
        n_inst, window = d.indices.shape
        if prefix_diff_applicable(
            n_inst, window, num_rows, d.weights, accum_dtype
        ):
            # Scatter-free accumulation (opt-in): two packed sorts + a
            # matmul prefix reduction (ops/prefix_diff.py).
            return prefix_diff_segment_sum(
                d.grad, d.indices, num_rows, stream_dtype=stream_dtype
            )
        idx = d.indices.reshape(-1)
        if d.weights is None:
            if n_inst <= (1 << 16) and num_rows <= (1 << 16):
                # Packed single-operand sort.  Row id in the high bits keeps
                # the ordering; unsigned compare keeps ids >= 2^15 in order.
                ptr = jnp.arange(
                    n_inst * window, dtype=jnp.uint32
                ) // jnp.uint32(window)
                key = (idx.astype(jnp.uint32) << 16) | ptr
                (key_s,) = jax.lax.sort((key,), num_keys=1)
                idx_s = jax.lax.shift_right_logical(
                    key_s, jnp.uint32(16)
                ).astype(jnp.int32)
                ptr_s = (key_s & jnp.uint32(0xFFFF)).astype(jnp.int32)
                return _finish(d.grad, idx_s, ptr_s, None)
            ptr = jnp.repeat(
                jnp.arange(n_inst, dtype=jnp.int32), window
            )
            idx_s, ptr_s = jax.lax.sort((idx, ptr), num_keys=1)
            return _finish(d.grad, idx_s, ptr_s, None)
        if variant == "twoop":
            pos = jnp.arange(n_inst * window, dtype=jnp.int32)
            idx_s, pos_s = jax.lax.sort((idx, pos), num_keys=1)
            ptr_s = pos_s // window
            wts = d.weights.reshape(-1)
            if (
                stream_dtype is not None
                and jnp.dtype(stream_dtype) != wts.dtype
            ):
                wts = wts.astype(stream_dtype)
            wts_s = jnp.take(wts, pos_s, mode="clip")
            return _finish(d.grad, idx_s, ptr_s, wts_s)

    idx_parts = []
    ptr_parts = []
    w_parts = []
    offset = 0
    all_weightless = all(d.weights is None for d in descs)
    for d in descs:
        n_inst, window = d.indices.shape
        idx_parts.append(d.indices.reshape(-1))
        ptr = jnp.repeat(
            jnp.arange(offset, offset + n_inst, dtype=jnp.int32), window
        )
        ptr_parts.append(ptr)
        if not all_weightless:
            if d.weights is not None:
                w_parts.append(d.weights.reshape(-1))
            else:
                w_parts.append(jnp.ones(n_inst * window, d.grad.dtype))
        offset += n_inst
    grads = (
        jnp.concatenate([d.grad for d in descs])
        if len(descs) > 1
        else descs[0].grad
    )
    idx = jnp.concatenate(idx_parts) if len(descs) > 1 else idx_parts[0]
    ptr = jnp.concatenate(ptr_parts) if len(descs) > 1 else ptr_parts[0]
    if all_weightless:
        # Every descriptor weight-free (the pooled/shared entity layouts
        # fold their rank-1 multipliers into the gradients): two-operand
        # sort, no weights stream.
        idx_s, ptr_s = jax.lax.sort((idx, ptr), num_keys=1)
        return _finish(grads, idx_s, ptr_s, None)
    wts = jnp.concatenate(w_parts) if len(descs) > 1 else w_parts[0]
    if stream_dtype is not None and jnp.dtype(stream_dtype) != wts.dtype:
        wts = wts.astype(stream_dtype)

    # One fused multi-operand sort instead of argsort + takes.
    idx_s, ptr_s, wts_s = jax.lax.sort((idx, ptr, wts), num_keys=1)
    return _finish(grads, idx_s, ptr_s, wts_s)


def _scatter_add_scalar(
    vec: jax.Array, desc: SparseGrad, values: jax.Array, scale
) -> jax.Array:
    """Scatter per-instance scalars into a per-object vector.

    vec[idx[i, w]] += scale * weights[i, w] * values[i].
    """
    num_instances, window = desc.indices.shape
    upd = jnp.broadcast_to(values[:, None], (num_instances, window))
    if desc.weights is not None:
        upd = upd * desc.weights.astype(upd.dtype)
    return vec.at[desc.indices.reshape(-1)].add(scale * upd.reshape(-1))


def _window_mean_gather(table: jax.Array, indices: jax.Array) -> jax.Array:
    """mean over the window of table rows: out[i] = mean_w table[idx[i, w]]."""
    return jnp.mean(jnp.take(table, indices, axis=0), axis=1)


def _adam_bias_correction(beta1, beta2, t, dtype):
    # sqrt(1 - beta2^t) / (1 - beta1^t)  (updates_adam.cu:91,285).
    tf = t.astype(dtype)
    b1 = jnp.asarray(beta1, dtype)
    b2 = jnp.asarray(beta2, dtype)
    return jnp.sqrt(1.0 - jnp.power(b2, tf)) / (1.0 - jnp.power(b1, tf))


# ---------------------------------------------------------------------------
# Transform (dense W + bias) updates.
# ---------------------------------------------------------------------------


def _transform_sgd(w, b, g_w, g_b, lr, lam):
    # storage.cu:200-228 via storage_inl.h: decay-fold on W only.
    w = w * (1.0 - lam * lr) + lr * g_w
    b = b + lr * g_b
    return w, b


def _transform_adagrad(state, w, b, g_w, g_b, lr, lam, eps):
    # updates_adagrad.cu:33-70.
    acc_w = state.acc_w + jnp.square(g_w)
    acc_b = state.acc_b + jnp.square(g_b)
    g_w = g_w / jnp.sqrt(acc_w + eps)
    g_b = g_b / jnp.sqrt(acc_b + eps)
    w, b = _transform_sgd(w, b, g_w, g_b, lr, lam)
    return TransformAdagradState(acc_w, acc_b), w, b


def _transform_adam(state, w, b, g_w, g_b, lr, lam, beta1, beta2, eps):
    # updates_adam.cu:46-105: regularize grad (W only), update moments,
    # bias-corrected step with no decay fold.
    g_w = g_w - lam * w
    m_w = beta1 * state.m_w + (1.0 - beta1) * g_w
    m_b = beta1 * state.m_b + (1.0 - beta1) * g_b
    v_w = beta2 * state.v_w + (1.0 - beta2) * jnp.square(g_w)
    v_b = beta2 * state.v_b + (1.0 - beta2) * jnp.square(g_b)
    bc = _adam_bias_correction(beta1, beta2, state.t, w.dtype)
    w = w + lr * bc * m_w / (jnp.sqrt(v_w) + eps)
    b = b + lr * bc * m_b / (jnp.sqrt(v_b) + eps)
    return TransformAdamState(m_w, m_b, v_w, v_b, state.t + 1), w, b


# ---------------------------------------------------------------------------
# Representations (sparse embedding-table) updates.
# ---------------------------------------------------------------------------


def _repr_sgd(table, descs, lr, lam):
    # RepresentationsStorage::update (storage.cu:51-102): one decay fold,
    # then scatter-add every descriptor.
    table = table * (1.0 - lam * lr)
    for desc in descs:
        table = _scatter_add(table, desc, lr)
    return table


def _repr_adagrad(state, table, descs, lr, lam, eps):
    # updates_adagrad.cu:99-179.  Single-descriptor only, like the reference
    # (CHECK_EQ at updates_adagrad.cu:108).
    assert len(descs) == 1, "Adagrad does not implement multiple gradients"
    desc = descs[0]
    msq = jnp.mean(jnp.square(desc.grad), axis=1)  # dim-averaged squared grad
    acc = _scatter_add_scalar(state.acc, desc, msq, 1.0)
    agg = _window_mean_gather(acc, desc.indices)  # [num_instances]
    scaled = desc._replace(
        grad=desc.grad / jnp.sqrt(agg + eps)[:, None]
    )
    table = _repr_sgd(table, (scaled,), lr, lam)
    return ReprAdagradState(acc), table


def _repr_adam_moments_sparse(state, descs, beta1, beta2):
    """m/v updates shared by SPARSE and DENSE_UPDATE modes
    (updates_adam.cu:195-252): global decay + sparse additions; v holds the
    dimension-averaged squared gradient per object."""
    m = beta1 * state.m
    v = beta2 * state.v
    for desc in descs:
        m = _scatter_add(m, desc, 1.0 - beta1)
        msq = jnp.mean(jnp.square(desc.grad), axis=1)
        v = _scatter_add_scalar(v, desc, msq, 1.0 - beta2)
    return m, v


def _repr_adam_sparse(state, table, descs, lr, lam, beta1, beta2, eps):
    # SPARSE mode (updates_adam.cu:332-384): statistics per object, update
    # averaged over the window via adam_sparse_update_kernel.
    assert len(descs) == 1, "Sparse Adam does not implement multiple gradients"
    desc = descs[0]
    m, v = _repr_adam_moments_sparse(state, descs, beta1, beta2)
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    agg_m = _window_mean_gather(m, desc.indices)  # [I, dim]
    agg_v = _window_mean_gather(v, desc.indices)  # [I]
    step = desc._replace(
        grad=bc * agg_m / (jnp.sqrt(agg_v)[:, None] + eps)
    )
    table = _repr_sgd(table, (step,), lr, lam)
    return ReprAdamState(m, v, state.t + 1), table


def _repr_adam_dense_update(state, table, descs, lr, lam, beta1, beta2, eps):
    # DENSE_UPDATE mode (updates_adam.cu:293-311): sparse moments, dense
    # parameter sweep with the scalar variance broadcast per row.
    m, v = _repr_adam_moments_sparse(state, descs, beta1, beta2)
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    update = bc * m / (jnp.sqrt(v)[:, None] + eps)
    table = table * (1.0 - lam * lr) + lr * update
    return ReprAdamState(m, v, state.t + 1), table


def _repr_adam_full(
    state, table, descs, lr, lam, beta1, beta2, eps, stream_dtype=None,
    accum_dtype=None, data_shard_mesh=None, reduce_dtype=None,
):
    # DENSE_UPDATE_DENSE_VARIANCE mode (updates_adam.cu:203-213,253-282,
    # 312-328): dense m and v with L2 folded into the moments.  The m update
    # and the squared-gradient aggregate consume the *same* dense scatter, so
    # it is computed once (the reference scatters twice).  XLA emits the
    # dense sweep below as one multi-output loop fusion: 4R read + 3R write,
    # the reference's single elementwise pass (updates_adam.cu:133-151).
    if data_shard_mesh is not None:
        scattered = _data_sharded_accumulate(
            table.shape[0], tuple(descs), data_shard_mesh,
            stream_dtype, accum_dtype, reduce_dtype,
        )
    else:
        scattered = _sorted_segment_accumulate(
            table.shape[0], tuple(descs), stream_dtype, accum_dtype
        )
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    agg = scattered - lam * table
    m = beta1 * state.m + (1.0 - beta1) * agg
    v = beta2 * state.v + (1.0 - beta2) * jnp.square(agg)
    table = table + lr * bc * m / (jnp.sqrt(v) + eps)
    return ReprAdamState(m, v, state.t + 1), table


# ---------------------------------------------------------------------------
# Public optimizer facade.
# ---------------------------------------------------------------------------


class Optimizer:
    """Static dispatcher; all methods are pure and jit-compatible.

    Equivalent of the GradientUpdater hierarchy wired up in params.cu:45-62,
    341-358: the same update method applies to both representation tables and
    the transform.
    """

    def __init__(self, cfg: TrainConfig, data_shard_mesh=None):
        # data_shard_mesh: when training under a device mesh, the word
        # table's dense accumulation is shard_mapped over every mesh axis
        # (see _data_sharded_accumulate); the entity table stays under
        # GSPMD (it is model-sharded, not replicated).
        self.cfg = cfg
        self.data_shard_mesh = data_shard_mesh

    # -- init ---------------------------------------------------------------

    def init(self, params: ModelParams) -> OptState:
        method = self.cfg.update_method
        if method == UpdateMethod.SGD:
            return OptState(SGDState(), SGDState(), SGDState())
        if method == UpdateMethod.ADAGRAD:
            return OptState(
                word=ReprAdagradState(
                    jnp.zeros((params.num_words,), params.word_reprs.dtype)
                ),
                entity=ReprAdagradState(
                    jnp.zeros((params.num_entities,), params.entity_reprs.dtype)
                ),
                transform=TransformAdagradState(
                    jnp.zeros_like(params.transform_w),
                    jnp.zeros_like(params.transform_b),
                ),
            )
        if method == UpdateMethod.ADAM:
            dense_v = self.cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE

            def repr_state(table):
                v_shape = table.shape if dense_v else (table.shape[0],)
                return ReprAdamState(
                    m=jnp.zeros_like(table),
                    v=jnp.zeros(v_shape, table.dtype),
                    t=jnp.ones((), jnp.int32),
                )

            return OptState(
                word=repr_state(params.word_reprs),
                entity=repr_state(params.entity_reprs),
                transform=TransformAdamState(
                    m_w=jnp.zeros_like(params.transform_w),
                    m_b=jnp.zeros_like(params.transform_b),
                    v_w=jnp.zeros_like(params.transform_w),
                    v_b=jnp.zeros_like(params.transform_b),
                    t=jnp.ones((), jnp.int32),
                ),
            )
        raise ValueError(f"unknown update method {method}")

    # -- apply --------------------------------------------------------------

    def apply(
        self,
        params: ModelParams,
        opt_state: OptState,
        grads: AscentGrads,
        learning_rate: float,
        scaled_regularization_lambda,
    ) -> Tuple[ModelParams, OptState]:
        """One update step (Model::update, model.cu:187-220).

        ``scaled_regularization_lambda`` is lambda / batch_size
        (intermediate_results.cu:126-129).
        """
        cfg = self.cfg
        lr = learning_rate
        lam = scaled_regularization_lambda

        word, w_state = self._apply_repr(
            params.word_reprs, opt_state.word, grads.word, lr, lam,
            data_sharded=self.data_shard_mesh is not None,
        )
        entity, e_state = self._apply_repr(
            params.entity_reprs, opt_state.entity, grads.entity, lr, lam
        )

        t_w, t_b = params.transform_w, params.transform_b
        t_state = opt_state.transform
        if grads.transform_w is not None:
            if cfg.update_method == UpdateMethod.SGD:
                t_w, t_b = _transform_sgd(
                    t_w, t_b, grads.transform_w, grads.transform_b, lr, lam
                )
            elif cfg.update_method == UpdateMethod.ADAGRAD:
                t_state, t_w, t_b = _transform_adagrad(
                    t_state, t_w, t_b, grads.transform_w, grads.transform_b,
                    lr, lam, cfg.adagrad_epsilon,
                )
            else:
                t_state, t_w, t_b = _transform_adam(
                    t_state, t_w, t_b, grads.transform_w, grads.transform_b,
                    lr, lam, cfg.adam.beta1, cfg.adam.beta2, cfg.adam.epsilon,
                )

        return (
            ModelParams(word, entity, t_w, t_b),
            OptState(w_state, e_state, t_state),
        )

    def _apply_repr(self, table, state, descs, lr, lam,
                    data_sharded=False):
        if not descs:
            return table, state
        cfg = self.cfg
        if cfg.update_method == UpdateMethod.SGD:
            return _repr_sgd(table, descs, lr, lam), state
        if cfg.update_method == UpdateMethod.ADAGRAD:
            state, table = _repr_adagrad(
                state, table, descs, lr, lam, cfg.adagrad_epsilon
            )
            return table, state
        mode = cfg.adam.mode
        args = (state, table, descs, lr, lam,
                cfg.adam.beta1, cfg.adam.beta2, cfg.adam.epsilon)
        if mode == AdamMode.SPARSE:
            state, table = _repr_adam_sparse(*args)
        elif mode == AdamMode.DENSE_UPDATE:
            state, table = _repr_adam_dense_update(*args)
        elif mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE:
            state, table = _repr_adam_full(
                *args,
                stream_dtype=cfg.resolved_stream_dtype(),
                accum_dtype=cfg.resolved_accum_dtype(),
                data_shard_mesh=(
                    self.data_shard_mesh if data_sharded else None
                ),
                reduce_dtype=cfg.resolved_cross_chip_reduce_dtype(),
            )
        else:
            raise ValueError(f"unknown adam mode {mode}")
        return table, state
