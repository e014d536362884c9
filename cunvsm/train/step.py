"""Jit-compiled training steps for all five objective flavours.

The reference instantiates Model<ObjectiveT> for (model.cu:222-228):
  * TextEntity               — the NVSM/LSE loss (the default),
  * EntityEntity / TermTerm  — standalone representation-similarity,
  * TextEntityEntityEntity / TextEntityTermTerm — "Mix 'n Match" composites
    (objective.cu:698-795) that weight-merge the constituent gradients.

Here each flavour is a pure ``step(params, opt_state, batch, key) ->
(params, opt_state, cost)`` function, jit-compiled once with donated
params/opt-state buffers so updates happen in place in HBM.
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cunvsm.config import AdamMode, ModelDesc, TrainConfig, UpdateMethod
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams
from cunvsm.optim.updates import Optimizer, OptState


class ObjectiveKind(enum.Enum):
    TEXT_ENTITY = "text_entity"
    ENTITY_ENTITY = "entity_entity"
    TERM_TERM = "term_term"
    TEXT_ENTITY_ENTITY_ENTITY = "text_entity_entity_entity"
    TEXT_ENTITY_TERM_TERM = "text_entity_term_term"


def objective_kind_from_config(cfg: TrainConfig) -> ObjectiveKind:
    """Mixture-weight dispatch (main.cu:733-757)."""
    if cfg.entity_entity_weight != 0.0:
        assert cfg.term_term_weight == 0.0
        return ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY
    if cfg.term_term_weight != 0.0:
        return ObjectiveKind.TEXT_ENTITY_TERM_TERM
    return ObjectiveKind.TEXT_ENTITY


def _accumulate_only_optimizer(cfg: TrainConfig) -> bool:
    """True when the optimizer consumes entity descriptors only through
    dense accumulation (SGD scatter / full_adam segment-sum) — the factored
    rank-1 entity-gradient layout is exact there; the window-averaged
    statistics of Adagrad and sparse/dense-update Adam need the expanded
    per-update layout."""
    if cfg.update_method == UpdateMethod.SGD:
        return True
    return (
        cfg.update_method == UpdateMethod.ADAM
        and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE
    )


_AUTO_POOL_CANDIDATES = (2048, 1024, 512, 256, 128, 64)
# Auto-resolution is scale-aware: the rolled pool is selected only when it
# covers at most this fraction of the entity collection.  Measured quality
# at three collection scales (PERFORMANCE.md): at ~3% coverage (P=2048,
# 64k docs) pooled BEATS per-instance (+0.0097 MAP, t=+11.0), at 12.5%
# coverage (P=2048, 16k docs, 5+5 seeds) it still wins (+0.0030, t=+3.4),
# as it does at ~20% coverage (P=12800 on 64k: +0.0034, t=+3.2); at
# >=100% coverage (P=2048, 1398-doc Cranfield) it loses a small but real
# -0.0044 (t~2.2).  The crossover therefore sits between 20% and 100%
# coverage; 0.25 keeps every measured winning regime pooled and resolves
# small collections to the reference-exact per-instance path (shrinking
# the pool instead measurably hurts at small scale — P=1024 gives up
# ~0.5% on Cranfield).
_AUTO_POOL_MAX_COVERAGE = 0.25


def resolve_negative_sampling(cfg: TrainConfig, desc: ModelDesc,
                              batch_size: int,
                              num_entities: Optional[int] = None):
    """Resolve (pool_size, pool_stride) for a concrete batch size.

    ``negative_pool_size=-1`` (the default) selects the rolled-pool layout
    automatically — the largest candidate pool dividing
    the batch — whenever the mode's requirements hold (accumulate-only
    optimizer, no entity L2 normalization, no shared negatives) AND, when
    ``num_entities`` (the real entity-collection size) is known, the pool
    covers at most ``_AUTO_POOL_MAX_COVERAGE`` of the collection; the
    per-example loss is exactly the reference's either way, so the auto
    choice only changes the execution layout and the cross-instance
    correlation of the draws (quality table in PERFORMANCE.md).  Returns
    (0, 1) for per-instance sampling."""
    k = cfg.num_random_entities
    p = cfg.negative_pool_size
    if cfg.reference_rng:
        # Reference-RNG replay feeds host-drawn per-instance negatives;
        # pooled/shared layouts sample differently by construction.
        if cfg.shared_negatives or p > 0:
            raise ValueError(
                "reference_rng requires per-instance negative sampling "
                "(negative_pool_size 0 or -1, no shared_negatives)"
            )
        return 0, 1
    if p == -1:
        if (
            cfg.shared_negatives
            or not _accumulate_only_optimizer(cfg)
            or desc.l2_normalize_entity_reprs
        ):
            return 0, 1
        p = next(
            (c for c in _AUTO_POOL_CANDIDATES
             if batch_size % c == 0 and c >= k),
            0,
        )
        if (
            p
            and num_entities is not None
            and p > _AUTO_POOL_MAX_COVERAGE * num_entities
        ):
            return 0, 1
    if p <= 0:
        return 0, 1
    # Validate the explicit pool configuration up front: the stride search
    # below can never produce k distinct residues mod p when p < k (it
    # would spin forever), and the pooled objective itself requires the
    # batch divisible by the pool — surface both as clear errors here at
    # step-build time instead of deep inside the traced objective.
    if p < k:
        raise ValueError(
            f"negative_pool_size {p} < num_random_entities {k}: the pool "
            "must hold at least one slot per negative"
        )
    if batch_size % p != 0:
        raise ValueError(
            f"batch size {batch_size} not divisible by negative_pool_size {p}"
        )
    s = cfg.negative_pool_stride
    if s == 0:
        # About P // k, rounded up to odd (coprime with power-of-two
        # pools), adjusted until the k slots are distinct mod P.
        s = max(p // max(k, 1), 1)
        if s % 2 == 0:
            s += 1
        s %= p
        if s == 0:
            s = 1
        while len({(j * s) % p for j in range(k)}) != k:
            s += 2
    return p, s


def _text_entity_grads(params, batch, key, desc, cfg, num_entities=None):
    # num_entities overrides the sampling range when the entity table is
    # padded (e.g. to a multiple of the mesh model axis): padded rows must
    # never be sampled as negatives.
    if cfg.shared_negatives and cfg.negative_pool_size > 0:
        raise ValueError(
            "shared_negatives and negative_pool_size are mutually exclusive"
        )
    pool, pool_stride = resolve_negative_sampling(
        cfg, desc, batch.features.shape[0],
        num_entities=num_entities or params.num_entities,
    )
    if cfg.shared_negatives or pool:
        if not _accumulate_only_optimizer(cfg):
            raise ValueError(
                "shared/pooled negatives require an accumulate-only "
                "optimizer (sgd or full_adam)"
            )
    if pool:
        pool_ids = obj.sample_negative_pool(
            key, num_entities or params.num_entities, pool
        )
        cost, _, grads = obj.text_entity_cost_and_grads_pooled(
            params, batch, pool_ids, cfg.num_random_entities, desc,
            stream_dtype=cfg.resolved_stream_dtype(),
            uniform_feature_weights=cfg.uniform_feature_weights,
            window_sum_dtype=cfg.resolved_window_sum_dtype(),
            pool_stride=pool_stride,
        )
        return cost, grads
    if cfg.shared_negatives:
        neg_ids = obj.sample_shared_negative_entities(
            key, num_entities or params.num_entities,
            cfg.num_random_entities,
        )
        cost, _, grads = obj.text_entity_cost_and_grads_shared(
            params, batch, neg_ids, desc,
            stream_dtype=cfg.resolved_stream_dtype(),
            uniform_feature_weights=cfg.uniform_feature_weights,
            window_sum_dtype=cfg.resolved_window_sum_dtype(),
        )
        return cost, grads
    negatives = getattr(batch, "negatives", None)
    if negatives is not None:
        # Reference-RNG replay: negatives were drawn on the host from the
        # minstd_rand0 stream (labels.cu:3-22) and ride in the batch.
        entity_ids = jnp.concatenate(
            [batch.labels[:, None], negatives], axis=1
        )
    else:
        entity_ids = obj.sample_negative_entities(
            key, batch.labels, num_entities or params.num_entities,
            cfg.num_random_entities,
        )
    cost, _, grads = obj.text_entity_cost_and_grads(
        params, batch, entity_ids, desc,
        factored_entity_grads=_accumulate_only_optimizer(cfg),
        stream_dtype=cfg.resolved_stream_dtype(),
        uniform_feature_weights=cfg.uniform_feature_weights,
        window_sum_dtype=cfg.resolved_window_sum_dtype(),
    )
    return cost, grads


def _similarity_grads(params, batch, desc, table_name):
    table = params.word_reprs if table_name == "word" else params.entity_reprs
    cost, _, sparse = obj.similarity_cost_and_grads(table, batch, desc)
    empty: Tuple = ()
    if table_name == "word":
        grads = obj.AscentGrads((sparse,), empty, None, None)
    else:
        grads = obj.AscentGrads(empty, (sparse,), None, None)
    return cost, grads


def compute_cost_and_grads(
    kind: ObjectiveKind,
    params: ModelParams,
    batch,
    key: jax.Array,
    desc: ModelDesc,
    cfg: TrainConfig,
    num_entities: Optional[int] = None,
):
    """Cost + merged ascent gradients for any objective flavour.

    For composites, ``batch`` is a (TextEntityBatch, SimilarityBatch) tuple;
    the reported cost is the *mean* of constituent costs
    (MultiForwardResultBase::get_cost, intermediate_results.cu:222-230) while
    gradients are merged weighted by the mixture weights
    (objective.cu:724-743 + intermediate_results.cu:3-60).
    """
    if kind == ObjectiveKind.TEXT_ENTITY:
        return _text_entity_grads(params, batch, key, desc, cfg, num_entities)
    if kind == ObjectiveKind.ENTITY_ENTITY:
        return _similarity_grads(params, batch, desc, "entity")
    if kind == ObjectiveKind.TERM_TERM:
        return _similarity_grads(params, batch, desc, "word")

    te_batch, sim_batch = batch
    te_cost, te_grads = _text_entity_grads(
        params, te_batch, key, desc, cfg, num_entities
    )
    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        sim_cost, sim_grads = _similarity_grads(
            params, sim_batch, desc, "entity"
        )
        sim_weight = cfg.entity_entity_weight
    else:
        sim_cost, sim_grads = _similarity_grads(params, sim_batch, desc, "word")
        sim_weight = cfg.term_term_weight
    merged = obj.merge_ascent_grads(
        ((te_grads, cfg.text_entity_weight), (sim_grads, sim_weight))
    )
    return 0.5 * (te_cost + sim_cost), merged


def scaled_regularization_lambda(cfg: TrainConfig, kind: ObjectiveKind) -> float:
    """lambda / batch_size (intermediate_results.cu:126-129); for composites
    the average over constituents (intermediate_results.cu:232-240) — both
    streams use the same batch size (main.cu:221-333), so it's the same
    value."""
    return cfg.regularization_lambda / cfg.batch_size


def make_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    kind: Optional[ObjectiveKind] = None,
    jit: bool = True,
    num_entities: Optional[int] = None,
    mesh=None,
):
    """Build the train step: forward + backward + optimizer update.

    ``mesh`` (a jax.sharding.Mesh) marks the step as running under a
    device mesh: the word-table accumulation is then shard_mapped over
    every mesh axis so GSPMD cannot replicate the update stream (see
    optim.updates._data_sharded_accumulate)."""
    if kind is None:
        kind = objective_kind_from_config(cfg)
    optimizer = Optimizer(cfg, data_shard_mesh=mesh)
    lr = cfg.resolved_learning_rate()
    lam = scaled_regularization_lambda(cfg, kind)

    def step(params: ModelParams, opt_state: OptState, batch, key: jax.Array):
        cost, grads = compute_cost_and_grads(
            kind, params, batch, key, desc, cfg, num_entities
        )
        params, opt_state = optimizer.apply(params, opt_state, grads, lr, lam)
        return params, opt_state, cost

    if jit:
        step = jax.jit(step, donate_argnums=(0, 1))
    return step


def make_multistep_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    num_steps: int,
    kind: Optional[ObjectiveKind] = None,
):
    """K chained training steps in one compiled program via lax.scan.

    Takes batches stacked on a leading [num_steps, ...] axis and a single
    key (split per step inside).  Amortizes per-step host dispatch and lets
    XLA overlap consecutive steps' transfers.  Returns
    (params, opt_state, costs[num_steps]).
    """
    if kind is None:
        kind = objective_kind_from_config(cfg)
    step = make_train_step(desc, cfg, kind, jit=False)

    def multistep(params, opt_state, stacked_batches, key):
        keys = jax.random.split(key, num_steps)

        def body(carry, inputs):
            p, o = carry
            batch, k = inputs
            p, o, cost = step(p, o, batch, k)
            return (p, o), cost

        (params, opt_state), costs = jax.lax.scan(
            body, (params, opt_state), (stacked_batches, keys)
        )
        return params, opt_state, costs

    return jax.jit(multistep, donate_argnums=(0, 1))


def make_cost_fn(desc: ModelDesc, cfg: TrainConfig, kind: ObjectiveKind):
    """Forward-only cost (Model::get_cost, model.cu:154-174). The same key
    replays the same negative samples."""

    def cost(params: ModelParams, batch, key: jax.Array):
        c, _ = compute_cost_and_grads(kind, params, batch, key, desc, cfg)
        return c

    return cost


def make_optimized_cost_fn(desc: ModelDesc, cfg: TrainConfig, kind: ObjectiveKind):
    """The scalar objective whose gradient the merged ascent gradients are.

    For single objectives this is the reported cost.  For composites the
    reference *reports* the unweighted mean of constituent costs
    (intermediate_results.cu:222-230) but *optimizes* the weight-normalized
    sum sum_i(w_i * c_i) / sum_i(w_i) (MergeGradientsFn scales each
    constituent by w_i / sum w, intermediate_results.cu:30-38) — the two only
    coincide at equal weights, which is the only setting the reference's own
    gradient checker exercises (tests_base_cuda.h:100-102).
    """
    if kind in (
        ObjectiveKind.TEXT_ENTITY,
        ObjectiveKind.ENTITY_ENTITY,
        ObjectiveKind.TERM_TERM,
    ):
        return make_cost_fn(desc, cfg, kind)

    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        sim_weight = cfg.entity_entity_weight
        sim_table = "entity"
    else:
        sim_weight = cfg.term_term_weight
        sim_table = "word"
    total = cfg.text_entity_weight + sim_weight

    def cost(params: ModelParams, batch, key: jax.Array):
        te_batch, sim_batch = batch
        te_cost, _ = _text_entity_grads(params, te_batch, key, desc, cfg)
        sim_cost, _ = _similarity_grads(params, sim_batch, desc, sim_table)
        return (cfg.text_entity_weight * te_cost + sim_weight * sim_cost) / total

    return cost
