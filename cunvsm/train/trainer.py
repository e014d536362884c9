"""Epoch-driven training loop (cuNVSMTrainModel's train<ObjectiveT>,
main.cu:492-621, rebuilt around a single jit'd step).

Differences from the reference, driven by the compiled-program execution
model:

* the whole step (forward + backward + optimizer) is one compiled XLA
  program with donated buffers; per-batch costs stay on device and are only
  fetched at logging boundaries, so the host never serializes the pipeline
  (the reference synchronizes on every batch's cost readback,
  intermediate_results.cu:99-113);
* negative sampling runs on device from a per-step PRNG key derived from the
  global step counter (deterministic replay without the reference's
  RNG-state string snapshots, model.cu:154-174);
* host batch preparation overlaps device compute through a prefetch thread
  (the AsyncSource role, data_async.cpp).

Adds true resume (checkpointing optimizer state + epoch cursor), which the
reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import Corpus
from cunvsm.data.instances import (
    FeatureWeighting,
    TextEntitySource,
    Weighting,
)
from cunvsm.data.sources import (
    Prefetcher,
    SimilaritySource,
    repeating,
    zip_sources,
)
from cunvsm.io import checkpoint as ckpt
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams, init_params
from cunvsm.optim.updates import Optimizer
from cunvsm.train.step import (
    ObjectiveKind,
    make_multistep_train_step,
    make_train_step,
    objective_kind_from_config,
)

logger = logging.getLogger(__name__)


def _to_device_batch(np_batch):
    if isinstance(np_batch, tuple) and not hasattr(np_batch, "_fields"):
        te, sim = np_batch
        return (_to_device_batch(te), _to_device_batch(sim))
    if hasattr(np_batch, "ids"):  # SimilarityBatchNp
        return obj.SimilarityBatch(
            ids=jnp.asarray(np_batch.ids), weights=jnp.asarray(np_batch.weights)
        )
    negatives = getattr(np_batch, "negatives", None)
    return obj.TextEntityBatch(
        features=jnp.asarray(np_batch.features),
        feature_weights=jnp.asarray(np_batch.feature_weights),
        labels=jnp.asarray(np_batch.labels),
        weights=jnp.asarray(np_batch.weights),
        negatives=None if negatives is None else jnp.asarray(negatives),
    )


@dataclasses.dataclass
class TrainResult:
    params: ModelParams
    opt_state: object
    epoch_costs: List[float]
    batches_per_sec: float


def train_model(
    desc: ModelDesc,
    cfg: TrainConfig,
    corpus: Corpus,
    output_prefix: Optional[str] = None,
    similarity_source: Optional[SimilaritySource] = None,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
    weighting: Weighting = Weighting.AUTOMATIC,
    compute_initial_cost: bool = False,
    dump_initial_model: bool = False,
    dump_every: int = 0,
    resume: bool = False,
    prefetch_depth: int = 10,
    dtype=jnp.float32,
    epoch_callback: Optional[Callable] = None,
    check_gradients: bool = False,
    profile_dir: Optional[str] = None,
    log_every: int = 0,
    steps_per_call: int = 1,
    mesh=None,
    on_device_sampling: bool = False,
    shard_corpus: bool = False,
    stratify_data_groups: int = 0,
    checkpoint_every: int = 1,
) -> TrainResult:
    """Train a model over a corpus.

    ``check_gradients`` verifies every batch's analytic gradients against
    central finite differences before updating (the --check_gradients flow,
    main.cu:414-425) — float64/CPU recommended.  ``profile_dir`` captures a
    jax.profiler trace of the first training epoch (the NVTX-range analog,
    main.cu:386-463).  ``log_every`` emits per-batch cost/progress/ETA lines
    (the VLOG(1) batch logging, main.cu:445-451).  ``steps_per_call`` > 1
    chains that many steps inside one compiled scan (dispatch amortization;
    incompatible with check_gradients and intra-group dump_every
    granularity; under on-device sampling a K that does not divide the
    epoch's step count keeps its size and the remainder steps run as ONE
    extra compiled call per epoch — with a warning, since the remainder
    program is one additional one-time compile — so every full batch
    trains exactly once per epoch).  ``mesh`` (a jax.sharding.Mesh with ("data", "model")
    axes) trains multi-chip: the entity table and its optimizer state shard
    over the model axis and batches over data (parallel/mesh.py); requires
    batch_size divisible by the data axis and the entity count by the model
    axis.  ``on_device_sampling`` keeps the packed corpus in HBM and samples
    batches inside the compiled step (data/device_sampler.py) — the fastest
    path for stochastic text-entity training; epoch-exact by default (the
    per-epoch document-pointer permutation is reshuffled on device,
    reproducing the host generator's per-document sample counts).
    ``shard_corpus`` (with mesh + on_device_sampling) shards the
    device-resident corpus itself over the data axis — each chip holds only
    its document group's tokens and samples its batch shard locally
    (multi-card memory; per-group instead of global epoch shuffle — see
    data.device_sampler.ShardedDeviceCorpus).  ``stratify_data_groups``
    (single-device on_device_sampling only) reproduces that sharded epoch
    shuffle — per-group reshuffles, every batch stratified over N
    token-balanced document groups — on an unsharded corpus, to quality-A/B
    the shard_corpus shuffle relaxation without a mesh.
    ``checkpoint_every`` dumps the per-epoch model/resume state only every
    Nth epoch (the final epoch always dumps) — at collection scale the
    reference's dump-every-epoch default can out-pace slow storage; the
    intra-epoch ``dump_every`` batch cadence is unaffected.
    """
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    kind = objective_kind_from_config(cfg)
    key = jax.random.PRNGKey(cfg.seed)

    # UNIFORM feature weighting means every batch's feature_weights are all
    # ones: promise that statically so the step can skip the window-average
    # multiply and run the packed accumulation sort (config.py).
    if feature_weighting == FeatureWeighting.UNIFORM:
        cfg = dataclasses.replace(cfg, uniform_feature_weights=True)
    elif cfg.uniform_feature_weights:
        raise ValueError(
            "uniform_feature_weights requires UNIFORM feature weighting"
        )

    if cfg.reference_rng and on_device_sampling:
        raise ValueError(
            "reference_rng replays the host minstd_rand0 pipeline; "
            "on_device_sampling draws on device — pick one"
        )
    source = TextEntitySource(
        corpus,
        batch_size=cfg.batch_size,
        shuffle=not cfg.no_shuffle,
        weighting=weighting,
        feature_weighting=feature_weighting,
        seed=cfg.seed,
        reference_rng=cfg.reference_rng,
        num_negative=cfg.num_random_entities if cfg.reference_rng else 0,
    )
    if kind != ObjectiveKind.TEXT_ENTITY and similarity_source is None:
        raise ValueError(f"objective {kind} requires a similarity source")

    num_real_entities = corpus.num_docs
    num_table_entities = num_real_entities
    if mesh is not None:
        from cunvsm.parallel.mesh import (
            make_sharded_train_step,
            pad_entities,
        )

        model_axis = mesh.shape["model"]
        data_axis = mesh.shape["data"]
        if cfg.batch_size % data_axis:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by data axis "
                f"{data_axis}"
            )
        # The word-table accumulation shard_maps the update stream over
        # EVERY mesh axis (optim.updates._data_sharded_accumulate), so the
        # full_adam path needs the batch divisible by the TOTAL device
        # count — fail here with a clear message instead of deep inside
        # shard_map tracing (e.g. on a 2x3 or 1x7 mesh).
        from cunvsm.config import AdamMode, UpdateMethod

        total_devices = data_axis * model_axis
        if (
            cfg.update_method == UpdateMethod.ADAM
            and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE
            and cfg.batch_size % total_devices
        ):
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the total "
                f"device count {total_devices} (mesh "
                f"{data_axis}x{model_axis}): the full_adam word "
                f"accumulation shards the update stream over every mesh "
                f"axis"
            )
        num_table_entities = pad_entities(num_real_entities, model_axis)

    if cfg.reference_rng:
        # Full-stream replay: the reference performs epoch 1's position
        # draws + pointer shuffle in the generator ctor (data_indri.cpp:
        # 279,328-398), THEN Glorot init from the same engine (main.cu:
        # 499,520), then per-batch negative labels — reproduce that order
        # so a seed-for-seed run is bit-comparable with the CUDA binary
        # end to end.
        if compute_initial_cost:
            raise ValueError(
                "reference_rng does not replay the initial-cost pass's "
                "label draws (main.cu:544-562); disable "
                "compute_initial_cost under reference_rng"
            )
        from cunvsm.models.params import reference_init_params

        source.draw_next_epoch()
        params = reference_init_params(
            source.std_rng, corpus.vocab.size, num_real_entities, desc,
            dtype=dtype, pad_entities_to=num_table_entities,
        )
    else:
        params = init_params(
            key, corpus.vocab.size, num_table_entities, desc, dtype=dtype
        )
    optimizer = Optimizer(cfg)
    opt_state = optimizer.init(params)

    def unpad(p: ModelParams) -> ModelParams:
        if num_table_entities == num_real_entities:
            return p
        return p._replace(entity_reprs=p.entity_reprs[:num_real_entities])

    sharded_multi = None
    if mesh is not None:
        B, W = cfg.batch_size, cfg.window_size
        te_example = obj.TextEntityBatch(
            features=jnp.zeros((B, W), jnp.int32),
            feature_weights=jnp.ones((B, W), dtype),
            labels=jnp.zeros((B,), jnp.int32),
            weights=jnp.ones((B,), dtype),
        )
        if kind == ObjectiveKind.TEXT_ENTITY:
            example_batch = te_example
        else:
            example_batch = (
                te_example,
                obj.SimilarityBatch(
                    ids=jnp.zeros((B, 2), jnp.int32),
                    weights=jnp.ones((B,), dtype),
                ),
            )
        if steps_per_call > 1:
            from cunvsm.parallel.mesh import make_sharded_multistep

            stacked_example = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(
                    x, (steps_per_call,) + x.shape
                ),
                example_batch,
            )
            sharded_multi, params, opt_state = make_sharded_multistep(
                desc, cfg, mesh, params, opt_state, stacked_example,
                steps_per_call, kind, num_entities=num_real_entities,
            )
        step, params, opt_state = make_sharded_train_step(
            desc, cfg, mesh, params, opt_state, example_batch, kind,
            num_entities=num_real_entities,
        )
    else:
        step = make_train_step(desc, cfg, kind)

    start_epoch = 1
    resumed_batches = 0
    if resume and output_prefix and os.path.exists(
        f"{output_prefix}_resume.npz"
    ):
        params, opt_state, last_epoch, extra = ckpt.load_training_state(
            output_prefix, params, opt_state
        )
        start_epoch = last_epoch + 1
        resumed_batches = int(extra.get("total_batches", 0))
        # Replay the data stream's per-epoch RNG draws so the resumed epoch
        # samples what an uninterrupted run would have sampled; the step
        # counter below replays the per-step PRNG keys the same way.
        source.skip_epochs(last_epoch)
        logger.info("Resumed from epoch %d.", last_epoch)

    from cunvsm.parallel.distributed import is_primary

    if output_prefix and start_epoch == 1 and is_primary():
        # One-time metadata + sidecars (main.cu:527-537).  Exactly one
        # process writes under multi-process (shared checkpoint FS; the
        # per-epoch dumps are gated the same way inside the writer).
        meta = ckpt.build_metadata(
            corpus.vocab.index_term_ids,
            corpus.vocab.term_freq,
            corpus.num_docs,
            corpus.vocab.total_terms,
            corpus.vocab.include_oov,
            index_object_ids=corpus.index_doc_ids,
        )
        ckpt.save_meta(meta, output_prefix)
        ckpt.save_corpus_sidecars(corpus, output_prefix)

    device_run = None
    device_run_rem = None
    rem_steps = 0
    if stratify_data_groups and not on_device_sampling:
        raise ValueError("stratify_data_groups requires on_device_sampling")
    if on_device_sampling:
        # Explicit errors (not asserts): these must also fire under -O.
        if kind != ObjectiveKind.TEXT_ENTITY:
            raise ValueError(
                "on-device sampling supports only the text-entity objective"
            )
        if cfg.no_shuffle:
            raise ValueError("on-device sampling is stochastic-only")
        if check_gradients:
            raise ValueError(
                "check_gradients is incompatible with on-device sampling"
            )
        from cunvsm.data.device_sampler import (
            make_device_sampled_multistep,
            prepare_device_corpus,
        )

        if shard_corpus and mesh is None:
            raise ValueError("shard_corpus requires a mesh")
        if stratify_data_groups and shard_corpus:
            raise ValueError(
                "stratify_data_groups simulates the shard_corpus shuffle "
                "on an unsharded corpus; pick one"
            )
        resolved_weighting = (
            Weighting.UNIFORM
            if weighting == Weighting.AUTOMATIC
            else weighting
        )
        if shard_corpus:
            # Data-axis-sharded corpus: each chip holds only its document
            # group's tokens (multi-card memory; per-group shuffle).
            from cunvsm.data.device_sampler import (
                make_sharded_epoch_permuter,
                prepare_sharded_device_corpus,
            )

            sdc = prepare_sharded_device_corpus(
                corpus, mesh,
                weighting=resolved_weighting,
                feature_weighting=feature_weighting,
            )
            epoch_permuter, _ptrs_per_epoch = make_sharded_epoch_permuter(
                sdc, mesh
            )
        else:
            dc = prepare_device_corpus(
                corpus,
                weighting=resolved_weighting,
                feature_weighting=feature_weighting,
            )
            if stratify_data_groups:
                # Reproduce the shard_corpus epoch semantics (per-group
                # shuffle, stratified batches) on this unsharded corpus —
                # the quality A/B of the sharded shuffle relaxation.
                from cunvsm.data.device_sampler import (
                    make_stratified_epoch_permuter,
                )

                epoch_permuter, _ptrs_per_epoch = (
                    make_stratified_epoch_permuter(
                        dc, stratify_data_groups, cfg.batch_size
                    )
                )
            else:
                from cunvsm.data.device_sampler import (
                    make_epoch_permuter,
                )

                # Epoch-exact sampling (StochasticInstanceGenerator
                # parity): one on-device reshuffle of the document-pointer
                # array per epoch.
                epoch_permuter, _ptrs_per_epoch = make_epoch_permuter(dc)
        # Exact epoch semantics: a K that does not divide the epoch's step
        # count would silently drop the remainder steps every epoch (the
        # reference trains every instance each epoch).  Train the
        # remainder in ONE extra compiled call of (steps % K) steps per
        # epoch — one additional one-time compile, amortized over the
        # run — instead of shrinking K (the largest-divisor fallback
        # collapses to K=1 on prime step counts, making every epoch
        # dispatch-bound).
        steps_epoch = max(
            min(source.batches_per_epoch(),
                _ptrs_per_epoch // cfg.batch_size),
            1,
        )
        steps_per_call = min(max(steps_per_call, 1), steps_epoch)
        rem_steps = steps_epoch % steps_per_call
        if rem_steps:
            logger.warning(
                "steps_per_call=%d does not divide the epoch's %d steps; "
                "the %d remainder steps run as one extra compiled call "
                "per epoch (one additional one-time compile).  Pick a "
                "divisor of %d to avoid it.",
                steps_per_call, steps_epoch, rem_steps, steps_epoch,
            )
        if shard_corpus:
            from cunvsm.data.device_sampler import (
                make_corpus_sharded_multistep,
            )

            device_run, params, opt_state = make_corpus_sharded_multistep(
                desc, cfg, sdc, steps_per_call, mesh,
                params, opt_state, num_entities=num_real_entities,
            )
            if rem_steps:
                device_run_rem, params, opt_state = (
                    make_corpus_sharded_multistep(
                        desc, cfg, sdc, rem_steps, mesh,
                        params, opt_state,
                        num_entities=num_real_entities,
                    )
                )
        elif mesh is not None:
            from cunvsm.data.device_sampler import (
                make_device_sampled_sharded_multistep,
            )

            device_run, params, opt_state = (
                make_device_sampled_sharded_multistep(
                    desc, cfg, dc, steps_per_call, mesh,
                    params, opt_state, num_entities=num_real_entities,
                    epoch_exact=True,
                )
            )
            if rem_steps:
                device_run_rem, params, opt_state = (
                    make_device_sampled_sharded_multistep(
                        desc, cfg, dc, rem_steps, mesh,
                        params, opt_state,
                        num_entities=num_real_entities,
                        epoch_exact=True,
                    )
                )
        else:
            device_run = make_device_sampled_multistep(
                desc, cfg, dc, steps_per_call, epoch_exact=True
            )
            if rem_steps:
                device_run_rem = make_device_sampled_multistep(
                    desc, cfg, dc, rem_steps, epoch_exact=True
                )

    multistep = None
    if steps_per_call > 1 and not on_device_sampling:
        if check_gradients:
            raise ValueError("check_gradients requires steps_per_call=1")
        multistep = (
            sharded_multi
            if mesh is not None
            else make_multistep_train_step(desc, cfg, steps_per_call, kind)
        )

    def epoch_stream(group: bool = True):
        batches = source.epoch_batches()
        if kind != ObjectiveKind.TEXT_ENTITY:
            batches = zip_sources(batches, sim_iter)
        if group and steps_per_call > 1:
            def grouped(it):
                group = []
                for b in it:
                    group.append(b)
                    if len(group) == steps_per_call:
                        yield jax.tree_util.tree_map(
                            lambda *xs: np.stack(xs), *group
                        )
                        group = []
                for b in group:  # tail runs as single steps
                    yield b
            batches = grouped(batches)
        return Prefetcher(
            (_to_device_batch(b) for b in batches), depth=prefetch_depth
        )

    sim_iter = (
        iter(repeating(similarity_source)) if similarity_source else None
    )

    if compute_initial_cost:
        # main.cu:544-562: one forward-only pass before training.
        from cunvsm.train.step import make_cost_fn

        cost_fn = jax.jit(make_cost_fn(desc, cfg, kind))
        # Dedicated key stream disjoint from training steps.
        init_key = jax.random.fold_in(key, 0x7FFFFFFF)
        costs = []
        # Always single batches here (the cost fn is per-batch).
        for i, batch in enumerate(epoch_stream(group=False)):
            costs.append(
                cost_fn(params, batch, jax.random.fold_in(init_key, i))
            )
        if costs:
            logger.info(
                "Initial cost: %.6f",
                float(jnp.mean(jnp.stack(costs))),
            )

    # All checkpoint file IO runs off-thread (io/checkpoint.py
    # AsyncCheckpointWriter): the training loop pays only the
    # device-to-host snapshot at each epoch boundary.
    writer = ckpt.AsyncCheckpointWriter() if output_prefix else None
    # Drain/close the async writer even when the loop raises or the
    # user interrupts: pending epoch checkpoints must complete and
    # worker errors must surface (close() joins the worker thread and
    # re-raises the first error it hit).
    try:
        if dump_initial_model and output_prefix:
            writer.save_model(unpad(params), output_prefix, 0)

        epoch_costs: List[float] = []
        total_batches = resumed_batches
        if resumed_batches and sim_iter is not None:
            # Fast-forward the similarity stream past the consumed batches.
            for _ in range(resumed_batches):
                next(sim_iter)
        train_start = time.time()
        batches_per_epoch = max(source.batches_per_epoch(), 1)

        if kind == ObjectiveKind.TEXT_ENTITY or kind in (
            ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY,
            ObjectiveKind.TEXT_ENTITY_TERM_TERM,
        ):
            from cunvsm.train.step import resolve_negative_sampling

            pool, stride = resolve_negative_sampling(
                cfg, desc, cfg.batch_size, num_entities=num_real_entities
            )
            if cfg.shared_negatives:
                logger.info("Negative sampling: batch-shared (k=%d).",
                            cfg.num_random_entities)
            elif pool:
                logger.info(
                    "Negative sampling: rolled pool P=%d stride=%d "
                    "(exact per-example loss, k=%d)%s.",
                    pool, stride, cfg.num_random_entities,
                    " [auto]" if cfg.negative_pool_size == -1 else "",
                )
            else:
                logger.info(
                    "Negative sampling: per-instance (reference-exact, k=%d).",
                    cfg.num_random_entities,
                )

        if mesh is not None:
            # Attributability: "auto" silently narrows the [V, d_w] word
            # psum to bfloat16 when the streams are bf16 — state what the
            # run actually does (advisor finding, round 4).
            reduce_dt = cfg.resolved_cross_chip_reduce_dtype()
            logger.info(
                "Cross-chip word-gradient reduce dtype: %s (configured %s, "
                "stream %s).",
                reduce_dt or "float32", cfg.cross_chip_reduce_dtype,
                cfg.stream_dtype,
            )

        if check_gradients:
            from cunvsm.train.gradcheck import check_gradients as run_check

        profiling = False
        if profile_dir:
            jax.profiler.start_trace(profile_dir)
            profiling = True

        for epoch in range(start_epoch, cfg.num_epochs + 1):
            epoch_start = time.time()
            batch_costs = []
            epoch_step_count = 0
            if device_run is not None:
                # Fully on-device epochs: no host batches at all.  The shuffled
                # per-epoch pointer permutation is regenerated on device
                # (DataSource::reset parity) and consumed via a cursor.
                doc_perm = epoch_permuter(
                    jax.random.fold_in(jax.random.fold_in(key, 0x5A5A5A), epoch)
                )
                k = max(steps_per_call, 1)
                num_calls = max(
                    min(batches_per_epoch,
                        _ptrs_per_epoch // cfg.batch_size) // k,
                    1,
                )
                epoch_steps = 0
                for call in range(num_calls):
                    step_key = jax.random.fold_in(key, total_batches)
                    params, opt_state, costs = device_run(
                        params, opt_state, step_key, doc_perm,
                        call * k * cfg.batch_size,
                    )
                    # Keep the [K] cost arrays whole: slicing them into
                    # scalars here would issue K extra dispatches per call.
                    batch_costs.append(costs)
                    total_batches += k
                    epoch_steps += k
                if device_run_rem is not None:
                    # The epoch tail that K does not divide: one extra
                    # compiled call of rem_steps steps.
                    step_key = jax.random.fold_in(key, total_batches)
                    params, opt_state, costs = device_run_rem(
                        params, opt_state, step_key, doc_perm,
                        num_calls * k * cfg.batch_size,
                    )
                    batch_costs.append(costs)
                    total_batches += rem_steps
                    epoch_steps += rem_steps
                epoch_cost = (
                    float(jnp.mean(jnp.concatenate(batch_costs)))
                    if batch_costs
                    else 0.0
                )
                epoch_costs.append(epoch_cost)
                duration = time.time() - epoch_start
                logger.info(
                    "Epoch %d (on-device sampling): cost=%.6f "
                    "(%d steps, %.1fs)",
                    epoch, epoch_cost, epoch_steps, duration,
                )
                if profiling:
                    jax.profiler.stop_trace()
                    profiling = False
                if output_prefix and (
                    epoch % checkpoint_every == 0 or epoch == cfg.num_epochs
                ):
                    writer.save_model(unpad(params), output_prefix, epoch,
                                      overwrite=resume)
                    writer.save_training_state(
                        output_prefix, params, opt_state, epoch,
                        extra={"total_batches": np.asarray(total_batches)},
                    )
                if epoch_callback:
                    epoch_callback(epoch, unpad(params), epoch_cost)
                continue
            for batch in epoch_stream():
                step_key = jax.random.fold_in(key, total_batches)
                # Single batches have 2-D leading leaves ([B, W] features /
                # [B, 2] ids); stacked groups have a [K, ...] axis on top.
                is_group = (
                    multistep is not None
                    and jax.tree_util.tree_leaves(batch)[0].ndim > 2
                )
                if is_group:
                    params, opt_state, costs = multistep(
                        params, opt_state, batch, step_key
                    )
                    # Whole [K] arrays (no per-step slicing dispatches).
                    batch_costs.append(costs)
                    epoch_step_count += steps_per_call
                    total_batches += steps_per_call
                    cost = costs[-1]
                else:
                    if check_gradients:
                        run_check(kind, params, batch, step_key, desc, cfg)
                    params, opt_state, cost = step(
                        params, opt_state, batch, step_key
                    )
                    batch_costs.append(jnp.reshape(cost, (1,)))
                    epoch_step_count += 1
                    total_batches += 1
                if log_every and total_batches % log_every == 0:
                    done = epoch_step_count / batches_per_epoch
                    elapsed = time.time() - epoch_start
                    eta = elapsed / max(done, 1e-9) * (1.0 - done)
                    logger.info(
                        "Batch %d (epoch %d): cost=%.6f progress=%.1f%% "
                        "eta=%.0fs",
                        total_batches,
                        epoch,
                        float(cost),
                        100.0 * done,
                        eta,
                    )
                if (
                    dump_every > 0
                    and output_prefix
                    and total_batches % dump_every == 0
                ):
                    writer.save_model(
                        unpad(params), output_prefix, f"{epoch}_{total_batches}"
                    )
            # Single host sync per epoch.
            epoch_cost = (
                float(jnp.mean(jnp.concatenate(batch_costs)))
                if batch_costs
                else 0.0
            )
            epoch_costs.append(epoch_cost)
            duration = time.time() - epoch_start
            bps = epoch_step_count / duration if duration > 0 else 0.0
            logger.info(
                "Epoch %d: cost=%.6f (%d batches, %.1f batches/s, %.1fs); "
                "history=%s",
                epoch,
                epoch_cost,
                epoch_step_count,
                bps,
                duration,
                [f"{c:.4f}" for c in epoch_costs[-5:]],
            )
            if profiling:
                # Capture the first trained epoch only.
                jax.profiler.stop_trace()
                profiling = False
            dumped = output_prefix and (
                epoch % checkpoint_every == 0 or epoch == cfg.num_epochs
            )
            if dumped:
                writer.save_model(
                    unpad(params), output_prefix, epoch,
                    overwrite=resume,
                )
                # The resume state keeps the padded layout for mesh consistency.
                writer.save_training_state(
                    output_prefix, params, opt_state, epoch,
                    extra={"total_batches": np.asarray(total_batches)},
                )
            if epoch_callback:
                if dumped:
                    # Callbacks routinely read this epoch's checkpoint
                    # (validation ranking, visualization); the writes above
                    # are async, so barrier the writer first or the
                    # callback races the file rename.
                    writer.wait()
                epoch_callback(epoch, unpad(params), epoch_cost)

    finally:
        if writer is not None:
            writer.close()
    total_time = time.time() - train_start
    return TrainResult(
        params=unpad(params),
        opt_state=opt_state,
        epoch_costs=epoch_costs,
        batches_per_sec=(
            total_batches / total_time if total_time > 0 else 0.0
        ),
    )
