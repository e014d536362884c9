"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Verifies (a) the sharded train step compiles and runs with real
data x model shardings, (b) it is numerically equivalent to the single-device
step, and (c) the sharded query scorer matches the dense ranking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import (
    AdamConfig,
    AdamMode,
    ModelDesc,
    TrainConfig,
    UpdateMethod,
)
from cunvsm.models import objectives as obj
from cunvsm.models.params import init_params
from cunvsm.optim.updates import Optimizer
from cunvsm.parallel.mesh import (
    default_mesh_shape,
    make_mesh,
    make_sharded_train_step,
)
from cunvsm.parallel.query import make_sharded_scorer
from cunvsm.train.step import make_train_step

NUM_WORDS, NUM_ENTITIES = 40, 32
D_W, D_E = 8, 8
B, W, K = 16, 4, 3


def make_setup(update_method=UpdateMethod.ADAM, mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE):
    desc = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E)
    cfg = TrainConfig(
        batch_size=B,
        window_size=W,
        num_random_entities=K,
        update_method=update_method,
        adam=AdamConfig(mode=mode),
        learning_rate=0.01,
    )
    params = init_params(
        jax.random.PRNGKey(0), NUM_WORDS, NUM_ENTITIES, desc, dtype=jnp.float32
    )
    opt = Optimizer(cfg)
    return desc, cfg, params, opt.init(params)


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    return obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, NUM_WORDS, (B, W)), jnp.int32),
        feature_weights=jnp.ones((B, W), jnp.float32),
        labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (B,)), jnp.int32),
        weights=jnp.ones((B,), jnp.float32),
    )


def test_mesh_shapes():
    assert default_mesh_shape(1) == (1, 1)
    assert default_mesh_shape(8) == (2, 4)
    assert default_mesh_shape(7) == (1, 7)


@pytest.mark.parametrize(
    "method,mode",
    [
        (UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        (UpdateMethod.ADAM, AdamMode.SPARSE),
        (UpdateMethod.ADAGRAD, None),
        (UpdateMethod.SGD, None),
    ],
)
def test_sharded_step_matches_single_device(method, mode):
    desc, cfg, params, opt_state = make_setup(
        method, mode or AdamMode.DENSE_UPDATE_DENSE_VARIANCE
    )
    batch = make_batch()
    key = jax.random.PRNGKey(7)

    single = make_train_step(desc, cfg, jit=False)
    p_ref, _, cost_ref = single(params, opt_state, batch, key)

    mesh = make_mesh(2, 4)
    step, p_sh, o_sh = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch
    )
    p_out, o_out, cost = step(p_sh, o_sh, batch, key)

    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(p_out.entity_reprs),
        np.asarray(p_ref.entity_reprs),
        rtol=1e-5,
        atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(p_out.word_reprs),
        np.asarray(p_ref.word_reprs),
        rtol=1e-5,
        atol=1e-7,
    )


def test_sharded_step_multiple_iterations():
    desc, cfg, params, opt_state = make_setup()
    batch = make_batch()
    mesh = make_mesh(4, 2)
    step, p, o = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch
    )
    costs = []
    for i in range(5):
        p, o, c = step(p, o, make_batch(i), jax.random.PRNGKey(i))
        costs.append(float(c))
    assert all(np.isfinite(c) for c in costs)
    # Entity table stays sharded across steps (donated buffers).
    shard0 = p.entity_reprs.sharding
    assert shard0.spec == jax.sharding.PartitionSpec("model", None)


def test_sharded_query_scorer_matches_dense():
    rng = np.random.RandomState(0)
    docs = rng.randn(64, 8).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    queries = rng.randn(5, 8).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    mesh = make_mesh(1, 8)
    scorer, _ = make_sharded_scorer(mesh, jnp.asarray(docs), top_k=10)
    scores, idx = scorer(jnp.asarray(queries))

    dense = queries @ docs.T
    want_idx = np.argsort(-dense, axis=1)[:, :10]
    np.testing.assert_array_equal(np.asarray(idx), want_idx)
    np.testing.assert_allclose(
        np.asarray(scores),
        np.take_along_axis(dense, want_idx, axis=1),
        rtol=1e-5,
    )


def test_sharded_query_scorer_uneven_docs():
    # Document count not divisible by the shard count: padded rows must
    # never surface in the ranking.
    rng = np.random.RandomState(1)
    docs = rng.randn(61, 8).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    queries = rng.randn(3, 8).astype(np.float32)

    mesh = make_mesh(1, 8)
    scorer, _ = make_sharded_scorer(mesh, jnp.asarray(docs), top_k=61)
    scores, idx = scorer(jnp.asarray(queries))
    dense = queries @ docs.T
    want_idx = np.argsort(-dense, axis=1)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)
    assert int(np.asarray(idx).max()) < 61


def test_sharded_query_no_full_score_allgather():
    """The compiled HLO must move only per-shard candidates over the
    collective, never the full [Q, D] score matrix (SURVEY.md §3.4)."""
    rng = np.random.RandomState(0)
    num_docs, dim, num_q, k = 4096, 16, 32, 10
    docs = rng.randn(num_docs, dim).astype(np.float32)
    queries = rng.randn(num_q, dim).astype(np.float32)

    mesh = make_mesh(1, 8)
    scorer, _ = make_sharded_scorer(mesh, jnp.asarray(docs), top_k=k)
    compiled = scorer.lower(jnp.asarray(queries)).compile()
    hlo = compiled.as_text()

    import re

    collectives = re.findall(
        r"f32\[([\d,]+)\][^\n]*\b(all-gather|all-reduce|"
        r"collective-permute|all-to-all)\b",
        hlo,
    )
    assert collectives, "expected at least one candidate-merge collective"
    # Per-device full score matrix would be Q x D floats; the candidate
    # merge is Q x (shards * k).  Assert every collective output is at most
    # the candidate volume (with generous slack for fusion padding).
    budget = num_q * 8 * k * 4  # elements
    for shape, op in collectives:
        elems = int(np.prod([int(x) for x in shape.split(",")]))
        assert elems <= budget, (op, shape, hlo[:2000])
    # And nothing anywhere in the program materializes a replicated [Q, D].
    assert f"f32[{num_q},{num_docs}]" not in hlo


def test_trainer_with_mesh():
    """End-to-end mesh training through train_model: entity padding,
    sharded steps, unpadded results."""
    from cunvsm.config import DataConfig
    from cunvsm.data.corpus import build_corpus
    from cunvsm.train.trainer import train_model

    docs = [
        (f"d{i}", " ".join(
            f"w{j}" for j in np.random.RandomState(i).randint(0, 30, 25)))
        for i in range(13)  # deliberately not divisible by the model axis
    ]
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        num_epochs=2, batch_size=16, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    mesh = make_mesh(2, 4)
    result = train_model(desc, cfg, corpus, mesh=mesh)
    # Results come back unpadded.
    assert result.params.entity_reprs.shape[0] == corpus.num_docs == 13
    assert all(np.isfinite(c) for c in result.epoch_costs)


def test_trainer_mesh_divisibility_validated_up_front():
    """A non-power-of-two mesh whose total device count does not divide the
    batch must fail with a clear ValueError at train_model entry, not an
    opaque shard_map trace error (the full_adam word accumulation shards
    the update stream over EVERY mesh axis)."""
    from cunvsm.config import DataConfig
    from cunvsm.data.corpus import build_corpus
    from cunvsm.train.trainer import train_model

    docs = [
        (f"d{i}", " ".join(
            f"w{j}" for j in np.random.RandomState(i).randint(0, 30, 25)))
        for i in range(13)
    ]
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        num_epochs=1, batch_size=16, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    # 16 % 6 != 0: must raise before any compilation.
    with pytest.raises(ValueError, match="total device count"):
        train_model(desc, cfg, corpus, mesh=make_mesh(2, 3))
    # 1x7 (the default odd-count mesh shape): 16 % 7 != 0.
    with pytest.raises(ValueError, match="total device count"):
        train_model(desc, cfg, corpus, mesh=make_mesh(1, 7))
    # A divisible batch on the same 2x3 mesh trains fine end to end.
    cfg_ok = TrainConfig(
        num_epochs=1, batch_size=12, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    result = train_model(desc, cfg_ok, corpus, mesh=make_mesh(2, 3))
    assert result.params.entity_reprs.shape[0] == corpus.num_docs == 13
    assert all(np.isfinite(c) for c in result.epoch_costs)


def test_trainer_with_mesh_and_multistep():
    from cunvsm.config import DataConfig
    from cunvsm.data.corpus import build_corpus
    from cunvsm.train.trainer import train_model

    docs = [
        (f"d{i}", " ".join(
            f"w{j}" for j in np.random.RandomState(i).randint(0, 30, 25)))
        for i in range(10)
    ]
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        num_epochs=2, batch_size=16, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    mesh = make_mesh(2, 4)
    result = train_model(desc, cfg, corpus, mesh=mesh, steps_per_call=3)
    assert result.params.entity_reprs.shape[0] == corpus.num_docs
    assert all(np.isfinite(c) for c in result.epoch_costs)


def test_query_engine_with_mesh_matches_dense():
    """QueryEngine(mesh=...) serves through the sharded per-shard top-k
    path and must rank identically to the single-device engine."""
    from cunvsm.models.params import ModelParams
    from cunvsm.query.engine import QueryEngine

    rng = np.random.RandomState(5)
    num_words, num_docs, d_w, d_e = 40, 64, 8, 8
    params = ModelParams(
        word_reprs=jnp.asarray(rng.randn(num_words, d_w), jnp.float32),
        entity_reprs=jnp.asarray(rng.randn(num_docs, d_e), jnp.float32),
        transform_w=jnp.asarray(rng.randn(d_w, d_e), jnp.float32),
        transform_b=jnp.asarray(rng.randn(d_e), jnp.float32),
    )
    terms = [f"t{i}" for i in range(num_words)]
    docnos = [f"d{i}" for i in range(num_docs)]
    queries = {str(q): [f"t{t}" for t in rng.randint(0, num_words, 3)]
               for q in range(5)}

    dense = QueryEngine(params, terms, docnos, nonlinearity=None)
    sharded = QueryEngine(
        params, terms, docnos, nonlinearity=None, mesh=make_mesh(1, 8)
    )
    run_a = dense.rank(queries, top_k=10)
    run_b = sharded.rank(queries, top_k=10)
    assert run_a.keys() == run_b.keys()
    for qid in run_a:
        assert [d for d, _ in run_a[qid]] == [d for d, _ in run_b[qid]]
        np.testing.assert_allclose(
            [s for _, s in run_a[qid]], [s for _, s in run_b[qid]],
            rtol=1e-5,
        )


def test_sharded_step_shared_negatives_matches_single_device():
    """Batch-shared negatives through the mesh: the k-negative pool is drawn
    from a replicated key (identical on every shard by construction) and the
    dense k-row descriptor accumulates into the model-sharded entity table."""
    import dataclasses

    desc, cfg, params, opt_state = make_setup()
    cfg = dataclasses.replace(cfg, shared_negatives=True)
    batch = make_batch()
    key = jax.random.PRNGKey(11)

    single = make_train_step(desc, cfg, jit=False)
    p_ref, _, cost_ref = single(params, opt_state, batch, key)

    mesh = make_mesh(2, 4)
    step, p_sh, o_sh = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch
    )
    p_out, _, cost = step(p_sh, o_sh, batch, key)

    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(p_out.entity_reprs), np.asarray(p_ref.entity_reprs),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(p_out.word_reprs), np.asarray(p_ref.word_reprs),
        rtol=1e-5, atol=1e-7,
    )


def test_sharded_step_pooled_negatives_matches_single_device():
    """Rolled-pool negatives through the mesh: the residue-major reshape of
    the data-sharded batch is GSPMD's to partition; verify numerics only."""
    import dataclasses

    desc, cfg, params, opt_state = make_setup()
    cfg = dataclasses.replace(cfg, negative_pool_size=8)
    batch = make_batch()
    key = jax.random.PRNGKey(13)

    single = make_train_step(desc, cfg, jit=False)
    p_ref, _, cost_ref = single(params, opt_state, batch, key)

    mesh = make_mesh(2, 4)
    step, p_sh, o_sh = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch
    )
    p_out, _, cost = step(p_sh, o_sh, batch, key)

    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(p_out.entity_reprs), np.asarray(p_ref.entity_reprs),
        rtol=1e-5, atol=1e-7,
    )


def test_query_engine_mesh_second_topk_masks_padding():
    """Regression: a second rank() with a different top_k rebuilds the
    sharded scorer over the already-padded cached matrix; the pad rows must
    stay masked (they used to be treated as real documents and could reach
    the docnos lookup)."""
    from cunvsm.models.params import ModelParams
    from cunvsm.query.engine import QueryEngine

    rng = np.random.RandomState(6)
    num_words, num_docs, d_w, d_e = 40, 61, 8, 8  # 61 % 8 != 0 -> padding
    params = ModelParams(
        word_reprs=jnp.asarray(rng.randn(num_words, d_w), jnp.float32),
        # Strongly negative embeddings make every cosine negative, so a
        # zero pad row (score 0.0) would outrank every real document.
        entity_reprs=jnp.asarray(rng.randn(num_docs, d_e), jnp.float32),
        transform_w=jnp.asarray(rng.randn(d_w, d_e), jnp.float32),
        transform_b=jnp.asarray(rng.randn(d_e), jnp.float32),
    )
    terms = [f"t{i}" for i in range(num_words)]
    docnos = [f"d{i}" for i in range(num_docs)]
    queries = {str(q): [f"t{t}" for t in rng.randint(0, num_words, 3)]
               for q in range(4)}

    dense = QueryEngine(params, terms, docnos, nonlinearity=None)
    sharded = QueryEngine(
        params, terms, docnos, nonlinearity=None, mesh=make_mesh(1, 8)
    )
    for top_k in (50, 61, 10):
        run_a = dense.rank(queries, top_k=top_k)
        run_b = sharded.rank(queries, top_k=top_k)
        for qid in run_a:
            assert [d for d, _ in run_a[qid]] == [d for d, _ in run_b[qid]]


# ---------------------------------------------------------------------------
# Training-step communication volume (VERDICT r2 #2 / SURVEY §7 hazard).
# ---------------------------------------------------------------------------


def _train_step_hlo(pool, big=True, stream_dtype="float32"):
    """Compile the sharded train step at realistic-RATIO shapes and return
    (hlo_text, dims).  Shapes are chosen so the failure modes are separated
    by orders of magnitude: entity table D*d_e >> word stream B*W*d_w >
    entity stream B*(k+1)*d_e > word table V*d_w."""
    import dataclasses

    from cunvsm.config import Nonlinearity

    D, V, d_e, d_w, B_, W_, k = 8192, 128, 32, 16, 256, 8, 6
    desc = ModelDesc(
        word_repr_size=d_w, entity_repr_size=d_e,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=B_, window_size=W_, num_random_entities=k,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        uniform_feature_weights=True,
        negative_pool_size=pool,
        stream_dtype=stream_dtype,
        window_sum_dtype=stream_dtype,
    )
    params = init_params(jax.random.PRNGKey(0), V, D, desc)
    opt = Optimizer(cfg)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    batch = obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, V, (B_, W_)), jnp.int32),
        feature_weights=jnp.ones((B_, W_), jnp.float32),
        labels=jnp.asarray(rng.randint(0, D, (B_,)), jnp.int32),
        weights=jnp.ones((B_,), jnp.float32),
    )
    mesh = make_mesh(2, 4)
    step, p_s, o_s = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch, num_entities=D
    )
    lowered = step.lower(p_s, o_s, batch, jax.random.PRNGKey(0))
    hlo = lowered.compile().as_text()
    dims = dict(D=D, V=V, d_e=d_e, d_w=d_w, B=B_, W=W_, k=k, pool=pool)
    return hlo, dims, lowered.as_text()


def test_sharded_train_step_comm_volume_pooled():
    """Pooled mode on the 2x4 mesh: entity traffic is O(B + P) rows, the
    word accumulation syncs as one [V, d_w] table psum (the shard_mapped
    path in optim.updates._data_sharded_accumulate), and nothing
    all-reduces the B*W word-gradient stream or materializes/moves the
    model-sharded entity table.  This is the regression test for GSPMD's
    replicate-on-unpartitionable fallback: before round 3 the global
    accumulation sort made GSPMD all-reduce the full update stream
    (614 MB/step at canonical shapes)."""
    from cunvsm.parallel import audit

    hlo, s, _ = _train_step_hlo(pool=64)
    cs = audit.collectives(hlo)
    assert cs, "expected collectives on a 2x4 mesh"

    # (a) No collective anywhere near the entity table or its moments.
    table_bytes = s["D"] * s["d_e"] * 4
    assert audit.max_collective_bytes(hlo) < table_bytes // 4, (
        audit.format_table(hlo)
    )
    # (b) The word-gradient stream (B*W rows) is never moved as a stream:
    #     no collective result part has a stream-length leading dim.
    for c in cs:
        for dt, dims, nbytes in c.parts:
            assert not (dims and dims[0] >= s["B"] * s["W"]), (
                c, audit.format_table(hlo)
            )
    # (c) The full entity table never exists on any device.
    assert f"f32[{s['D']},{s['d_e']}]" not in hlo
    # (c2) The projections are never all-gathered (round 4: the
    #     contiguous-block residue assignment makes the residue-major
    #     view a plain reshape of the sharded batch axis, so the pool
    #     GEMMs shard over residues; before, GSPMD replicated the full
    #     [B, d_e] projections — 104.9 MB/step at canonical shapes).
    for c in cs:
        for dt, dims, _ in c.parts:
            assert tuple(dims) != (s["B"], s["d_e"]), (
                c.op, audit.format_table(hlo)
            )
    # (d) Entity traffic is bounded by the (B + P) gathered/updated rows
    #     (plus the P*k pool-window gradients), not by D and not by B*k
    #     replicated: the largest single collective is at most the
    #     pool-window gradient tensor.
    budget = max(
        (s["B"] + s["pool"] + 64) * s["d_e"],  # entity row stream + slack
        s["pool"] * s["k"] * s["d_e"],         # pool window gradients
    ) * 4 + 4096  # small tensors fused into the same tuple all-reduce
    assert audit.max_collective_bytes(hlo) <= budget, audit.format_table(hlo)


def test_sharded_train_step_comm_volume_per_instance():
    """Per-instance sampling: the entity-side stream is inherently
    B*(k+1) rows; assert the collectives stay bounded by that stream (no
    table-sized replication), which documents why mesh training defaults
    to the pooled layout."""
    from cunvsm.parallel import audit

    hlo, s, _ = _train_step_hlo(pool=0)
    table_bytes = s["D"] * s["d_e"] * 4
    assert audit.max_collective_bytes(hlo) < table_bytes // 4, (
        audit.format_table(hlo)
    )
    assert f"f32[{s['D']},{s['d_e']}]" not in hlo
    # Word-side: the B*W*d_w stream must not be all-reduced (the
    # shard_mapped accumulation applies to every sampling mode): no
    # collective result part has a word-stream-length leading dim wider
    # than the scalar sort keys.
    word_ops = [
        (c, part)
        for c in audit.collectives(hlo)
        for part in c.parts
        if part[1] and part[1][0] >= s["B"] * s["W"] and len(part[1]) > 1
    ]
    assert not word_ops, audit.format_table(hlo)


def test_device_sampled_sharded_comm_volume():
    """The FLAGSHIP multi-chip path — on-device sampling, sharded multistep
    (data/device_sampler.py) — must route the word-gradient accumulation
    through the shard_mapped path exactly like the host-fed sharded step.
    Round-4 regression: the multistep built its train step WITHOUT mesh=,
    so GSPMD's replicate-on-unpartitionable fallback all-reduced the full
    f32[B*W, d_w] word update stream (~614 MB/step at canonical shapes)
    while the dryrun stayed green (it asserted only cost finiteness and
    sharding specs).  Asserts on the compiled HLO of the very program
    `scripts/e2e_throughput.py --mesh` measures."""
    from cunvsm.config import Nonlinearity
    from cunvsm.data.device_sampler import (
        make_device_sampled_sharded_multistep,
        make_epoch_permuter,
        prepare_device_corpus,
    )
    from cunvsm.data.synth import uniform_corpus
    from cunvsm.parallel import audit

    D, V, d_e, d_w, B_, W_, k = 8192, 128, 32, 16, 256, 8, 6
    desc = ModelDesc(
        word_repr_size=d_w, entity_repr_size=d_e,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=B_, window_size=W_, num_random_entities=k,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        uniform_feature_weights=True,
        negative_pool_size=64,
    )
    corpus = uniform_corpus(D, 24, V, window_size=W_, seed=5)
    dc = prepare_device_corpus(corpus)
    params = init_params(jax.random.PRNGKey(0), V, D, desc)
    opt = Optimizer(cfg)
    opt_state = opt.init(params)
    mesh = make_mesh(2, 4)
    runner, p_s, o_s = make_device_sampled_sharded_multistep(
        desc, cfg, dc, 2, mesh, params, opt_state,
        num_entities=D, epoch_exact=True,
    )
    permuter, _ = make_epoch_permuter(dc)
    perm = permuter(jax.random.PRNGKey(1))
    hlo = runner.lower(
        p_s, o_s, jax.random.PRNGKey(0), perm, 0
    ).compile().as_text()
    cs = audit.collectives(hlo)
    assert cs, "expected collectives on a 2x4 mesh"

    # (a) The word-gradient stream (B*W rows per step) is never moved as a
    #     stream: no collective result part has a stream-length leading
    #     dim.  This is the assert that is RED without mesh= (the compiled
    #     HLO then contains `all-reduce f32[B*W, d_w]`).
    for c in cs:
        for dt, dims, nbytes in c.parts:
            assert not (dims and dims[0] >= B_ * W_), (
                c, audit.format_table(hlo)
            )
    # (b) No collective anywhere near the entity table or its moments.
    table_bytes = D * d_e * 4
    assert audit.max_collective_bytes(hlo) < table_bytes // 4, (
        audit.format_table(hlo)
    )
    # (c) The full entity table never exists on any device.
    assert f"f32[{D},{d_e}]" not in hlo


def test_device_sampled_sharded_rejects_bad_divisibility():
    """Batch not divisible by the total device count fails fast with a
    clear message (the shard_mapped accumulation requirement), not deep
    inside shard_map tracing."""
    from cunvsm.data.device_sampler import (
        make_device_sampled_sharded_multistep,
        prepare_device_corpus,
    )
    from cunvsm.data.synth import uniform_corpus

    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        batch_size=36,  # 36 % 8 != 0
        window_size=4, num_random_entities=2,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
    )
    corpus = uniform_corpus(30, 12, 40, window_size=4, seed=6)
    dc = prepare_device_corpus(corpus)
    params = init_params(jax.random.PRNGKey(0), 40, 30, desc)
    opt = Optimizer(cfg)
    opt_state = opt.init(params)
    mesh = make_mesh(1, 8)
    with pytest.raises(ValueError, match="not divisible by the total"):
        make_device_sampled_sharded_multistep(
            desc, cfg, dc, 2, mesh, params, opt_state,
            num_entities=30,
        )


def _make_sim_batch(num_ids, seed=3):
    rng = np.random.RandomState(seed)
    return obj.SimilarityBatch(
        ids=jnp.asarray(rng.randint(0, num_ids, (B, 2)), jnp.int32),
        weights=jnp.asarray(rng.rand(B).astype(np.float32) + 0.5),
    )


@pytest.mark.parametrize(
    "kind,method",
    [
        ("text_entity_entity_entity", UpdateMethod.ADAM),
        ("text_entity_entity_entity", UpdateMethod.SGD),
        ("text_entity_term_term", UpdateMethod.ADAM),
        ("text_entity_term_term", UpdateMethod.SGD),
    ],
)
def test_sharded_composite_matches_single_device(kind, method):
    """Mix 'n Match composites under a mesh: the similarity stream's
    descriptors scatter into the *model-sharded* entity table (EE) or ride
    the shard_mapped word accumulation (TT) — both must reproduce the
    single-device step bit-for-float (objective.cu:698-794 semantics)."""
    import dataclasses

    from cunvsm.train.step import ObjectiveKind

    okind = ObjectiveKind(kind)
    desc, cfg, params, opt_state = make_setup(method)
    if okind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        cfg = dataclasses.replace(
            cfg, text_entity_weight=0.7, entity_entity_weight=0.3
        )
        sim = _make_sim_batch(NUM_ENTITIES)
    else:
        cfg = dataclasses.replace(
            cfg, text_entity_weight=0.6, term_term_weight=0.4
        )
        sim = _make_sim_batch(NUM_WORDS)
    batch = (make_batch(), sim)
    key = jax.random.PRNGKey(9)

    single = make_train_step(desc, cfg, okind, jit=False)
    p_ref, _, cost_ref = single(params, opt_state, batch, key)

    mesh = make_mesh(2, 4)
    step, p_sh, o_sh = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch, kind=okind
    )
    p_out, o_out, cost = step(p_sh, o_sh, batch, key)

    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(p_out.entity_reprs), np.asarray(p_ref.entity_reprs),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(p_out.word_reprs), np.asarray(p_ref.word_reprs),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(p_out.transform_w), np.asarray(p_ref.transform_w),
        rtol=1e-5, atol=1e-7,
    )


@pytest.mark.parametrize("kind", [
    "text_entity_entity_entity", "text_entity_term_term",
])
def test_sharded_composite_comm_volume(kind):
    """The composite similarity stream must not trip GSPMD's
    replicate-on-unpartitionable fallback: the EE stream scatters into the
    model-sharded entity table and the TT stream joins the shard_mapped
    word accumulation — in both cases collectives stay bounded by streams
    and the [V, d_w] word psum, never the B*W update stream or a
    table-sized all-gather (the SURVEY §7 hazard class that bit the
    host-fed path in round 3 and the device-sampled path in round 4)."""
    import dataclasses

    from cunvsm.config import Nonlinearity
    from cunvsm.parallel import audit
    from cunvsm.train.step import ObjectiveKind

    okind = ObjectiveKind(kind)
    D, V, d_e, d_w, B_, W_, k = 8192, 128, 32, 16, 256, 8, 6
    desc = ModelDesc(
        word_repr_size=d_w, entity_repr_size=d_e,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=B_, window_size=W_, num_random_entities=k,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        uniform_feature_weights=True,
        text_entity_weight=0.5,
        entity_entity_weight=(
            0.5 if okind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY else 0.0
        ),
        term_term_weight=(
            0.5 if okind == ObjectiveKind.TEXT_ENTITY_TERM_TERM else 0.0
        ),
    )
    params = init_params(jax.random.PRNGKey(0), V, D, desc)
    opt = Optimizer(cfg)
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    te = obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, V, (B_, W_)), jnp.int32),
        feature_weights=jnp.ones((B_, W_), jnp.float32),
        labels=jnp.asarray(rng.randint(0, D, (B_,)), jnp.int32),
        weights=jnp.ones((B_,), jnp.float32),
    )
    sim_range = D if okind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY else V
    sim = obj.SimilarityBatch(
        ids=jnp.asarray(rng.randint(0, sim_range, (B_, 2)), jnp.int32),
        weights=jnp.ones((B_,), jnp.float32),
    )
    batch = (te, sim)
    mesh = make_mesh(2, 4)
    step, p_s, o_s = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batch, kind=okind,
        num_entities=D,
    )
    hlo = step.lower(p_s, o_s, batch, jax.random.PRNGKey(0)).compile().as_text()
    cs = audit.collectives(hlo)
    assert cs, "expected collectives on a 2x4 mesh"

    # (a) Neither update stream is ever moved as a stream.
    for c in cs:
        for dt, dims, nbytes in c.parts:
            assert not (dims and dims[0] >= B_ * W_), (
                c, audit.format_table(hlo)
            )
    # (b) No table-scale collective: the entity table (and its dense
    #     moments) stay sharded.
    table_bytes = D * d_e * 4
    assert audit.max_collective_bytes(hlo) < table_bytes // 4, (
        audit.format_table(hlo)
    )
    # (c) The full entity table never exists on any device.
    assert f"f32[{D},{d_e}]" not in hlo


# ---------------------------------------------------------------------------
# Data-axis-sharded device corpus (multi-card memory).
# ---------------------------------------------------------------------------


def _sharded_corpus_setup(num_docs=64, doc_len=20, vocab=128, window=5):
    from cunvsm.data.device_sampler import prepare_sharded_device_corpus
    from cunvsm.data.synth import uniform_corpus

    corpus = uniform_corpus(num_docs, doc_len, vocab, window_size=window,
                            seed=0)
    mesh = make_mesh(2, 4)
    return corpus, mesh, prepare_sharded_device_corpus(corpus, mesh)


def test_sharded_corpus_sampling_is_valid_and_epoch_exact():
    """Every sampled window is a real window of its labeled document
    (global ids), and one epoch's pointer consumption gives every eligible
    document exactly samples_per_doc instances (the per-group shuffle
    preserves the reference's per-doc counts, data_indri.cpp:337-344)."""
    import math

    from cunvsm.data.device_sampler import (
        _make_sharded_sampler,
        make_sharded_epoch_permuter,
    )

    corpus, mesh, sdc = _sharded_corpus_setup()
    W_c = corpus.window_size
    permute, ptrs_per_epoch = make_sharded_epoch_permuter(sdc, mesh)
    perm = permute(jax.random.PRNGKey(5))
    sampler, b_local = _make_sharded_sampler(
        sdc._replace(local_pointers=perm), mesh, 64
    )
    samp = jax.jit(lambda k, c: sampler(k, c))

    counts = np.zeros(corpus.num_docs, np.int64)
    first = None
    for s in range(ptrs_per_epoch // 64):
        b = samp(jax.random.fold_in(jax.random.PRNGKey(9), s),
                 jnp.int32(s * b_local))
        if first is None:
            first = b
        counts += np.bincount(np.asarray(b.labels),
                              minlength=corpus.num_docs)
    spd = max(int(math.ceil(float(corpus.doc_lengths.mean()) - W_c + 1)), 1)
    np.testing.assert_array_equal(counts, np.full(corpus.num_docs, spd))

    f = np.asarray(first.features)
    lab = np.asarray(first.labels)
    for i in range(len(lab)):
        d = int(lab[i])
        start = corpus.doc_offsets[d]
        L = corpus.doc_lengths[d]
        doc_tokens = corpus.tokens[start:start + L]
        assert any(
            np.array_equal(doc_tokens[p:p + W_c], f[i])
            for p in range(L - W_c + 1)
        ), (d, f[i])


def test_sharded_corpus_no_replicated_token_array():
    """The whole point of ShardedDeviceCorpus: the compiled multistep must
    hold only the LOCAL token shard per device (closure capture would bake
    the full array in as a replicated constant — the bug this test caught
    during development) and no collective may carry token data."""
    import re

    from cunvsm.config import Nonlinearity
    from cunvsm.data.device_sampler import (
        make_corpus_sharded_multistep,
        make_sharded_epoch_permuter,
    )
    from cunvsm.parallel import audit

    corpus, mesh, sdc = _sharded_corpus_setup(
        num_docs=1024, doc_len=24, vocab=128
    )
    desc = ModelDesc(word_repr_size=16, entity_repr_size=16,
                     nonlinearity=Nonlinearity.HARD_TANH,
                     batch_normalization=True)
    cfg = TrainConfig(
        batch_size=256, window_size=5, num_random_entities=3,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
    )
    params = init_params(jax.random.PRNGKey(0), 128, corpus.num_docs, desc)
    opt = Optimizer(cfg)
    runner, p, o = make_corpus_sharded_multistep(
        desc, cfg, sdc, 2, mesh, params, opt.init(params),
        num_entities=corpus.num_docs,
    )
    permute, _ = make_sharded_epoch_permuter(sdc, mesh)
    perm = permute(jax.random.PRNGKey(5))
    hlo = runner.lower(p, o, jax.random.PRNGKey(1), perm, 0).compile().as_text()

    S, rows, gg = sdc.tokens_wide.shape
    token_shapes = set(re.findall(r"u16\[([\d,]+)\]", hlo))
    assert not any(s.startswith(f"{S},") for s in token_shapes), (
        sorted(token_shapes)
    )
    for c in audit.collectives(hlo):
        assert c.dtype not in ("u16", "s16"), c
        # No stream-size or table-size fallbacks either.
        for _, dims, _ in c.parts:
            assert not (dims and dims[0] >= cfg.batch_size * cfg.window_size)

    # Executes and returns finite costs.
    p2, o2, costs = runner(p, o, jax.random.PRNGKey(1), perm, 0)
    assert np.all(np.isfinite(np.asarray(costs)))

    # Per-device memory: the token arrays enter as arguments, so the
    # compiled per-device argument bytes must reflect the SHARD, not the
    # corpus — compare against the replicated-corpus multistep at the
    # same shapes (same params/opt-state/batch sizes).
    from cunvsm.data.device_sampler import (
        make_device_sampled_sharded_multistep,
        make_epoch_permuter,
        prepare_device_corpus,
    )

    sharded_args = runner.lower(
        p2, o2, jax.random.PRNGKey(1), perm, 0
    ).compile().memory_analysis().argument_size_in_bytes
    dc = prepare_device_corpus(corpus)
    params2 = init_params(jax.random.PRNGKey(0), 128, corpus.num_docs, desc)
    repl_runner, rp, ro = make_device_sampled_sharded_multistep(
        desc, cfg, dc, 2, mesh, params2, opt.init(params2),
        num_entities=corpus.num_docs,
    )
    permuter_r, _ = make_epoch_permuter(dc)
    repl_args = repl_runner.lower(
        rp, ro, jax.random.PRNGKey(1), permuter_r(jax.random.PRNGKey(5)), 0
    ).compile().memory_analysis().argument_size_in_bytes
    # The replicated path embeds its corpus as closure constants (not
    # arguments), so compare absolute budgets instead: the sharded path's
    # arguments = params/opt/perm + its LOCAL token shard only.
    local_token_bytes = int(
        sdc.tokens_wide.shape[1] * sdc.tokens_wide.shape[2] * 2
    )
    assert sharded_args <= repl_args + 2 * local_token_bytes + (
        sdc.doc_meta.shape[1] * 3 * 4 + sdc.local_pointers.shape[1] * 4
    ), (sharded_args, repl_args, local_token_bytes)


def test_trainer_shard_corpus_end_to_end():
    import dataclasses

    from cunvsm.config import Nonlinearity
    from cunvsm.data.synth import uniform_corpus
    from cunvsm.train.trainer import train_model

    desc = ModelDesc(word_repr_size=16, entity_repr_size=16,
                     nonlinearity=Nonlinearity.HARD_TANH,
                     batch_normalization=True)
    cfg = TrainConfig(
        batch_size=64, window_size=5, num_random_entities=3,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2, seed=1,
        num_epochs=2,
    )
    corpus = uniform_corpus(64, 20, 128, window_size=5, seed=0)
    mesh = make_mesh(2, 4)
    res = train_model(desc, cfg, corpus, mesh=mesh, on_device_sampling=True,
                      shard_corpus=True, steps_per_call=4)
    assert len(res.epoch_costs) == 2
    assert all(np.isfinite(c) for c in res.epoch_costs)
    # shard_corpus without a mesh is rejected.
    with pytest.raises(ValueError, match="shard_corpus requires a mesh"):
        train_model(desc, cfg, corpus, on_device_sampling=True,
                    shard_corpus=True)


def test_sharded_word_psum_bf16_under_bf16_streams():
    """cross_chip_reduce_dtype auto: with bfloat16 streams the [V, d_w]
    word-gradient psum — the largest per-step collective (PERFORMANCE.md
    comm table) — crosses the interconnect at bf16, halving it; per-chip
    partial accumulation stays full-width (the cast sits between the
    local dense reduce and the all-reduce).

    Asserted on the LOWERED (pre-backend) module: the CPU backend used by
    the test mesh emulates bf16 by widening — its compiled HLO shows an
    f32 all-reduce of converted values — while the GPU backend keeps bf16
    collectives on the wire; the StableHLO all_reduce element type is the
    platform-neutral statement of what the GPU moves."""
    import re

    def word_reduce_types(low, s):
        """Element types of all_reduce ops over the [V, d_w] word table in
        the lowered module (the all_reduce signature repeats the tensor
        type as `(tensor<VxDxT>) -> tensor<VxDxT>` within a few lines of
        the op)."""
        sig = rf"\(tensor<{s['V']}x{s['d_w']}x(\w+)>\)\s*->"
        out = []
        lines = low.splitlines()
        for i, line in enumerate(lines):
            if "stablehlo.all_reduce" not in line:
                continue
            window = "\n".join(lines[i : i + 7])
            m = re.search(sig, window)
            if m:
                out.append(m.group(1))
        return out

    _, s, low = _train_step_hlo(pool=64, stream_dtype="bfloat16")
    assert word_reduce_types(low, s) == ["bf16"], word_reduce_types(low, s)
    # f32 default: the same psum stays full-width.
    _, _, low32 = _train_step_hlo(pool=64, stream_dtype="float32")
    assert word_reduce_types(low32, s) == ["f32"]


def test_bf16_cross_chip_reduce_numerics():
    """One sharded step with the bf16 cross-chip reduce stays within bf16
    rounding of the f32-reduce sharded step (same seed, same batch)."""
    import dataclasses

    from cunvsm.config import Nonlinearity

    D, V, d_e, d_w, B_, W_, k = 256, 64, 8, 8, 64, 4, 2
    desc = ModelDesc(
        word_repr_size=d_w, entity_repr_size=d_e,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    base = dict(
        batch_size=B_, window_size=W_, num_random_entities=k,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        uniform_feature_weights=True, negative_pool_size=16,
        stream_dtype="bfloat16",
    )
    rng = np.random.RandomState(0)
    batch = obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, V, (B_, W_)), jnp.int32),
        feature_weights=jnp.ones((B_, W_), jnp.float32),
        labels=jnp.asarray(rng.randint(0, D, (B_,)), jnp.int32),
        weights=jnp.ones((B_,), jnp.float32),
    )
    mesh = make_mesh(2, 4)
    results = {}
    for reduce_dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(**base, cross_chip_reduce_dtype=reduce_dtype)
        params = init_params(
            jax.random.PRNGKey(0), V, D, desc, dtype=jnp.float32
        )
        opt = Optimizer(cfg)
        opt_state = opt.init(params)
        step, p_s, o_s = make_sharded_train_step(
            desc, cfg, mesh, params, opt_state, batch, num_entities=D
        )
        p, o, c = step(p_s, o_s, batch, jax.random.PRNGKey(1))
        results[reduce_dtype] = (
            np.asarray(p.word_reprs), float(c)
        )
    w32, c32 = results["float32"]
    wb, cb = results["bfloat16"]
    assert np.isfinite(cb) and abs(cb - c32) < 1e-5  # forward unchanged
    # Word rows move by ~lr (1e-3) per Adam step; the bf16 reduce rounds
    # the gradient by 2^-8 relative, which Adam's 1/sqrt(v) amplifies a
    # few-fold on the first step (v is built from the same rounded
    # gradient) — measured ~4e-5 absolute here.  Quality-level validation
    # is the Cranfield mesh spot check (PERFORMANCE.md).
    np.testing.assert_allclose(wb, w32, atol=1e-4)
