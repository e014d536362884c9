"""On-device sampling tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.data.device_sampler import (
    make_device_sampled_multistep,
    prepare_device_corpus,
    sample_batch,
)
from cunvsm.data.instances import FeatureWeighting, Weighting
from cunvsm.models.params import init_params
from cunvsm.optim.updates import Optimizer


def corpus():
    docs = [
        ("d0", "a b c d e f g h"),
        ("d1", "i j"),  # too short for window 3 after packing
        ("d2", "k l m n o"),
    ]
    return build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )


class TestSampleBatch:
    def test_windows_valid(self):
        c = corpus()
        dc = prepare_device_corpus(c)
        batch = jax.jit(
            lambda k: sample_batch(dc, k, 64)
        )(jax.random.PRNGKey(0))
        feats = np.asarray(batch.features)
        labels = np.asarray(batch.labels)
        assert feats.shape == (64, 3)
        # Every window is a contiguous in-document slice.
        for i in range(64):
            lo = c.doc_offsets[labels[i]]
            hi = c.doc_offsets[labels[i] + 1]
            toks = c.tokens[lo:hi]
            assert any(
                np.array_equal(toks[p : p + 3], feats[i])
                for p in range(len(toks) - 2)
            )
        # d1 dropped at corpus build (len < window) — labels only 0/1
        # over the kept docs, all eligible.
        assert set(np.unique(labels)) <= {0, 1}

    def test_wide_row_fetch_matches_column_gathers(self):
        # The per-row-rate-optimized wide-row window fetch must produce
        # byte-identical features to the W-column-gather fallback for
        # every window position, including doc boundaries and the corpus
        # tail.
        rng = np.random.RandomState(7)
        lens = rng.randint(6, 40, 50)
        docs = [
            (f"d{i}", " ".join(f"w{rng.randint(0, 200)}" for _ in range(n)))
            for i, n in enumerate(lens)
        ]
        c = build_corpus(
            docs,
            DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                       max_document_frequency=0),
            window_size=6,
        )
        dc = prepare_device_corpus(
            c, feature_weighting=FeatureWeighting.SELF_INFORMATION
        )
        assert dc.tokens_wide is not None
        assert dc.term_weights_wide is not None
        dc_fallback = dc._replace(
            tokens_wide=None, term_weights_wide=None
        )
        for seed in range(4):
            k = jax.random.PRNGKey(seed)
            wide = sample_batch(dc, k, 256)
            cols = sample_batch(dc_fallback, k, 256)
            np.testing.assert_array_equal(
                np.asarray(wide.features), np.asarray(cols.features)
            )
            np.testing.assert_array_equal(
                np.asarray(wide.labels), np.asarray(cols.labels)
            )
            # SELF_INFORMATION weights through the shared row fetch must
            # match the per-element table take bit for bit.
            np.testing.assert_array_equal(
                np.asarray(wide.feature_weights),
                np.asarray(cols.feature_weights),
            )

    def test_wide_rows_cover_every_offset(self):
        # Deterministic sweep: every (row offset mod G) x window position
        # combination resolves to the right tokens.
        from cunvsm.data.device_sampler import WIDE_ROW_STRIDE

        n_tokens = 5 * WIDE_ROW_STRIDE + 3
        toks = " ".join(f"w{i}" for i in range(n_tokens))
        c = build_corpus(
            [("d0", toks)],
            DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                       max_document_frequency=0),
            window_size=4,
        )
        dc = prepare_device_corpus(c)
        max_pos = n_tokens - 4 + 1
        docs = jnp.zeros((max_pos,), jnp.int32)
        # Drive positions directly through a patched uniform draw: feed
        # each start position once via the docs override + a key sweep is
        # stochastic, so instead index tokens_wide by hand.
        g = WIDE_ROW_STRIDE
        wide = np.asarray(dc.tokens_wide)
        flat = np.asarray(dc.tokens)
        for p in range(max_pos):
            row, off = divmod(p, g)
            np.testing.assert_array_equal(
                wide[row, off : off + 4], flat[p : p + 4]
            )

    def test_inv_doc_frequency_weights(self):
        c = corpus()
        dc = prepare_device_corpus(c, weighting=Weighting.INV_DOC_FREQUENCY)
        batch = sample_batch(dc, jax.random.PRNGKey(1), 128)
        lengths = c.doc_lengths
        avg = lengths.mean()
        w = np.asarray(batch.weights)
        labels = np.asarray(batch.labels)
        np.testing.assert_allclose(
            w, (avg / lengths[labels]).astype(np.float32), rtol=1e-6
        )

    def test_self_information_features(self):
        c = corpus()
        dc = prepare_device_corpus(
            c, feature_weighting=FeatureWeighting.SELF_INFORMATION
        )
        batch = sample_batch(dc, jax.random.PRNGKey(2), 32)
        si = c.vocab.self_information().astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(batch.feature_weights),
            si[np.asarray(batch.features)],
            rtol=1e-6,
        )


class TestDeviceSampledTraining:
    def test_multistep_trains(self):
        c = corpus()
        dc = prepare_device_corpus(c)
        desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
        cfg = TrainConfig(
            batch_size=32, window_size=3, num_random_entities=2,
            learning_rate=0.05,
        )
        params = init_params(
            jax.random.PRNGKey(0), c.vocab.size, c.num_docs, desc
        )
        opt_state = Optimizer(cfg).init(params)
        run = make_device_sampled_multistep(
            desc, cfg, dc, num_steps=20, epoch_exact=False
        )
        params, opt_state, costs = run(
            params, opt_state, jax.random.PRNGKey(1)
        )
        costs = np.asarray(costs)
        assert np.all(np.isfinite(costs))
        params, opt_state, costs2 = run(
            params, opt_state, jax.random.PRNGKey(2)
        )
        assert np.asarray(costs2).mean() < costs.mean()  # it learns


def test_trainer_on_device_sampling(tmp_path):
    from cunvsm.train.trainer import train_model

    c = corpus()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(
        num_epochs=3, batch_size=32, window_size=3, num_random_entities=2,
        learning_rate=0.05,
    )
    prefix = str(tmp_path / "m")
    r = train_model(
        desc, cfg, c, output_prefix=prefix,
        on_device_sampling=True, steps_per_call=2,
    )
    assert len(r.epoch_costs) == 3
    assert all(np.isfinite(x) for x in r.epoch_costs)
    assert r.epoch_costs[-1] < r.epoch_costs[0]
    import os
    assert os.path.exists(f"{prefix}_3.hdf5")


def test_trainer_mesh_with_on_device_sampling():
    from cunvsm.parallel.mesh import make_mesh
    from cunvsm.train.trainer import train_model

    c = corpus()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        num_epochs=2, batch_size=16, window_size=3, num_random_entities=2,
        learning_rate=0.05,
    )
    mesh = make_mesh(2, 4)
    r = train_model(
        desc, cfg, c, mesh=mesh, on_device_sampling=True, steps_per_call=2
    )
    assert r.params.entity_reprs.shape[0] == c.num_docs
    assert all(np.isfinite(x) for x in r.epoch_costs)


def test_trainer_mesh_on_device_sampling_remainder_call(caplog):
    # Non-dividing steps_per_call on a mesh: the epoch remainder runs
    # through a second sharded compiled call (already-sharded params fed
    # back through make_device_sampled_sharded_multistep).
    import logging

    from cunvsm.parallel.mesh import make_mesh
    from cunvsm.train.trainer import train_model

    rng = np.random.RandomState(11)
    docs = [
        (f"d{i}", " ".join(f"w{rng.randint(0, 60)}" for _ in range(n)))
        for i, n in enumerate(rng.randint(8, 30, 40))
    ]
    c = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=8)
    cfg = TrainConfig(
        num_epochs=1, batch_size=16, window_size=4, num_random_entities=2,
        learning_rate=0.05,
    )
    mesh = make_mesh(2, 4)
    with caplog.at_level(logging.INFO, logger="cunvsm.train.trainer"):
        r = train_model(
            desc, cfg, c, mesh=mesh, on_device_sampling=True,
            steps_per_call=7,
        )
    assert any(
        "remainder steps run as one extra compiled call" in m
        for m in caplog.messages
    ), "fixture must produce a non-dividing epoch step count"
    assert all(np.isfinite(x) for x in r.epoch_costs)


class TestEpochExact:
    def test_epoch_doc_pointers_counts(self):
        """Every eligible doc appears exactly samples_per_doc times
        (data_indri.cpp:337-344)."""
        import math

        from cunvsm.data.device_sampler import epoch_doc_pointers

        c = corpus()
        dc = prepare_device_corpus(c)
        ptrs = np.asarray(epoch_doc_pointers(dc))
        eligible = np.asarray(dc.eligible)
        lengths = np.asarray(dc.doc_lengths)[eligible]
        s = max(int(math.ceil(lengths.mean() - dc.window_size + 1)), 1)
        ids, counts = np.unique(ptrs, return_counts=True)
        assert set(ids.tolist()) == set(eligible.tolist())
        assert np.all(counts == s)

    def test_epoch_exact_multistep_consumes_permutation(self):
        """Scanned steps consume consecutive slices of the shuffled pointer
        array: over one epoch every document is trained exactly its quota."""
        from cunvsm.data.device_sampler import make_epoch_permuter

        c = corpus()
        dc = prepare_device_corpus(c)
        permute, n_ptrs = make_epoch_permuter(dc)
        perm = permute(jax.random.PRNGKey(3))
        assert perm.shape == (n_ptrs, 3)
        # The permutation is a rearrangement of the pointer-meta multiset:
        # doc ids in column 0, each row carrying that doc's (offset, length).
        from cunvsm.data.device_sampler import epoch_doc_pointers

        np.testing.assert_array_equal(
            np.sort(np.asarray(perm[:, 0])),
            np.sort(np.asarray(epoch_doc_pointers(dc))),
        )
        meta = np.asarray(dc.doc_meta)
        np.testing.assert_array_equal(
            np.asarray(perm)[:, 1:], meta[np.asarray(perm)[:, 0]]
        )

        cfg = TrainConfig(batch_size=2, window_size=3, num_random_entities=1)
        desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
        params = init_params(
            jax.random.PRNGKey(0), c.vocab.size, c.num_docs, desc
        )
        opt_state = Optimizer(cfg).init(params)
        steps = n_ptrs // cfg.batch_size
        run = make_device_sampled_multistep(
            desc, cfg, dc, steps, epoch_exact=True
        )
        params, opt_state, costs = run(
            params, opt_state, jax.random.PRNGKey(1), perm, 0
        )
        assert costs.shape == (steps,)
        assert np.all(np.isfinite(np.asarray(costs)))

    def test_packed_meta_permutation_matches_bare_id_shuffle(self):
        """The [n,3] pointer-meta shuffle orders documents exactly like the
        round-4 bare-id shuffle (jax permutes 2-D rows by shuffling arange
        with the same stable sort keys), and a batch sampled through the
        packed rows is identical to one sampled through bare doc ids —
        the doc-meta-gather elimination is bit-neutral."""
        from cunvsm.data.device_sampler import (
            epoch_doc_pointers,
            make_epoch_permuter,
        )

        c = corpus()
        dc = prepare_device_corpus(c)
        permute, n_ptrs = make_epoch_permuter(dc)
        perm = np.asarray(permute(jax.random.PRNGKey(11)))
        legacy = np.asarray(
            jax.random.permutation(
                jax.random.PRNGKey(11), epoch_doc_pointers(dc)
            )
        )
        np.testing.assert_array_equal(perm[:, 0], legacy)

        b = 4
        packed = jnp.asarray(perm[:b])
        bare = jnp.asarray(perm[:b, 0])
        k = jax.random.PRNGKey(2)
        with_meta = jax.jit(lambda: sample_batch(dc, k, b, docs=packed))()
        with_gather = jax.jit(lambda: sample_batch(dc, k, b, docs=bare))()
        np.testing.assert_array_equal(
            np.asarray(with_meta.features), np.asarray(with_gather.features)
        )
        np.testing.assert_array_equal(
            np.asarray(with_meta.labels), np.asarray(with_gather.labels)
        )
        np.testing.assert_array_equal(
            np.asarray(with_meta.feature_weights),
            np.asarray(with_gather.feature_weights),
        )

    def test_exact_labels_match_slice(self):
        """The batch labels are exactly the cursor slice of the permutation
        (no resampling in exact mode)."""
        from cunvsm.data.device_sampler import make_epoch_permuter

        c = corpus()
        dc = prepare_device_corpus(c)
        permute, n_ptrs = make_epoch_permuter(dc)
        perm = permute(jax.random.PRNGKey(7))
        b = 3
        start = 2
        docs = jax.lax.dynamic_slice(perm, (start, 0), (b, 3))
        batch = jax.jit(
            lambda k: sample_batch(dc, k, b, docs=docs)
        )(jax.random.PRNGKey(0))
        np.testing.assert_array_equal(
            np.asarray(batch.labels), np.asarray(perm)[start:start + b, 0]
        )


def test_trainer_on_device_sampling_pooled_negatives(tmp_path):
    """The rolled-pool mode composes with the fully on-device path: the
    corpus lives in HBM, batches and the negative pool are sampled inside
    the compiled step."""
    import dataclasses

    from cunvsm.train.trainer import train_model

    c = corpus()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(
        num_epochs=3, batch_size=32, window_size=3, num_random_entities=2,
        learning_rate=0.05, negative_pool_size=8,
    )
    r = train_model(
        desc, cfg, c, output_prefix=str(tmp_path / "m"),
        on_device_sampling=True, steps_per_call=2,
    )
    assert all(np.isfinite(x) for x in r.epoch_costs)
    assert r.epoch_costs[-1] < r.epoch_costs[0]


def test_trainer_host_path_pooled_negatives(tmp_path):
    from cunvsm.train.trainer import train_model

    c = corpus()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(
        num_epochs=3, batch_size=8, window_size=3, num_random_entities=2,
        learning_rate=0.05, negative_pool_size=8,
    )
    r = train_model(desc, cfg, c, output_prefix=str(tmp_path / "m"))
    assert all(np.isfinite(x) for x in r.epoch_costs)
    assert r.epoch_costs[-1] < r.epoch_costs[0]


class TestStratifiedPermuter:
    """make_stratified_epoch_permuter reproduces the shard_corpus epoch
    semantics (per-group shuffle, stratified batches) on one device."""

    def _dc(self):
        from cunvsm.data.synth import uniform_corpus

        c = uniform_corpus(24, 12, 50, window_size=3, seed=0)
        return prepare_device_corpus(c)

    def test_batches_stratified_and_counts_exact(self):
        import math

        from cunvsm.data.device_sampler import (
            _token_balanced_groups,
            make_stratified_epoch_permuter,
        )

        dc = self._dc()
        num_groups, batch = 4, 8
        b_local = batch // num_groups
        permute, n = make_stratified_epoch_permuter(dc, num_groups, batch)
        perm = np.asarray(permute(jax.random.PRNGKey(0)))
        assert len(perm) == n

        lengths = np.asarray(dc.doc_lengths)
        eligible = np.asarray(dc.eligible)
        groups = _token_balanced_groups(
            eligible, lengths[eligible], num_groups
        )
        group_of = {
            int(d): g for g, docs in enumerate(groups) for d in docs
        }
        # Every batch slice draws exactly b_local pointers per group.
        for s in range(0, n, batch):
            counts = np.bincount(
                [group_of[int(d)] for d in perm[s:s + batch]],
                minlength=num_groups,
            )
            assert (counts == b_local).all(), (s, counts)

        # Per-document sample counts: samples_per_doc for every eligible
        # document, plus only the documented wrap padding per group.
        spd = max(
            int(math.ceil(float(lengths[eligible].mean())
                          - dc.window_size + 1)),
            1,
        )
        cnt = np.bincount(perm, minlength=len(lengths))
        for g, docs in enumerate(groups):
            pad = n // num_groups - len(docs) * spd
            assert (cnt[docs] >= spd).all()
            assert cnt[docs].sum() == len(docs) * spd + pad

    def test_reshuffles_per_epoch_same_multiset(self):
        from cunvsm.data.device_sampler import (
            make_stratified_epoch_permuter,
        )

        dc = self._dc()
        permute, n = make_stratified_epoch_permuter(dc, 2, 8)
        a = np.asarray(permute(jax.random.PRNGKey(1)))
        b = np.asarray(permute(jax.random.PRNGKey(2)))
        assert not np.array_equal(a, b)
        assert np.array_equal(np.sort(a), np.sort(b))

    def test_batch_size_must_divide(self):
        from cunvsm.data.device_sampler import (
            make_stratified_epoch_permuter,
        )

        with pytest.raises(ValueError, match="not divisible"):
            make_stratified_epoch_permuter(self._dc(), 3, 8)


def test_trainer_stratified_groups(tmp_path):
    from cunvsm.data.synth import uniform_corpus
    from cunvsm.train.trainer import train_model

    c = uniform_corpus(24, 12, 50, window_size=3, seed=0)
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(
        num_epochs=2, batch_size=16, window_size=3, num_random_entities=2,
        learning_rate=0.05,
    )
    r = train_model(
        desc, cfg, c, on_device_sampling=True, steps_per_call=2,
        stratify_data_groups=4,
    )
    assert len(r.epoch_costs) == 2
    assert all(np.isfinite(x) for x in r.epoch_costs)

    with pytest.raises(ValueError, match="requires on_device_sampling"):
        train_model(desc, cfg, c, stratify_data_groups=4)
