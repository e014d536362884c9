"""Forward-pass tests against hand-computed values (model_tests.cu analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import ModelDesc, Nonlinearity
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams, init_params


def make_params(rng, num_words=7, num_entities=5, d_w=3, d_e=4):
    return ModelParams(
        word_reprs=jnp.asarray(rng.randn(num_words, d_w)),
        entity_reprs=jnp.asarray(rng.randn(num_entities, d_e)),
        transform_w=jnp.asarray(rng.randn(d_w, d_e)),
        transform_b=jnp.asarray(rng.randn(d_e)),
    )


class TestGatherPhraseReprs:
    def test_unweighted_average(self, rng):
        # model_tests.cu:52-123: gather/average kernel exact values.
        table = jnp.asarray(rng.randn(6, 3))
        feats = jnp.array([[0, 1], [2, 2]], dtype=jnp.int32)
        fw = jnp.ones((2, 2))
        out = obj.gather_phrase_reprs(table, feats, fw)
        want = np.stack(
            [
                (np.asarray(table)[0] + np.asarray(table)[1]) / 2.0,
                np.asarray(table)[2],
            ]
        )
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-12)

    def test_weighted_divides_by_window_not_weightsum(self, rng):
        # average_repr_kernel divides by window_size even when weighted
        # (params.cu:94).
        table = jnp.asarray(rng.randn(6, 3))
        feats = jnp.array([[0, 1]], dtype=jnp.int32)
        fw = jnp.array([[2.0, 4.0]])
        out = obj.gather_phrase_reprs(table, feats, fw)
        want = (2.0 * np.asarray(table)[0] + 4.0 * np.asarray(table)[1]) / 2.0
        np.testing.assert_allclose(np.asarray(out)[0], want, rtol=1e-12)


class TestNegativeSampling:
    def test_layout_positive_first(self, rng):
        # labels.cu:3-22: [pos, neg_1..neg_k] per instance.
        key = jax.random.PRNGKey(0)
        labels = jnp.array([3, 1, 4], dtype=jnp.int32)
        ids = obj.sample_negative_entities(key, labels, 5, 4)
        assert ids.shape == (3, 5)
        np.testing.assert_array_equal(np.asarray(ids[:, 0]), [3, 1, 4])
        assert np.all(np.asarray(ids) >= 0) and np.all(np.asarray(ids) < 5)


class TestNCEWeights:
    def test_bias_correction(self):
        # objective.cu:258-290: scale by (k+1)/(2k), positives x k.
        desc = ModelDesc(bias_negative_samples=False)
        w = jnp.array([1.0, 2.0])
        k = 4
        out = np.asarray(obj.nce_instance_weights(w, k, desc))
        np.testing.assert_allclose(out[0, 0], 1.0 * (5.0 / 8.0) * 4.0)
        np.testing.assert_allclose(out[0, 1:], np.full(4, 5.0 / 8.0))
        np.testing.assert_allclose(out[1, 0], 2.0 * (5.0 / 8.0) * 4.0)
        # Total mass per instance is preserved: (k+1) * w.
        np.testing.assert_allclose(out.sum(axis=1), [5.0, 10.0])

    def test_biased_mode_no_correction(self):
        desc = ModelDesc(bias_negative_samples=True)
        out = np.asarray(obj.nce_instance_weights(jnp.array([3.0]), 4, desc))
        np.testing.assert_allclose(out, np.full((1, 5), 3.0))

    def test_single_negative_no_correction(self):
        # k == 1 never triggers the correction (condition k > 1).
        desc = ModelDesc(bias_negative_samples=False)
        out = np.asarray(obj.nce_instance_weights(jnp.array([1.0]), 1, desc))
        np.testing.assert_allclose(out, np.ones((1, 2)))


class TestTextEntityForward:
    def _manual_cost(self, params, batch, entity_ids, desc):
        """Numpy re-derivation of objective.cu:30-313."""
        word = np.asarray(params.word_reprs)
        ent_tab = np.asarray(params.entity_reprs)
        W = np.asarray(params.transform_w)
        b = np.asarray(params.transform_b)
        feats = np.asarray(batch.features)
        fw = np.asarray(batch.feature_weights)
        weights = np.asarray(batch.weights)
        ids = np.asarray(entity_ids)
        B, window = feats.shape
        k = ids.shape[1] - 1

        phrase = np.einsum("bw,bwd->bd", fw, word[feats]) / window
        proj = np.tanh(phrase @ W + b)
        ent = ent_tab[ids]
        signs = np.array([1.0] + [-1.0] * k)
        dots = np.einsum("bd,bkd->bk", proj, ent) * signs
        p = np.clip(1.0 / (1.0 + np.exp(-dots)), 1e-7, 1.0 - 1e-7)
        lw = np.repeat(weights[:, None], k + 1, axis=1)
        if k > 1:
            lw = lw * (k + 1.0) / (2.0 * k)
            lw[:, 0] *= k
        return -np.sum(lw * np.log(p)) / B

    def test_cost_matches_manual(self, rng):
        params = make_params(rng)
        batch = obj.TextEntityBatch(
            features=jnp.asarray(rng.randint(0, 7, (4, 2)), dtype=jnp.int32),
            feature_weights=jnp.ones((4, 2)),
            labels=jnp.asarray(rng.randint(0, 5, (4,)), dtype=jnp.int32),
            weights=jnp.asarray(rng.rand(4) + 0.5),
        )
        desc = ModelDesc(nonlinearity=Nonlinearity.TANH)
        ids = obj.sample_negative_entities(
            jax.random.PRNGKey(7), batch.labels, 5, 3
        )
        cost, probs = obj.text_entity_cost(params, batch, ids, desc)
        want = self._manual_cost(params, batch, ids, desc)
        np.testing.assert_allclose(float(cost), want, rtol=1e-10)
        assert probs.shape == (4, 4)

    def test_cost_positive_and_finite(self, rng):
        params = make_params(rng)
        batch = obj.TextEntityBatch(
            features=jnp.zeros((2, 3), jnp.int32),
            feature_weights=jnp.ones((2, 3)),
            labels=jnp.zeros((2,), jnp.int32),
            weights=jnp.ones((2,)),
        )
        ids = obj.sample_negative_entities(
            jax.random.PRNGKey(0), batch.labels, 5, 2
        )
        cost, _ = obj.text_entity_cost(params, batch, ids, ModelDesc())
        assert np.isfinite(float(cost)) and float(cost) > 0.0


class TestSimilarityForward:
    def test_cost_matches_manual(self, rng):
        table = jnp.asarray(rng.randn(6, 4))
        batch = obj.SimilarityBatch(
            ids=jnp.asarray(rng.randint(0, 6, (3, 2)), dtype=jnp.int32),
            weights=jnp.asarray(rng.rand(3)),
        )
        cost, probs, grad = obj.similarity_cost_and_grads(
            table, batch, ModelDesc()
        )
        t = np.asarray(table)
        ids = np.asarray(batch.ids)
        dots = np.sum(t[ids[:, 0]] * t[ids[:, 1]], axis=1)
        p = np.clip(1.0 / (1.0 + np.exp(-dots)), 1e-7, 1 - 1e-7)
        want = -np.sum(np.asarray(batch.weights) * np.log(p)) / 3.0
        np.testing.assert_allclose(float(cost), want, rtol=1e-10)

    def test_gradient_is_flipped_pair(self, rng):
        # objective.cu:641-661: grad of each repr is the *other* repr scaled
        # by the multiplier.
        table = jnp.asarray(rng.randn(6, 4))
        batch = obj.SimilarityBatch(
            ids=jnp.array([[0, 3]], dtype=jnp.int32),
            weights=jnp.array([2.0]),
        )
        _, probs, grad = obj.similarity_cost_and_grads(
            table, batch, ModelDesc()
        )
        t = np.asarray(table)
        p = float(probs[0])
        mult = 2.0 * (1.0 / 1.0) * (1.0 - p)  # weight * (1/B) * (1-p)
        got = np.asarray(grad.grad)
        np.testing.assert_allclose(got[0], mult * t[3], rtol=1e-10)
        np.testing.assert_allclose(got[1], mult * t[0], rtol=1e-10)


class TestInfer:
    def test_infer_ignores_batchnorm(self, rng):
        # model.cu:124-128: BN never applies at inference.
        params = make_params(rng)
        desc = ModelDesc(batch_normalization=True)
        feats = jnp.asarray(rng.randint(0, 7, (3, 2)), dtype=jnp.int32)
        out = obj.infer(params, feats, desc)
        phrase = np.einsum(
            "bwd->bd", np.asarray(params.word_reprs)[np.asarray(feats)]
        ) / 2.0
        want = np.tanh(
            phrase @ np.asarray(params.transform_w) + np.asarray(params.transform_b)
        )
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-10)


class TestInitParams:
    def test_shapes_and_bias_zero(self):
        desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
        p = init_params(jax.random.PRNGKey(0), 11, 9, desc)
        assert p.word_reprs.shape == (11, 8)
        assert p.entity_reprs.shape == (9, 6)
        assert p.transform_w.shape == (8, 6)
        np.testing.assert_array_equal(np.asarray(p.transform_b), np.zeros(6))

    def test_glorot_limits(self):
        desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
        p = init_params(jax.random.PRNGKey(0), 100, 9, desc)
        limit = (6.0 / (100 + 8)) ** 0.5
        w = np.asarray(p.word_reprs)
        assert np.abs(w).max() <= limit
        assert np.abs(w).max() > 0.5 * limit


class TestFactoredEntityGrads:
    def test_factored_matches_expanded_densified(self, rng):
        """The rank-1 factored entity descriptor must densify to exactly the
        expanded per-update gradients."""
        from cunvsm.train.gradcheck import densify_grads

        params = make_params(rng)
        batch = obj.TextEntityBatch(
            features=jnp.asarray(rng.randint(0, 7, (4, 2)), dtype=jnp.int32),
            feature_weights=jnp.asarray(rng.rand(4, 2) + 0.5),
            labels=jnp.asarray(rng.randint(0, 5, (4,)), dtype=jnp.int32),
            weights=jnp.asarray(rng.rand(4) + 0.5),
        )
        desc = ModelDesc()
        ids = obj.sample_negative_entities(
            jax.random.PRNGKey(3), batch.labels, 5, 3
        )
        c1, p1, g_exp = obj.text_entity_cost_and_grads(
            params, batch, ids, desc, factored_entity_grads=False
        )
        c2, p2, g_fac = obj.text_entity_cost_and_grads(
            params, batch, ids, desc, factored_entity_grads=True
        )
        np.testing.assert_allclose(float(c1), float(c2), rtol=1e-12)
        d1 = densify_grads(params, g_exp)
        d2 = densify_grads(params, g_fac)
        for a, b in zip(d1, d2):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12
            )

    def test_factored_refused_with_entity_l2norm(self, rng):
        """Entity L2 normalization breaks the rank-1 structure; the expanded
        path must be used."""
        params = make_params(rng)
        batch = obj.TextEntityBatch(
            features=jnp.zeros((2, 2), jnp.int32),
            feature_weights=jnp.ones((2, 2)),
            labels=jnp.zeros((2,), jnp.int32),
            weights=jnp.ones((2,)),
        )
        desc = ModelDesc(l2_normalize_entity_reprs=True)
        ids = obj.sample_negative_entities(
            jax.random.PRNGKey(0), batch.labels, 5, 2
        )
        _, _, g = obj.text_entity_cost_and_grads(
            params, batch, ids, desc, factored_entity_grads=True
        )
        # Falls back to the expanded layout (window 1).
        assert g.entity[0].indices.shape[1] == 1


class TestSharedNegatives:
    """Batch-shared negatives: identical loss to per-instance ids tiled with
    the same k negatives, and hand-VJP gradients that match autodiff."""

    def _setup(self, rng, desc):
        params = make_params(rng, num_words=9, num_entities=6, d_w=4, d_e=3)
        B, W, K = 5, 3, 4
        batch = obj.TextEntityBatch(
            features=jnp.asarray(rng.randint(0, 9, (B, W)), jnp.int32),
            feature_weights=jnp.asarray(rng.rand(B, W) + 0.5),
            labels=jnp.asarray(rng.randint(0, 6, (B,)), jnp.int32),
            weights=jnp.asarray(rng.rand(B) + 0.5),
        )
        neg_ids = jnp.asarray(rng.randint(0, 6, (K,)), jnp.int32)
        tiled = jnp.concatenate(
            [batch.labels[:, None], jnp.broadcast_to(neg_ids, (B, K))], axis=1
        )
        return params, batch, neg_ids, tiled

    @pytest.mark.parametrize(
        "desc",
        [
            ModelDesc(word_repr_size=4, entity_repr_size=3),
            ModelDesc(
                word_repr_size=4,
                entity_repr_size=3,
                nonlinearity=Nonlinearity.HARD_TANH,
                batch_normalization=True,
            ),
            ModelDesc(
                word_repr_size=4,
                entity_repr_size=3,
                l2_normalize_phrase_reprs=True,
                bias_negative_samples=True,
            ),
        ],
    )
    def test_matches_tiled_per_instance(self, rng, desc):
        params, batch, neg_ids, tiled = self._setup(rng, desc)

        cost_shared, probs_shared, grads = obj.text_entity_cost_and_grads_shared(
            params, batch, neg_ids, desc
        )
        cost_ref, probs_ref = obj.text_entity_cost(params, batch, tiled, desc)
        np.testing.assert_allclose(
            float(cost_shared), float(cost_ref), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(probs_shared), np.asarray(probs_ref), rtol=1e-12
        )

        # Autodiff oracle over the full parameter pytree.
        def cost_fn(p):
            c, _ = obj.text_entity_cost(p, batch, tiled, desc)
            return c

        g = jax.grad(cost_fn)(params)

        def scatter(descs, shape):
            out = np.zeros(shape)
            for d in descs:
                gr = np.asarray(d.grad)
                idx = np.asarray(d.indices)
                w = (
                    np.asarray(d.weights)
                    if d.weights is not None
                    else np.ones_like(idx, dtype=np.float64)
                )
                for i in range(idx.shape[0]):
                    for j in range(idx.shape[1]):
                        out[idx[i, j]] += w[i, j] * gr[i]
            return out

        np.testing.assert_allclose(
            scatter(grads.word, params.word_reprs.shape),
            -np.asarray(g.word_reprs),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            scatter(grads.entity, params.entity_reprs.shape),
            -np.asarray(g.entity_reprs),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(grads.transform_w), -np.asarray(g.transform_w),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(grads.transform_b), -np.asarray(g.transform_b),
            rtol=1e-9, atol=1e-12,
        )

    def test_rejects_entity_l2norm(self, rng):
        desc = ModelDesc(
            word_repr_size=4, entity_repr_size=3,
            l2_normalize_entity_reprs=True,
        )
        params, batch, neg_ids, _ = self._setup(rng, ModelDesc(4, 3))
        with pytest.raises(ValueError):
            obj.text_entity_cost_and_grads_shared(
                params, batch, neg_ids, desc
            )

    def test_train_step_runs_and_rejects_sparse_optimizers(self, rng):
        import dataclasses

        from cunvsm.config import (
            AdamConfig, AdamMode, TrainConfig, UpdateMethod,
        )
        from cunvsm.optim.updates import Optimizer
        from cunvsm.train.step import make_train_step

        desc = ModelDesc(
            word_repr_size=4, entity_repr_size=3,
            nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
        )
        cfg = TrainConfig(
            batch_size=5, window_size=3, num_random_entities=4,
            update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            learning_rate=0.1, regularization_lambda=0.01,
            shared_negatives=True,
        )
        params, batch, _, _ = self._setup(rng, desc)
        opt = Optimizer(cfg)
        step = make_train_step(desc, cfg, jit=False)
        p, o, cost = step(params, opt.init(params), batch, jax.random.PRNGKey(0))
        assert np.isfinite(float(cost))
        assert not np.allclose(
            np.asarray(p.entity_reprs), np.asarray(params.entity_reprs)
        )

        sparse_cfg = dataclasses.replace(
            cfg, adam=AdamConfig(mode=AdamMode.SPARSE)
        )
        step2 = make_train_step(desc, sparse_cfg, jit=False)
        with pytest.raises(ValueError):
            step2(params, Optimizer(sparse_cfg).init(params), batch,
                  jax.random.PRNGKey(0))


class TestPooledNegatives:
    """Rolled-pool negatives: bit-identical loss to per-instance ids built
    from the rolled pool slots, and hand-VJP gradients matching autodiff."""

    def _setup(self, rng, P=4, k=3, B=8):
        params = make_params(rng, num_words=9, num_entities=6, d_w=4, d_e=3)
        W = 3
        batch = obj.TextEntityBatch(
            features=jnp.asarray(rng.randint(0, 9, (B, W)), jnp.int32),
            feature_weights=jnp.asarray(rng.rand(B, W) + 0.5),
            labels=jnp.asarray(rng.randint(0, 6, (B,)), jnp.int32),
            weights=jnp.asarray(rng.rand(B) + 0.5),
        )
        # Include a duplicate pool id to exercise accumulate semantics.
        pool_ids = jnp.asarray(rng.randint(0, 6, (P,)), jnp.int32)
        pool_ids = pool_ids.at[P - 1].set(pool_ids[0])
        rolled = obj.rolled_pool_negative_ids(pool_ids, B, k)
        tiled = jnp.concatenate([batch.labels[:, None], rolled], axis=1)
        return params, batch, pool_ids, tiled, k

    @pytest.mark.parametrize(
        "desc",
        [
            ModelDesc(word_repr_size=4, entity_repr_size=3),
            ModelDesc(
                word_repr_size=4, entity_repr_size=3,
                nonlinearity=Nonlinearity.HARD_TANH,
                batch_normalization=True,
            ),
            ModelDesc(
                word_repr_size=4, entity_repr_size=3,
                l2_normalize_phrase_reprs=True,
                bias_negative_samples=True,
            ),
        ],
    )
    def test_matches_tiled_per_instance(self, rng, desc):
        params, batch, pool_ids, tiled, k = self._setup(rng)

        cost_p, probs_p, grads = obj.text_entity_cost_and_grads_pooled(
            params, batch, pool_ids, k, desc
        )
        cost_ref, probs_ref = obj.text_entity_cost(params, batch, tiled, desc)
        np.testing.assert_allclose(float(cost_p), float(cost_ref), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(probs_p), np.asarray(probs_ref), rtol=1e-12
        )

        def cost_fn(p):
            c, _ = obj.text_entity_cost(p, batch, tiled, desc)
            return c

        g = jax.grad(cost_fn)(params)

        def scatter(descs, shape):
            out = np.zeros(shape)
            for d in descs:
                gr = np.asarray(d.grad)
                idx = np.asarray(d.indices)
                w = (
                    np.asarray(d.weights)
                    if d.weights is not None
                    else np.ones_like(idx, dtype=np.float64)
                )
                for i in range(idx.shape[0]):
                    for j in range(idx.shape[1]):
                        out[idx[i, j]] += w[i, j] * gr[i]
            return out

        np.testing.assert_allclose(
            scatter(grads.word, params.word_reprs.shape),
            -np.asarray(g.word_reprs), rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            scatter(grads.entity, params.entity_reprs.shape),
            -np.asarray(g.entity_reprs), rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(grads.transform_w), -np.asarray(g.transform_w),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(grads.transform_b), -np.asarray(g.transform_b),
            rtol=1e-9, atol=1e-12,
        )

    def test_stride_matches_tiled(self, rng):
        """Strided windows keep the exact per-example loss (the negatives
        are just a different distinct-slot selection from the same pool) and
        the j*stride rolls fold the window gradients onto the right rows."""
        desc = ModelDesc(word_repr_size=4, entity_repr_size=3)
        params, batch, pool_ids, _, k = self._setup(rng)
        B = batch.features.shape[0]
        rolled = obj.rolled_pool_negative_ids(pool_ids, B, k, stride=3)
        tiled = jnp.concatenate([batch.labels[:, None], rolled], axis=1)

        cost_p, probs_p, grads = obj.text_entity_cost_and_grads_pooled(
            params, batch, pool_ids, k, desc, pool_stride=3
        )
        cost_ref, probs_ref = obj.text_entity_cost(params, batch, tiled, desc)
        np.testing.assert_allclose(float(cost_p), float(cost_ref), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(probs_p), np.asarray(probs_ref), rtol=1e-12
        )

        def cost_fn(p):
            c, _ = obj.text_entity_cost(p, batch, tiled, desc)
            return c

        g = jax.grad(cost_fn)(params)
        dense_entity = np.zeros(params.entity_reprs.shape)
        for d in grads.entity:
            gr, idx = np.asarray(d.grad), np.asarray(d.indices)
            w = (
                np.asarray(d.weights)
                if d.weights is not None
                else np.ones(idx.shape)
            )
            for i in range(idx.shape[0]):
                for j in range(idx.shape[1]):
                    dense_entity[idx[i, j]] += w[i, j] * gr[i]
        np.testing.assert_allclose(
            dense_entity, -np.asarray(g.entity_reprs), rtol=1e-9, atol=1e-12
        )

        with pytest.raises(ValueError, match="distinct slots"):
            obj.text_entity_cost_and_grads_pooled(
                params, batch, pool_ids, k, desc, pool_stride=2
            )

    def test_validation_errors(self, rng):
        params, batch, pool_ids, _, k = self._setup(rng)
        with pytest.raises(ValueError, match="divisible"):
            obj.text_entity_cost_and_grads_pooled(
                params, batch, pool_ids[:3], k, ModelDesc(4, 3)
            )
        with pytest.raises(ValueError, match="l2_normalize"):
            obj.text_entity_cost_and_grads_pooled(
                params, batch, pool_ids, k,
                ModelDesc(4, 3, l2_normalize_entity_reprs=True),
            )

    def test_train_step_dispatch(self, rng):
        import dataclasses

        from cunvsm.config import (
            AdamConfig, AdamMode, TrainConfig, UpdateMethod,
        )
        from cunvsm.optim.updates import Optimizer
        from cunvsm.train.step import make_train_step

        desc = ModelDesc(
            word_repr_size=4, entity_repr_size=3,
            nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
        )
        cfg = TrainConfig(
            batch_size=8, window_size=3, num_random_entities=3,
            update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            learning_rate=0.1, regularization_lambda=0.01,
            negative_pool_size=4,
        )
        params, batch, _, _, _ = self._setup(rng)
        opt = Optimizer(cfg)
        step = make_train_step(desc, cfg, jit=False)
        p, o, cost = step(params, opt.init(params), batch, jax.random.PRNGKey(0))
        assert np.isfinite(float(cost))

        with pytest.raises(ValueError, match="mutually exclusive"):
            bad = dataclasses.replace(cfg, shared_negatives=True)
            make_train_step(desc, bad, jit=False)(
                params, opt.init(params), batch, jax.random.PRNGKey(0)
            )


class TestNegativeSamplingResolution:
    """Auto resolution of the rolled-pool layout (TrainConfig default -1)."""

    def _cfg(self, **kw):
        from cunvsm.config import AdamConfig, AdamMode
        from cunvsm.config import TrainConfig, UpdateMethod

        base = dict(
            update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            num_random_entities=10,
        )
        base.update(kw)
        return TrainConfig(**base)

    def test_auto_selects_pool_and_odd_stride(self):
        from cunvsm.train.step import resolve_negative_sampling

        desc = ModelDesc()
        p, s = resolve_negative_sampling(self._cfg(), desc, 51200)
        assert p == 2048
        assert s == 205  # P//k rounded up to odd; matches the validated run
        assert len({(j * s) % p for j in range(10)}) == 10
        # Smaller batches pick the largest dividing candidate.
        p, s = resolve_negative_sampling(self._cfg(), desc, 1024)
        assert p == 1024
        p, s = resolve_negative_sampling(self._cfg(), desc, 320)
        assert p == 64
        # Batch with no candidate divisor: per-instance.
        p, s = resolve_negative_sampling(self._cfg(), desc, 100)
        assert (p, s) == (0, 1)

    def test_auto_is_scale_aware(self):
        """The auto default resolves per-instance when the pool would
        cover more than 25% of the collection (the regime where pooled
        sampling measurably loses on Cranfield, PERFORMANCE.md), and keeps
        the pooled layout at collection scale where it measurably wins."""
        from cunvsm.train.step import resolve_negative_sampling

        desc = ModelDesc()
        # Cranfield scale: 2048-pool would cover >100% of 1398 docs.
        p, _ = resolve_negative_sampling(
            self._cfg(), desc, 51200, num_entities=1398
        )
        assert p == 0
        # Collection scale: ~3% coverage keeps the pool.
        p, s = resolve_negative_sampling(
            self._cfg(), desc, 51200, num_entities=65536
        )
        assert (p, s) == (2048, 205)
        # Boundary: exactly 25% coverage keeps the pool; just above drops.
        p, _ = resolve_negative_sampling(
            self._cfg(), desc, 51200, num_entities=8192
        )
        assert p == 2048
        p, _ = resolve_negative_sampling(
            self._cfg(), desc, 51200, num_entities=8191
        )
        assert p == 0
        # Unknown collection size preserves the divisibility-only rule.
        p, _ = resolve_negative_sampling(self._cfg(), desc, 51200)
        assert p == 2048
        # Explicit pools are never overridden by the coverage rule.
        p, _ = resolve_negative_sampling(
            self._cfg(negative_pool_size=2048), desc, 51200,
            num_entities=1398,
        )
        assert p == 2048

    def test_auto_respects_mode_requirements(self):
        from cunvsm.config import UpdateMethod
        from cunvsm.train.step import resolve_negative_sampling

        desc = ModelDesc()
        # Non-accumulate-only optimizer: per-instance.
        p, _ = resolve_negative_sampling(
            self._cfg(update_method=UpdateMethod.ADAGRAD), desc, 51200
        )
        assert p == 0
        # Entity L2 normalization: per-instance.
        p, _ = resolve_negative_sampling(
            self._cfg(), ModelDesc(l2_normalize_entity_reprs=True), 51200
        )
        assert p == 0
        # Shared negatives win over auto.
        p, _ = resolve_negative_sampling(
            self._cfg(shared_negatives=True), desc, 51200
        )
        assert p == 0
        # Explicit 0 forces reference-exact per-instance sampling.
        p, _ = resolve_negative_sampling(
            self._cfg(negative_pool_size=0), desc, 51200
        )
        assert p == 0
        # Explicit pool + explicit stride pass through.
        p, s = resolve_negative_sampling(
            self._cfg(negative_pool_size=256, negative_pool_stride=1),
            desc, 51200,
        )
        assert (p, s) == (256, 1)

    def test_explicit_pool_validation(self):
        """Misconfigured explicit pools fail fast at resolution time —
        a pool smaller than k used to spin the stride search forever."""
        import pytest

        from cunvsm.train.step import resolve_negative_sampling

        desc = ModelDesc()
        # Pool smaller than the number of negatives (k=10 in _cfg).
        with pytest.raises(ValueError, match="pool"):
            resolve_negative_sampling(
                self._cfg(negative_pool_size=4), desc, 1024
            )
        # Pool not dividing the batch.
        with pytest.raises(ValueError, match="divisible"):
            resolve_negative_sampling(
                self._cfg(negative_pool_size=48), desc, 1024
            )


def test_rolled_pool_rejects_non_multiple_batch():
    import jax.numpy as jnp
    import cunvsm.models.objectives as obj

    pool_ids = jnp.arange(8, dtype=jnp.int32)
    with pytest.raises(ValueError, match="positive multiple"):
        obj.rolled_pool_negative_ids(pool_ids, 4, 2)  # B < P
    with pytest.raises(ValueError, match="positive multiple"):
        obj.rolled_pool_negative_ids(pool_ids, 12, 2)  # B % P != 0
