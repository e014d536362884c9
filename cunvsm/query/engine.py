"""On-device query engine: the accelerator replacement for py/nvsm.

The reference ranks with host-side sklearn cosine k-NN over the document
matrix, fanned out over a 16-process pool (py/nvsm/base.py:362-430,
py/query.py:18-76).  Here ranking is a single device program: projected
queries hit an L2-normalized document matrix as one matmul followed by ``jax.lax.top_k`` — the SURVEY.md §3.4 "hot loop" moved on
device.  Batching over queries replaces process fan-out.

Query-side math parity (py/nvsm/base.py):

* query representation = weighted *mean* of in-vocabulary word vectors
  (np.average, base.py:274-309 — note: normalized by the weight sum, unlike
  the training-side division by window);
* optional self-information weighting -log(tf/total);
* infer: q @ W + bias_coefficient * b, then optional nonlinearity
  (base.py:311-323); NVSM is queried with --linear (functions.sh:269-271)
  and LSE with tanh;
* scores are cosine similarities (the sklearn path converts euclidean
  distances back to cosine, base.py:27-103).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.models.params import ModelParams


def _project_queries(
    query_reprs, transform_w, transform_b_scaled, nonlinearity
):
    projected = jnp.dot(
        query_reprs, transform_w, preferred_element_type=jnp.float32
    ) + transform_b_scaled[None, :]
    if nonlinearity == "tanh":
        projected = jnp.tanh(projected)
    norms = jnp.linalg.norm(projected, axis=1, keepdims=True)
    return projected / jnp.maximum(norms, 1e-30)


@partial(jax.jit, static_argnames=("top_k", "nonlinearity"))
def _rank_kernel(
    query_reprs: jax.Array,  # [Q, d_w]
    transform_w: jax.Array,
    transform_b_scaled: jax.Array,
    entity_norm: jax.Array,  # [D, d_e], rows L2-normalized
    top_k: int,
    nonlinearity: Optional[str],
):
    projected = _project_queries(
        query_reprs, transform_w, transform_b_scaled, nonlinearity
    )
    scores = jnp.dot(
        projected.astype(entity_norm.dtype),
        entity_norm.T,
        preferred_element_type=jnp.float32,
    )  # [Q, D] cosine similarities, f32 accumulation
    return jax.lax.top_k(scores, top_k)


class QueryEngine:
    def __init__(
        self,
        params: ModelParams,
        terms: Sequence[str],
        docnos: Sequence[str],
        term_frequencies: Optional[np.ndarray] = None,
        total_terms: Optional[int] = None,
        nonlinearity: Optional[str] = "tanh",
        bias_coefficient: float = 0.0,
        self_information: bool = False,
        l2norm_phrase: bool = False,
        score_dtype=None,
        mesh=None,
    ):
        """``score_dtype=jnp.bfloat16`` stores the normalized document
        matrix in bf16, halving the per-query HBM traffic of the scoring
        matmul (serving is bandwidth-bound).  Scores accumulate in f32.

        ``mesh``: a jax Mesh with a "model" axis shards the normalized
        document matrix row-wise for collection-scale serving; ranking
        then runs the explicit per-shard top-k + candidate merge
        (parallel/query.py)."""
        self.params = params
        self.term_to_id: Dict[str, int] = {
            t: i for i, t in enumerate(terms) if t
        }
        self.docnos = list(docnos)
        self.term_frequencies = term_frequencies
        self.total_terms = total_terms
        self.nonlinearity = nonlinearity
        self.self_information = self_information
        self.l2norm_phrase = l2norm_phrase
        self._word_reprs_np = np.asarray(params.word_reprs)
        self._bias_scaled = jnp.asarray(
            bias_coefficient * np.asarray(params.transform_b)
        )
        entity = np.asarray(params.entity_reprs, dtype=np.float32)
        norms = np.linalg.norm(entity, axis=1, keepdims=True)
        self._entity_norm = jnp.asarray(
            entity / np.maximum(norms, 1e-30),
            dtype=score_dtype or jnp.float32,
        )
        # Scoring only ever reads the normalized copy; drop the raw entity
        # matrix so a bf16 engine doesn't keep the f32 table alive in HBM.
        self.params = params._replace(
            entity_reprs=jnp.zeros(
                (0, params.entity_reprs.shape[1]), params.entity_reprs.dtype
            )
        )
        self.mesh = mesh
        self._sharded_scorers: Dict[int, Callable] = {}

    # -- query-side forward -------------------------------------------------

    def query_representation(
        self, query_terms: Sequence[str], strict: bool = False
    ) -> Optional[np.ndarray]:
        """Weighted mean of in-vocabulary term vectors (base.py:274-309)."""
        ids = [
            self.term_to_id[t] for t in query_terms if t in self.term_to_id
        ]
        if not ids or (strict and len(ids) < len(query_terms)):
            return None
        vecs = self._word_reprs_np[ids]
        if self.self_information:
            assert self.term_frequencies is not None and self.total_terms
            w = -np.log(
                self.term_frequencies[ids].astype(np.float64)
                / self.total_terms
            )
            repr_ = np.average(vecs, axis=0, weights=w)
        else:
            repr_ = vecs.mean(axis=0)
        if self.l2norm_phrase:
            # Query-side analog of l2_normalize_phrase_reprs
            # (py/query.py --l2norm_phrase).
            repr_ = repr_ / max(np.linalg.norm(repr_), 1e-30)
        return repr_

    # -- ranking ------------------------------------------------------------

    def rank(
        self,
        queries: Dict[str, Sequence[str]],
        top_k: int = 1000,
    ) -> Dict[str, List[Tuple[str, float]]]:
        """Batch-rank all queries in one device call.

        Returns {query_id: [(docno, cosine_score), ...]} sorted descending.
        Queries with no in-vocabulary terms are omitted (base.py:297-303).
        """
        qids: List[str] = []
        reprs: List[np.ndarray] = []
        for qid, terms in queries.items():
            r = self.query_representation(terms)
            if r is None:
                continue
            qids.append(qid)
            reprs.append(r)
        if not qids:
            return {}
        k = min(top_k, len(self.docnos))
        q = jnp.asarray(np.stack(reprs), dtype=self.params.word_reprs.dtype)
        if self.mesh is not None:
            scores, indices = self._rank_sharded(q, k)
        else:
            scores, indices = _rank_kernel(
                q,
                self.params.transform_w,
                self._bias_scaled,
                self._entity_norm,
                k,
                self.nonlinearity,
            )
        scores = np.asarray(scores)
        indices = np.asarray(indices)
        return {
            qid: [
                (self.docnos[indices[i, j]], float(scores[i, j]))
                for j in range(k)
            ]
            for i, qid in enumerate(qids)
        }

    def _rank_sharded(self, q: jax.Array, k: int):
        """Project on one device, score + merge over the sharded matrix."""
        from cunvsm.parallel.query import make_sharded_scorer

        if k not in self._sharded_scorers:
            # self._entity_norm may already be the row-padded sharded copy
            # from a previous k; pass the true doc count so pad rows stay
            # masked out of the merge.
            scorer, sharded = make_sharded_scorer(
                self.mesh, self._entity_norm, k, num_docs=len(self.docnos)
            )
            # Keep one sharded copy; later k values rebuild only the jit.
            self._entity_norm = sharded
            self._sharded_scorers[k] = scorer
        projected = _project_queries(
            q, self.params.transform_w, self._bias_scaled, self.nonlinearity
        )
        return self._sharded_scorers[k](
            projected.astype(self._entity_norm.dtype)
        )

    def score_documents(
        self, query_terms: Sequence[str], docnos: Sequence[str]
    ) -> Optional[List[Tuple[str, float]]]:
        """Cosine scores restricted to a document subset (the brute-force
        path used for qrel-restricted ranking, base.py:406-424)."""
        r = self.query_representation(query_terms)
        if r is None:
            return None
        docno_to_id = {d: i for i, d in enumerate(self.docnos)}
        ids = [docno_to_id[d] for d in docnos if d in docno_to_id]
        if not ids:
            return []
        proj = np.asarray(self.infer(r))
        proj = proj / max(np.linalg.norm(proj), 1e-30)
        # Match the device kernel's quantization exactly (bf16 inputs with
        # f32 accumulation when score_dtype=bfloat16), so subset scores are
        # consistent with rank().
        proj = np.asarray(
            jnp.asarray(proj, self._entity_norm.dtype), np.float32
        )
        sub = np.asarray(
            self._entity_norm[np.asarray(ids)], dtype=np.float32
        )
        scores = sub @ proj
        order = np.argsort(-scores)
        return [(self.docnos[ids[i]], float(scores[i])) for i in order]

    def infer(self, query_repr: np.ndarray) -> np.ndarray:
        """Project a query representation into entity space (base.py:311-323)."""
        out = query_repr @ np.asarray(self.params.transform_w) + np.asarray(
            self._bias_scaled
        )
        if self.nonlinearity == "tanh":
            out = np.tanh(out)
        return out

    # -- analysis helpers ---------------------------------------------------

    def related_terms(self, term: str, k: int = 10) -> List[Tuple[str, float]]:
        """Nearest terms by cosine in word space (base.py related_terms)."""
        if term not in self.term_to_id:
            return []
        ids = {i: t for t, i in self.term_to_id.items()}
        w = self._word_reprs_np
        q = w[self.term_to_id[term]]
        scores = (w @ q) / (
            np.linalg.norm(w, axis=1) * max(np.linalg.norm(q), 1e-30) + 1e-30
        )
        order = np.argsort(-scores)
        out = []
        for i in order:
            if i == self.term_to_id[term] or i not in ids:
                continue
            out.append((ids[int(i)], float(scores[i])))
            if len(out) == k:
                break
        return out

    def term_similarity(self, a: str, b: str) -> Optional[float]:
        if a not in self.term_to_id or b not in self.term_to_id:
            return None
        va = self._word_reprs_np[self.term_to_id[a]]
        vb = self._word_reprs_np[self.term_to_id[b]]
        return float(
            va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-30)
        )


class TermBruteforcer:
    """Inverse n-gram lookup: which term combinations project nearest to a
    given document-space vector (py/nvsm/base.py:106-162).

    Cardinality 1 covers the FULL vocabulary, exactly like the reference's
    brute-force over every 1-gram (py/nvsm/base.py:106-162): the whole
    word table is projected through the transform in one [V, d_w] device
    matmul and queries answer with an on-device [N, d_e] cosine matmul +
    ``lax.top_k``.  Cardinality >= 2 explodes
    combinatorially, so those combinations draw from a term universe
    capped at ``max_terms`` by collection frequency.
    """

    def __init__(
        self,
        engine: QueryEngine,
        max_ngram_cardinality: int = 1,
        max_terms: int = 4096,
    ):
        import itertools

        self.engine = engine
        w = engine._word_reprs_np
        # Full-vocabulary 1-grams, in model-id order.
        id_to_term = {i: t for t, i in engine.term_to_id.items()}
        vocab_ids = sorted(id_to_term)
        self.ngrams: List[tuple] = [(id_to_term[i],) for i in vocab_ids]
        reprs = [w[np.asarray(vocab_ids)]]
        if max_ngram_cardinality >= 2:
            # Cap the cardinality>=2 term universe by collection frequency
            # (the terms a user would expect an inverse lookup to cover),
            # falling back to alphabetical order without frequencies.
            if engine.term_frequencies is not None:
                ranked = sorted(
                    engine.term_to_id,
                    key=lambda t: (
                        -int(engine.term_frequencies[engine.term_to_id[t]]),
                        t,
                    ),
                )
            else:
                ranked = sorted(engine.term_to_id)
            terms = ranked[:max_terms]
            combo_reprs = []
            for k in range(2, max_ngram_cardinality + 1):
                for combo in itertools.combinations(terms, k):
                    ids = [engine.term_to_id[t] for t in combo]
                    self.ngrams.append(combo)
                    combo_reprs.append(w[ids].mean(axis=0))
            if combo_reprs:
                reprs.append(np.stack(combo_reprs))
        all_reprs = jnp.asarray(np.concatenate(reprs, axis=0))

        @jax.jit
        def project(r):
            return _project_queries(
                r,
                engine.params.transform_w,
                engine._bias_scaled,
                engine.nonlinearity,
            )

        # One device projection of every n-gram representation; the
        # normalized [N, d_e] table stays device-resident for queries.
        self._projected_norm = project(all_reprs)

    def nearest_ngrams(self, target: np.ndarray, k: int = 10):
        """Top-k n-grams whose projections are cosine-nearest to ``target``
        (a document-space vector, e.g. a document representation)."""
        t = np.asarray(target, dtype=np.float32)
        t = t / max(float(np.linalg.norm(t)), 1e-30)
        scores, idx = _topk_cosine(
            self._projected_norm, jnp.asarray(t), min(k, len(self.ngrams))
        )
        return [
            (self.ngrams[int(i)], float(s))
            for i, s in zip(np.asarray(idx), np.asarray(scores))
        ]


@partial(jax.jit, static_argnames=("k",))
def _topk_cosine(table_norm: jax.Array, target: jax.Array, k: int):
    scores = jnp.dot(
        table_norm, target, preferred_element_type=jnp.float32
    )
    return jax.lax.top_k(scores, k)


def load_query_engine(prefix: str, epoch, **kwargs) -> QueryEngine:
    """Load a checkpoint + sidecars into a QueryEngine."""
    from cunvsm.io import checkpoint as ckpt

    params = ckpt.load_model_hdf5(prefix, epoch)
    meta = ckpt.load_meta(prefix)
    terms = ckpt.load_strings(f"{prefix}_vocab.txt")
    docnos = ckpt.load_strings(f"{prefix}_docnos.txt")
    freqs = np.zeros(len(terms), dtype=np.int64)
    for t in meta.term:
        freqs[t.model_term_id] = t.term_frequency
    return QueryEngine(
        params,
        terms,
        docnos,
        term_frequencies=freqs,
        total_terms=meta.total_terms,
        **kwargs,
    )
