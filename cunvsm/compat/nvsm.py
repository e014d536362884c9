"""Drop-in API compatibility with the reference's ``nvsm`` Python library.

Code written against py/nvsm/base.py (``import nvsm; nvsm.load_meta(...);
nvsm.load_model(...)``) can switch to ``from cunvsm.compat import nvsm``
and keep working: the same entry points, the same NVSM attribute surface
(word_representations / object_representations / transform_matrix /
term_mapping / ...), backed by this framework's checkpoint reader and
on-device query engine.

One deliberate divergence: the reference's ``bias_coefficient`` handling
contains an inverted condition (base.py:230-236 applies coefficient*bias
exactly when the coefficient is 0.0, i.e. always adds zeros, and drops the
bias otherwise); here the coefficient scales the bias as documented.  The
default (0.0) produces identical outputs either way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from cunvsm.io import checkpoint as _ckpt
from cunvsm.proto import nvsm_pb2


def load_meta(path: str) -> "nvsm_pb2.Metadata":
    """Read <path>_meta (py/nvsm/base.py:13-19)."""
    return _ckpt.load_meta(path)


def load_model(meta, path: str, epoch, **kwargs) -> "NVSM":
    """Open <path>_<epoch>.hdf5 (py/nvsm/base.py:22-24)."""
    return NVSM(meta, path, epoch, **kwargs)


class NVSM:
    """py/nvsm/base.py:165-450 API surface over this framework's engine."""

    def __init__(
        self,
        meta,
        path: str,
        epoch,
        self_information: bool = False,
        bias_coefficient: float = 0.0,
        nonlinearity="tanh",
        l2norm_phrase: bool = False,
        strict: bool = False,
        **_unused,
    ):
        from cunvsm.query.engine import QueryEngine

        if callable(nonlinearity):  # np.tanh passed like the reference
            nonlinearity = "tanh"
        # Load the checkpoint once; the engine is constructed from the same
        # params (and drops its own raw entity copy after normalizing).
        params = _ckpt.load_model_hdf5(path, epoch)
        self.object_representations = np.asarray(params.entity_reprs)
        terms = _ckpt.load_strings(f"{path}_vocab.txt")
        docnos = _ckpt.load_strings(f"{path}_docnos.txt")
        freqs = np.zeros(len(terms), dtype=np.int64)
        for t in meta.term:
            freqs[t.model_term_id] = t.term_frequency
        self._engine = QueryEngine(
            params,
            terms,
            docnos,
            term_frequencies=freqs,
            total_terms=meta.total_terms,
            nonlinearity=nonlinearity,
            bias_coefficient=bias_coefficient,
            self_information=self_information,
            l2norm_phrase=l2norm_phrase,
        )
        self.strict = strict
        self.total_terms = meta.total_terms

        self.word_representations = self._engine._word_reprs_np
        self.num_terms = self.word_representations.shape[0]
        self.term_repr_size = self.word_representations.shape[1]
        self.num_objects = self.object_representations.shape[0]
        self.object_repr_size = self.object_representations.shape[1]
        self.transform_matrix = np.asarray(self._engine.params.transform_w)
        self.transform_bias = bias_coefficient * np.asarray(
            self._engine.params.transform_b
        )

        # index_term_id <-> model_term_id maps (base.py:192-203).
        self.term_mapping: Dict[int, int] = {}
        self.inv_term_mapping: Dict[int, int] = {}
        self.inv_term_id_to_term_freq: Dict[int, int] = {}
        for t in meta.term:
            self.term_mapping[t.index_term_id] = t.model_term_id
            self.inv_term_mapping[t.model_term_id] = t.index_term_id
            self.inv_term_id_to_term_freq[t.model_term_id] = t.term_frequency
        self.object_mapping: Dict[int, int] = {}
        self.inv_object_mapping: Dict[int, int] = {}
        for o in meta.object:
            self.object_mapping[o.model_object_id] = o.index_object_id
            self.inv_object_mapping[o.index_object_id] = o.model_object_id

        # Term/docno strings (the reference needs pyndri for these; this
        # framework ships them as sidecars, already loaded above).
        self._terms = terms
        self._docnos = docnos

    def __repr__(self):
        return (
            f"<NVSM with {self.num_terms} words "
            f"({self.term_repr_size}-dimensional) and "
            f"{self.num_objects} entities "
            f"({self.object_repr_size}-dimensional)."
        )

    # -- representations (base.py:253-323) ----------------------------------

    def get_average_object_repr(self):
        return self.object_representations.mean(axis=0)

    def get_average_word_repr(self):
        return self.word_representations.mean(axis=0)

    def get_word_repr(self, index_term_id: int):
        if index_term_id not in self.term_mapping:
            return None
        return self.word_representations[self.term_mapping[index_term_id]]

    def query_representation(self, index_term_ids: Sequence[int]):
        """Weighted mean of in-vocabulary word vectors, addressed by index
        term ids (base.py:274-309)."""
        model_terms = [
            self.term_mapping[i]
            for i in index_term_ids
            if i in self.term_mapping
        ]
        if not model_terms or (
            self.strict and len(model_terms) < len(index_term_ids)
        ):
            return None
        vecs = self.word_representations[model_terms]
        if self._engine.self_information:
            w = [
                -np.log(
                    self.inv_term_id_to_term_freq[m] / self.total_terms
                )
                for m in model_terms
            ]
            return np.average(vecs, axis=0, weights=w)
        return vecs.mean(axis=0)

    def infer(self, query_repr):
        if query_repr is None:
            return None
        return self._engine.infer(np.asarray(query_repr))

    # -- ranking (base.py:362-450) -------------------------------------------

    def query(self, index_term_ids: Sequence[int], top_k: int = 1000):
        """Rank documents for a query of index term ids; returns
        [(index_object_id, score)]."""
        terms = [
            self._terms[self.term_mapping[i]]
            for i in index_term_ids
            if i in self.term_mapping
        ]
        if not terms:
            return None
        run = self._engine.rank({"q": terms}, top_k=top_k)
        if "q" not in run:
            return None
        docno_to_model = self._docno_to_model_map()
        return [
            (self.object_mapping[docno_to_model[d]], s)
            for d, s in run["q"]
        ]

    def score_documents(
        self, index_term_ids: Sequence[int], index_object_ids: Sequence[int]
    ):
        terms = [
            self._terms[self.term_mapping[i]]
            for i in index_term_ids
            if i in self.term_mapping
        ]
        docnos = [
            self._docnos[self.inv_object_mapping[o]]
            for o in index_object_ids
            if o in self.inv_object_mapping
        ]
        scored = self._engine.score_documents(terms, docnos)
        if scored is None:
            return None
        docno_to_model = self._docno_to_model_map()
        return [
            (self.object_mapping[docno_to_model[d]], s) for d, s in scored
        ]

    def _term_to_model_map(self) -> Dict[str, int]:
        if not hasattr(self, "_term_to_model_cache"):
            self._term_to_model_cache = {
                t: i for i, t in enumerate(self._terms) if t
            }
        return self._term_to_model_cache

    def _docno_to_model_map(self) -> Dict[str, int]:
        if not hasattr(self, "_docno_to_model_cache"):
            self._docno_to_model_cache = {
                d: i for i, d in enumerate(self._docnos)
            }
        return self._docno_to_model_cache

    def related_terms(self, index_term_id: int, k: int = 10):
        if index_term_id not in self.term_mapping:
            return None
        term = self._terms[self.term_mapping[index_term_id]]
        out = self._engine.related_terms(term, k)
        term_to_model = self._term_to_model_map()
        return [
            (self.inv_term_mapping[term_to_model[t]], s) for t, s in out
        ]

    def term_similarity(self, first_index_term_id, second_index_term_id):
        a = self.term_mapping.get(first_index_term_id)
        b = self.term_mapping.get(second_index_term_id)
        if a is None or b is None:
            return None
        return self._engine.term_similarity(self._terms[a], self._terms[b])


# The reference aliases LSE to NVSM (base.py:452).
LSE = NVSM
