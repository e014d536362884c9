"""Retrieval evaluation metrics (trec_eval semantics).

The reference pipelines shell out to trec_eval and py/combine_runs.py uses
pytrec_eval; neither is available here, so the needed measures are
implemented directly.  MAP follows trec_eval: AP is normalized by the total
number of relevant documents (relevance > 0) in the qrels, not by the number
retrieved; queries absent from the qrels or with no relevant documents are
excluded from the mean.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from cunvsm.io.trec import Qrels, Run


def average_precision(
    ranked: List[Tuple[str, float]], rels: Dict[str, int]
) -> Optional[float]:
    num_rel = sum(1 for r in rels.values() if r > 0)
    if num_rel == 0:
        return None
    hits = 0
    ap = 0.0
    for rank, (docno, _) in enumerate(ranked, start=1):
        if rels.get(docno, 0) > 0:
            hits += 1
            ap += hits / rank
    return ap / num_rel


def precision_at(
    ranked: List[Tuple[str, float]], rels: Dict[str, int], k: int
) -> float:
    hits = sum(1 for docno, _ in ranked[:k] if rels.get(docno, 0) > 0)
    return hits / k


def recall_at(
    ranked: List[Tuple[str, float]], rels: Dict[str, int], k: int
) -> Optional[float]:
    num_rel = sum(1 for r in rels.values() if r > 0)
    if num_rel == 0:
        return None
    hits = sum(1 for docno, _ in ranked[:k] if rels.get(docno, 0) > 0)
    return hits / num_rel


def ndcg_at(
    ranked: List[Tuple[str, float]], rels: Dict[str, int], k: int
) -> Optional[float]:
    gains = sorted((r for r in rels.values() if r > 0), reverse=True)
    if not gains:
        return None
    dcg = sum(
        (2 ** rels.get(docno, 0) - 1) / math.log2(rank + 1)
        for rank, (docno, _) in enumerate(ranked[:k], start=1)
    )
    idcg = sum(
        (2 ** g - 1) / math.log2(rank + 1)
        for rank, g in enumerate(gains[:k], start=1)
    )
    return dcg / idcg if idcg > 0 else None


def evaluate_run(
    run: Run, qrels: Qrels, measures=("map", "p_10", "ndcg_10", "recall_1000")
) -> Dict[str, float]:
    """Mean measures over the queries present in the qrels."""
    per_query: Dict[str, List[float]] = {m: [] for m in measures}
    for qid, rels in qrels.items():
        ranked = run.get(qid, [])
        for m in measures:
            if m == "map":
                v = average_precision(ranked, rels)
            elif m.startswith("p_"):
                v = precision_at(ranked, rels, int(m[2:]))
            elif m.startswith("ndcg_"):
                v = ndcg_at(ranked, rels, int(m[5:]))
            elif m.startswith("recall_"):
                v = recall_at(ranked, rels, int(m[7:]))
            else:
                raise ValueError(f"unknown measure {m}")
            if v is not None:
                per_query[m].append(v)
    return {
        m: (sum(vs) / len(vs) if vs else 0.0) for m, vs in per_query.items()
    }
