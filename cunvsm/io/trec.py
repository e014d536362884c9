"""TREC run / topic / qrels file IO (replaces the cvangysel trec-utils
dependency used by py/query.py and py/combine_runs.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple


Run = Dict[str, List[Tuple[str, float]]]  # qid -> [(docno, score) desc]
Qrels = Dict[str, Dict[str, int]]  # qid -> {docno: relevance}


def write_run(run: Run, path: str, name: str = "cunvsm") -> None:
    with open(path, "w") as f:
        for qid in sorted(run):
            ranked = sorted(run[qid], key=lambda x: -x[1])
            for rank, (docno, score) in enumerate(ranked, start=1):
                f.write(f"{qid} Q0 {docno} {rank} {score:.6f} {name}\n")


def read_run(path: str) -> Run:
    run: Run = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, docno, _, score, _ = parts[:6]
            run.setdefault(qid, []).append((docno, float(score)))
    for qid in run:
        run[qid].sort(key=lambda x: -x[1])
    return run


def read_qrels(path: str) -> Qrels:
    qrels: Qrels = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, docno, rel = parts[:4]
            # The reference's product-substitutability qrels carry float
            # relevance ("1.0"); trec_eval semantics are integral grades.
            qrels.setdefault(qid, {})[docno] = int(float(rel))
    return qrels


def read_topics(path: str) -> Dict[str, str]:
    """Read TREC-style topic files.

    Supports the simple ``qid<whitespace>query text`` format and the
    Cranfield-style ``<top><num>...<title>...`` SGML format.
    """
    with open(path) as f:
        data = f.read()
    if "<top>" in data.lower():
        import re

        topics = {}
        for m in re.finditer(
            r"<top>(.*?)</top>", data, re.DOTALL | re.IGNORECASE
        ):
            block = m.group(1)
            num = re.search(
                r"<num>\s*(?:Number:)?\s*([^<\s]+)", block, re.IGNORECASE
            )
            title = re.search(
                r"<title>\s*(.*?)\s*(?=<|$)", block, re.DOTALL | re.IGNORECASE
            )
            if num and title:
                topics[num.group(1).strip()] = " ".join(
                    title.group(1).split()
                )
        return topics
    topics = {}
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        if ";" in line and line.split(";", 1)[0].strip().isdigit():
            # Cranfield-style "qid;query text" lines
            # (test_data/cranfield_collection/cranfield.topics).
            qid, _, text = line.partition(";")
            qid = qid.strip()
        else:
            qid, _, text = line.partition(" ")
        if text.strip():
            topics[qid] = text.strip()
    return topics
