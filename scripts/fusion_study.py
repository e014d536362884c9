#!/usr/bin/env python
"""Fusion study over dumped NVSM runs (offline, CPU): the reference's
headline NVSM + QLM-JM + PRF cell (TUTORIAL.md:98, 0.4345 unsupervised
alpha=0.5 standardize) and its supervised sibling (the reference's own
combine_runs CV protocol: 20 folds, alpha grid step 0.01 — supported by
the reference's tool, called 'a bit excessive' for the tutorial).

Also sweeps PRF hyperparameters of OUR QLM-JM-PRF to demonstrate how the
fixed-alpha 0.5 mix responds to the lexical run's standalone strength —
the attribution analysis for the JM cell gap.  The sweep is analysis, not
tuning: the shipped default stays fb_docs=10/fb_terms=10/w=0.5.

Usage:
  python scripts/fusion_study.py --runs_dir /tmp/nvsm_runs \
      [--out results/fusion_study_r4.json]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def cv_map_fast(run_a, run_b, qrels, num_folds=20, alpha_stepsize=0.01,
                seed=0):
    """MAP of query/fusion.fuse_cross_validated, computed exactly but
    factorized: per-query AP at each alpha is fold-independent, so build
    the [num_queries, num_alphas] AP matrix once and do the per-fold
    best-alpha search and test scoring as row/column means.  Same fold
    assignment (RandomState(seed) shuffle + array_split), same
    standardize normalizer, same mean-of-present-scores combination."""
    from cunvsm.query.metrics import average_precision

    alphas = np.arange(0.0, 1.0, alpha_stepsize)
    rng = np.random.RandomState(seed)
    query_ids = list(qrels.keys())
    rng.shuffle(query_ids)
    num_folds = min(num_folds, len(query_ids))
    folds = np.array_split(np.arange(len(query_ids)), num_folds)

    # ap[i, j] = AP of query_ids[i] fused at alphas[j].
    ap = np.zeros((len(query_ids), len(alphas)))
    valid = np.zeros(len(query_ids), bool)
    for i, qid in enumerate(query_ids):
        ra, rb = dict(run_a.get(qid, [])), dict(run_b.get(qid, []))
        docs = list(dict.fromkeys(list(ra) + list(rb)))
        if not docs:
            continue

        def norm(r):
            if not r:
                return {}
            v = np.asarray(list(r.values()))
            mu, sd = v.mean(), v.std()
            return {d: ((s - mu) / sd if sd else 0.0) for d, s in r.items()}

        na, nb = norm(ra), norm(rb)
        a = np.array([na.get(d, np.nan) for d in docs])
        b = np.array([nb.get(d, np.nan) for d in docs])
        in_a, in_b = ~np.isnan(a), ~np.isnan(b)
        denom = in_a.astype(float) + in_b.astype(float)
        a0, b0 = np.where(in_a, a, 0.0), np.where(in_b, b, 0.0)
        rels = qrels[qid]
        rel = np.array([rels.get(d, 0) > 0 for d in docs])
        num_rel = sum(1 for r in rels.values() if r > 0)
        if num_rel == 0:
            continue
        valid[i] = True
        # scores[j, d] for every alpha at once; stable argsort matches
        # the library's stable sort on -score.
        scores = (
            np.outer(alphas, a0) + np.outer(1.0 - alphas, b0)
        ) / denom[None, :]
        order = np.argsort(-scores, axis=1, kind="stable")
        rel_sorted = rel[order]  # [num_alphas, num_docs]
        hits = np.cumsum(rel_sorted, axis=1)
        ranks = np.arange(1, len(docs) + 1)[None, :]
        ap[i] = np.sum(
            np.where(rel_sorted, hits / ranks, 0.0), axis=1
        ) / num_rel

    test_aps = []
    for test_idx in folds:
        test_mask = np.zeros(len(query_ids), bool)
        test_mask[test_idx] = True
        train = valid & ~test_mask
        if not train.any():
            best_j = 0
        else:
            means = ap[train].mean(axis=0)
            # Library tie-break: max() over (mean_ap, alpha) tuples picks
            # the LARGEST alpha among ties.
            best_j = int(np.flatnonzero(means == means.max())[-1])
        test_aps.extend(ap[test_mask & valid, best_j].tolist())
    return float(np.mean(test_aps))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir",
                   default="/root/reference/test_data/cranfield_collection")
    p.add_argument("--runs_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--sweep", action="store_true",
                   help="include the PRF-variant attribution sweep")
    p.add_argument("--cv_grid", action="store_true",
                   help="include the supervised grid-CV protocol: per-fold "
                        "joint selection of the PRF variant (qlm.PRF_GRID) "
                        "and alpha on train queries "
                        "(fusion.fuse_cross_validated_grid) — an honest "
                        "supervised estimate, unlike the --sweep cells")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from cunvsm.config import DataConfig
    from cunvsm.data.corpus import build_corpus
    from cunvsm.data.text import iter_trectext, lemur_stopwords, tokenize
    from cunvsm.io.trec import read_qrels, read_run, read_topics
    from cunvsm.query.fusion import fuse_fixed_alpha
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.query.qlm import build_qlm_index, qlm_rank

    stopwords = lemur_stopwords()
    docs = list(iter_trectext(
        os.path.join(args.data_dir, "cranfield.trectext")))
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=65536, min_document_frequency=0,
                   max_document_frequency=0.5),
        10, stopwords=stopwords,
    )
    topics = read_topics(os.path.join(args.data_dir, "cranfield.topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrels = read_qrels(os.path.join(args.data_dir, "cranfield.qrel"))
    qlm_index = build_qlm_index(corpus)

    def m(run):
        return evaluate_run(run, qrels, measures=("map",))["map"]

    nvsm_runs = {}
    for path in sorted(glob.glob(os.path.join(args.runs_dir, "*.run"))):
        nvsm_runs[os.path.basename(path)] = read_run(path)
    if not nvsm_runs:
        print("no runs found in", args.runs_dir, file=sys.stderr)
        return 1

    results = {"num_nvsm_runs": len(nvsm_runs)}

    # Shipped-default QLM runs.
    jm_prf = qlm_rank(qlm_index, queries, smoothing="jm", prf=True)
    results["qlm_jm_prf_map"] = round(m(jm_prf), 4)

    unsup, sup = [], []
    for name, run in nvsm_runs.items():
        unsup.append(m(fuse_fixed_alpha(run, jm_prf, 0.5)))
        sup.append(cv_map_fast(
            run, jm_prf, qrels, num_folds=20, alpha_stepsize=0.01
        ))
    results["unsupervised_alpha0.5"] = {
        "mean": round(float(np.mean(unsup)), 4),
        "std": round(float(np.std(unsup, ddof=1)), 4),
        "min": round(float(np.min(unsup)), 4),
        "max": round(float(np.max(unsup)), 4),
        "seeds_ge_0.4345": int(np.sum(np.asarray(unsup) >= 0.4345)),
    }
    results["supervised_cv20_step0.01"] = {
        "mean": round(float(np.mean(sup)), 4),
        "std": round(float(np.std(sup, ddof=1)), 4),
        "min": round(float(np.min(sup)), 4),
        "max": round(float(np.max(sup)), 4),
        "seeds_ge_0.4345": int(np.sum(np.asarray(sup) >= 0.4345)),
    }

    if args.cv_grid:
        from cunvsm.query.fusion import fuse_cross_validated_grid
        from cunvsm.query.qlm import prf_variant_runs

        for smoothing in ("jm", "dirichlet"):
            variants = prf_variant_runs(
                qlm_index, queries, smoothing=smoothing
            )
            fused_maps, histogram = [], {}
            for run in nvsm_runs.values():
                fused, selections = fuse_cross_validated_grid(
                    run, variants, qrels, num_folds=20, alpha_stepsize=0.05
                )
                fused_maps.append(m(fused))
                for s in selections:
                    histogram[s["lexical"]] = (
                        histogram.get(s["lexical"], 0) + 1
                    )
            results[f"supervised_cvgrid_{smoothing}"] = {
                "mean": round(float(np.mean(fused_maps)), 4),
                "std": round(float(np.std(fused_maps, ddof=1)), 4)
                if len(fused_maps) > 1 else 0.0,
                "min": round(float(np.min(fused_maps)), 4),
                "max": round(float(np.max(fused_maps)), 4),
                "seeds_ge_0.4345": int(
                    np.sum(np.asarray(fused_maps) >= 0.4345)
                ),
                "fold_variant_histogram": dict(
                    sorted(histogram.items(), key=lambda kv: -kv[1])
                ),
            }

    if args.sweep:
        # Attribution: vary the lexical run's strength, hold NVSM fixed.
        sweep = []
        for fb_docs, fb_terms, ow in [
            (5, 5, 0.5), (10, 5, 0.5), (10, 10, 0.5), (10, 20, 0.5),
            (20, 10, 0.5), (10, 10, 0.3), (10, 10, 0.7), (5, 10, 0.6),
        ]:
            qrun = qlm_rank(
                qlm_index, queries, smoothing="jm", prf=True,
                fb_docs=fb_docs, fb_terms=fb_terms, orig_weight=ow,
            )
            fused = [
                m(fuse_fixed_alpha(r, qrun, 0.5))
                for r in nvsm_runs.values()
            ]
            sweep.append({
                "fb_docs": fb_docs, "fb_terms": fb_terms,
                "orig_weight": ow,
                "qlm_standalone": round(m(qrun), 4),
                "fused_mean": round(float(np.mean(fused)), 4),
            })
        results["prf_attribution_sweep"] = sweep

    print(json.dumps(results, indent=2, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
