"""Multi-seed Cranfield NVSM quality campaign (GPU or CPU).

Trains the canonical NVSM configuration (functions.sh:263-271,369-400)
across a grid of (sampling-config, seed) pairs and appends one JSON line
per run with standalone MAP and the NVSM+QLM-Dirichlet+PRF fusion MAP —
the statistics PERFORMANCE.md's quality table is built from.  All seeds of
one config run in the same process so the jit cache amortizes the remote
compile.

Usage:
  python scripts/quality_seeds.py --out /tmp/quality.jsonl \
      --config pool2048_s205 --seeds 1,2,3,4,5,6,7,8
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONFIGS = {
    # name -> TrainConfig overrides (all on bf16 streams + bf16 window sums)
    "auto": dict(),  # the literal shipped default (scale-aware resolution)
    "perinst": dict(negative_pool_size=0),
    "pool2048": dict(negative_pool_size=2048),
    "pool2048_s205": dict(negative_pool_size=2048, negative_pool_stride=205),
    "pool5120": dict(negative_pool_size=5120),
    "pool5120_s511": dict(negative_pool_size=5120, negative_pool_stride=511),
    "pool10240": dict(negative_pool_size=10240),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir",
                   default="/root/reference/test_data/cranfield_collection")
    p.add_argument("--out", required=True)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--platform", default=None)
    p.add_argument("--dump_runs", default=None,
                   help="directory to write per-seed NVSM TREC runs into "
                        "(offline fusion experiments without retraining)")
    args = p.parse_args(argv)

    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    from cunvsm.cli._platform import apply_platform

    apply_platform(args)

    from cunvsm.config import (
        AdamConfig, AdamMode, DataConfig, ModelDesc, Nonlinearity,
        TrainConfig, UpdateMethod,
    )
    from cunvsm.data.corpus import build_corpus
    from cunvsm.data.text import iter_trectext, lemur_stopwords, tokenize
    from cunvsm.io.trec import read_qrels, read_topics
    from cunvsm.query.engine import QueryEngine
    from cunvsm.query.fusion import fuse_fixed_alpha
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.query.qlm import build_qlm_index, qlm_rank
    from cunvsm.train.trainer import train_model

    import numpy as np

    stopwords = lemur_stopwords()
    data_cfg = DataConfig(
        max_vocabulary_size=65536, min_document_frequency=0,
        max_document_frequency=0.5,
    )
    docs = list(
        iter_trectext(os.path.join(args.data_dir, "cranfield.trectext"))
    )
    corpus = build_corpus(docs, data_cfg, 10, stopwords=stopwords)
    topics = read_topics(os.path.join(args.data_dir, "cranfield.topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrels = read_qrels(os.path.join(args.data_dir, "cranfield.qrel"))

    qlm_index = build_qlm_index(corpus)
    qlm_runs = {
        "dirichlet_prf": qlm_rank(
            qlm_index, queries, smoothing="dirichlet", prf=True
        ),
        # The reference's TUTORIAL headline cell (NVSM + QLM-JM + PRF,
        # 0.4345 at its single seed, TUTORIAL.md:98).
        "jm_prf": qlm_rank(qlm_index, queries, smoothing="jm", prf=True),
    }

    desc = ModelDesc(
        word_repr_size=300, entity_repr_size=256,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    overrides = CONFIGS[args.config]
    freqs = np.asarray(corpus.vocab.term_freq, dtype=np.int64)

    for seed in [int(s) for s in args.seeds.split(",")]:
        cfg = TrainConfig(
            num_epochs=args.num_epochs, batch_size=51200, window_size=10,
            num_random_entities=10, regularization_lambda=1e-2,
            learning_rate=1e-3, update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            seed=seed, stream_dtype="bfloat16",
            window_sum_dtype="bfloat16",
            **overrides,
        )
        start = time.time()
        result = train_model(desc, cfg, corpus)
        engine = QueryEngine(
            result.params, corpus.vocab.terms, corpus.docnos,
            term_frequencies=freqs,
            total_terms=corpus.vocab.total_terms,
            nonlinearity=None,  # --linear, the NVSM query preset
        )
        run = engine.rank(queries, top_k=1000)
        if args.dump_runs:
            from cunvsm.io.trec import write_run

            os.makedirs(args.dump_runs, exist_ok=True)
            write_run(
                run,
                os.path.join(
                    args.dump_runs, f"nvsm_{args.config}_s{seed}.run"
                ),
                "nvsm",
            )
        m = evaluate_run(run, qrels, measures=("map",))["map"]
        line = {
            "config": args.config, "seed": seed,
            "map": round(m, 4),
            "minutes": round((time.time() - start) / 60.0, 1),
        }
        for name, qlm_run in qlm_runs.items():
            fused = fuse_fixed_alpha(
                run, qlm_run, alpha=0.5, normalizer="standardize"
            )
            line[f"fusion_{name}_map"] = round(
                evaluate_run(fused, qrels, measures=("map",))["map"], 4
            )
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        logging.info("RESULT %s", json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
