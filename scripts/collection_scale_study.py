"""Collection-scale quality study of the negative-sampling modes.

The Cranfield quality table (PERFORMANCE.md) validates pooled negatives at
1,398 documents — a regime where a 2048-row pool covers the whole
collection every step.  This study tests the regime the rebuild actually
targets: a synthetic mixture-of-topics corpus of 64k documents (a P=2048
pool covers ~3%), trained per-instance vs rolled-pool, evaluated by MAP of
held-out topical queries against planted relevance (all docs of the
query's topic).

Corpus: T topics over a 32k vocabulary.  Each topic owns a head of ~60
topic words (Zipf-weighted); a document draws ~70% of its ~120 tokens from
its topic head and 30% from a global Zipf background.  Queries sample 4
distinct head words of a topic.  Everything is generated from a fixed
numpy seed, independent of the training seed.

Runs train with on-device sampling + multi-step scan (the collection-scale
execution path) and append one JSON line per (config, seed) to --out.

Usage:
  python scripts/collection_scale_study.py --out /tmp/cs.jsonl \
      --config pool2048_s205 --seeds 1,2,3,4,5 [--num_docs 65536]
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

CONFIGS = {
    "perinst": dict(negative_pool_size=0),
    "pool2048": dict(negative_pool_size=2048),
    "pool2048_s205": dict(negative_pool_size=2048, negative_pool_stride=205),
    "pool12800_s1281": dict(
        negative_pool_size=12800, negative_pool_stride=1281
    ),
    # The shard_corpus epoch-shuffle relaxation (per-group shuffle,
    # stratified batches over 8 token-balanced document groups) simulated
    # on one device — quality A/B against pool2048_s205's global shuffle.
    "pool2048_s205_strat8": dict(
        negative_pool_size=2048, negative_pool_stride=205, _stratify=8
    ),
}

VOCAB = 32768
TOPICS = 256
DOC_LEN = 120
TOPIC_HEAD = 60
TOPIC_FRACTION = 0.7
NUM_QUERIES = 512
QUERY_TERMS = 4


def make_corpus(num_docs: int, gen_seed: int = 12345):

    rng = np.random.RandomState(gen_seed)
    # Global Zipf background over the full vocabulary.
    bg_p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    bg_p /= bg_p.sum()
    # Topic heads: distinct word subsets with Zipfy in-topic weights.
    heads = np.stack([
        rng.choice(VOCAB, TOPIC_HEAD, replace=False, p=bg_p)
        for _ in range(TOPICS)
    ])  # [T, TOPIC_HEAD]
    head_p = 1.0 / np.arange(1, TOPIC_HEAD + 1) ** 0.9
    head_p /= head_p.sum()

    doc_topics = rng.randint(0, TOPICS, num_docs)
    n_topic = int(DOC_LEN * TOPIC_FRACTION)
    n_bg = DOC_LEN - n_topic
    topic_slots = heads[doc_topics][
        np.arange(num_docs)[:, None],
        rng.choice(TOPIC_HEAD, (num_docs, n_topic), p=head_p),
    ]
    bg_slots = rng.choice(VOCAB, (num_docs, n_bg), p=bg_p)
    docs = np.concatenate([topic_slots, bg_slots], axis=1)
    # Shuffle token positions within each document.
    perm = np.argsort(rng.rand(num_docs, DOC_LEN), axis=1)
    docs = np.take_along_axis(docs, perm, axis=1).astype(np.int32)

    from cunvsm.data.synth import corpus_from_tokens

    corpus = corpus_from_tokens(docs.reshape(-1), num_docs, DOC_LEN, VOCAB)

    # Held-out queries: 4 distinct head words of a topic; relevance = all
    # documents of that topic.
    q_topics = rng.randint(0, TOPICS, NUM_QUERIES)
    q_words = heads[q_topics][
        np.arange(NUM_QUERIES)[:, None],
        np.stack([
            rng.choice(TOPIC_HEAD, QUERY_TERMS, replace=False, p=head_p)
            for _ in range(NUM_QUERIES)
        ]),
    ]
    queries = {
        str(qi): [f"t{w}" for w in q_words[qi]]
        for qi in range(NUM_QUERIES)
    }
    qrels = {
        str(qi): {
            f"d{d}": 1 for d in np.flatnonzero(doc_topics == q_topics[qi])
        }
        for qi in range(NUM_QUERIES)
    }
    return corpus, queries, qrels


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--seeds", default="1,2,3,4,5")
    p.add_argument("--num_docs", type=int, default=65536)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--steps_per_call", type=int, default=16)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    from cunvsm.cli._platform import apply_platform

    apply_platform(args)

    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.query.engine import QueryEngine
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.train.trainer import train_model

    corpus, queries, qrels = make_corpus(args.num_docs)
    logging.info(
        "Synthetic corpus: %d docs, %d tokens, %d queries.",
        corpus.num_docs, len(corpus.tokens), len(queries),
    )
    desc = ModelDesc(
        word_repr_size=300, entity_repr_size=256,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    overrides = dict(CONFIGS[args.config])
    stratify = overrides.pop("_stratify", 0)
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
        result = train_model(
            desc, cfg, corpus,
            on_device_sampling=True,
            steps_per_call=args.steps_per_call,
            stratify_data_groups=stratify,
        )
        engine = QueryEngine(
            result.params, corpus.vocab.terms, corpus.docnos,
            term_frequencies=corpus.vocab.term_freq,
            total_terms=corpus.vocab.total_terms,
            nonlinearity=None,
            score_dtype="bfloat16",
        )
        run = engine.rank(queries, top_k=1000)
        m = evaluate_run(run, qrels, measures=("map",))["map"]
        line = {
            "config": args.config, "seed": seed,
            "num_docs": args.num_docs, "epochs": args.num_epochs,
            "map": round(m, 4),
            "minutes": round((time.time() - start) / 60.0, 1),
        }
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        logging.info("RESULT %s", json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
