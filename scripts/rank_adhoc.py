#!/usr/bin/env python
"""TREC ad-hoc evaluation protocol over validation/test topic splits
(the TOIS 2018 §3.3 Robust04 protocol; splits ship in
/root/reference/resources/adhoc-splits/<collection>/{validation,test}).

Trains NVSM, ranks every dumped epoch on the validation topics, selects the
best epoch by validation MAP, and reports test MAP at that epoch — plus the
alpha=0.5 QLM fusion numbers.

    python scripts/rank_adhoc.py --corpus robust04.trectext \
        --topics topics.txt --qrels qrels.txt \
        --splits /root/reference/resources/adhoc-splits/disk4_disk5_no-cr \
        --workdir /tmp/robust04 [--num_epochs 100]
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True)
    p.add_argument("--topics", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--splits", required=True,
                   help="directory with 'validation' and 'test' topic-id lists")
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=5,
                   help="validate every N epochs")
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=51200)
    p.add_argument("--stopwords", default=None)
    p.add_argument("--platform", default=None)
    p.add_argument("--stream_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--window_sum_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--negative_pool_size", type=int, default=-1)
    p.add_argument("--negative_pool_stride", type=int, default=0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mesh", default=None,
                   help="train under a 'DATAxMODEL' device mesh "
                        "(e.g. 2x4); entity table and optimizer state "
                        "shard over the model axis")
    p.add_argument("--shard_corpus", action="store_true",
                   help="with a mesh + --on_device_sampling: shard the "
                        "device-resident corpus over the data axis "
                        "(multi-card memory)")
    p.add_argument("--on_device_sampling", action="store_true",
                   help="sample batches inside the compiled step (the "
                        "collection-scale fast path)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="steps chained per compiled call (dispatch "
                        "amortization)")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="dump model/resume state every N epochs (collection"
                        "-scale snapshots are large; validation epochs "
                        "should stay on the dump cadence)")
    p.add_argument("--resume", action="store_true",
                   help="continue a crashed/interrupted run from the last "
                        "dumped epoch in --workdir")
    p.add_argument("--fail_after_epoch", type=int, default=0,
                   help="rehearsal hook: raise after this epoch completes "
                        "to exercise crash + --resume recovery")
    from cunvsm.cli._platform import (
        add_distributed_flags, apply_distributed, apply_platform,
    )

    add_distributed_flags(p)
    args = p.parse_args(argv)
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")

    # Epoch selection loads the best VALIDATED epoch's checkpoint; an
    # evaluated epoch whose model was never dumped would fail only after
    # the entire multi-hour run.  Enforce the cadence alignment up front.
    if args.eval_every % args.checkpoint_every:
        p.error(
            f"--eval_every {args.eval_every} must be a multiple of "
            f"--checkpoint_every {args.checkpoint_every}: the best "
            f"validation epoch's checkpoint must exist for the final "
            f"test-set ranking"
        )

    apply_platform(args)
    apply_distributed(args)  # multi-host: before any backend use

    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        DataConfig,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )
    from cunvsm.data.corpus import load_corpus
    from cunvsm.data.text import load_stopwords, tokenize
    from cunvsm.io.trec import read_qrels, read_topics, write_run
    from cunvsm.query.engine import QueryEngine, load_query_engine
    from cunvsm.query.fusion import fuse_fixed_alpha
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.query.qlm import build_qlm_index, qlm_rank
    from cunvsm.train.trainer import train_model

    os.makedirs(args.workdir, exist_ok=True)
    from cunvsm.data.text import lemur_stopwords

    stopwords = (
        load_stopwords(args.stopwords)
        if args.stopwords
        else lemur_stopwords()
    )

    def read_ids(path):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    validation_ids = set(read_ids(os.path.join(args.splits, "validation")))
    test_ids = set(read_ids(os.path.join(args.splits, "test")))

    topics = read_topics(args.topics)
    qrels = read_qrels(args.qrels)
    val_qrels = {q: r for q, r in qrels.items() if q in validation_ids}
    test_qrels = {q: r for q, r in qrels.items() if q in test_ids}

    window = 10
    data_cfg = DataConfig(
        corpus_path=args.corpus,
        max_vocabulary_size=65536,
        min_document_frequency=0,
        max_document_frequency=0.5,
    )
    corpus = load_corpus(data_cfg, window, args.stopwords)
    logging.info("Corpus: %d docs, %d terms.", corpus.num_docs, corpus.vocab.size)

    # Stemmed Indri repositories (typical for TOIS-era Robust04 indexes)
    # hold stemmed vocabulary strings: apply the recorded indexing-time
    # stemmer to topic tokens (data/stemming.py) — the analog of pyndri's
    # dictionary resolution in the reference (py/query.py:111,141-142).
    from cunvsm.data.stemming import QueryStemmer

    stemmer = QueryStemmer(
        corpus.stemmer, corpus.vocab.term_to_id, on_unknown="warn"
    )
    if stemmer.name:
        logging.info("Query stemming: %s.", stemmer.name)
    queries = {
        q: stemmer.stem_tokens(tokenize(t, stopwords))
        for q, t in topics.items()
    }
    val_queries = {q: t for q, t in queries.items() if q in validation_ids}
    test_queries = {q: t for q, t in queries.items() if q in test_ids}
    logging.info(
        "%d validation / %d test topics.", len(val_queries), len(test_queries)
    )

    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        window_size=window,
        num_random_entities=10,
        learning_rate=1e-3,
        regularization_lambda=1e-2,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=args.seed,
        stream_dtype=args.stream_dtype,
        window_sum_dtype=args.window_sum_dtype,
        negative_pool_size=args.negative_pool_size,
        negative_pool_stride=args.negative_pool_stride,
    )
    prefix = os.path.join(args.workdir, "nvsm")
    curve_path = os.path.join(args.workdir, "validation_curve.jsonl")
    if not args.resume and os.path.exists(curve_path):
        # The curve is append-only so --resume can select over pre-crash
        # epochs; a FRESH run in a reused workdir must not inherit the
        # previous run's points (stale epochs would contaminate
        # best-epoch selection).
        os.remove(curve_path)
    t_start = time.time()

    def validate(epoch, params, cost):
        if epoch % args.eval_every and epoch != cfg.num_epochs:
            return
        engine = QueryEngine(
            params,
            corpus.vocab.terms,
            corpus.docnos,
            nonlinearity=None,  # NVSM queried --linear
        )
        run = engine.rank(val_queries, top_k=1000)
        m = evaluate_run(run, val_qrels, measures=("map",))["map"]
        # Persist across crash + --resume: the post-resume process must
        # still select over the pre-crash epochs.  One writer under
        # multi-process (every process computes the same curve).
        from cunvsm.parallel.distributed import is_primary

        if is_primary():
            with open(curve_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "map": m}) + "\n")
        logging.info("Epoch %d validation MAP = %.4f", epoch, m)
        if args.fail_after_epoch and epoch >= args.fail_after_epoch:
            raise RuntimeError(
                f"rehearsal: simulated crash after epoch {epoch}"
            )

    mesh = None
    if args.mesh:
        from cunvsm.parallel.mesh import make_mesh

        d_ax, m_ax = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(d_ax, m_ax)

    train_model(
        desc, cfg, corpus, output_prefix=prefix, epoch_callback=validate,
        mesh=mesh,
        on_device_sampling=args.on_device_sampling,
        shard_corpus=args.shard_corpus,
        steps_per_call=args.steps_per_call,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )

    curve = {}
    with open(curve_path) as f:
        for line in f:
            rec = json.loads(line)
            curve[rec["epoch"]] = rec["map"]  # last write wins per epoch
    validation_curve = sorted(curve.items())
    best_epoch, best_val = max(validation_curve, key=lambda x: x[1])
    logging.info(
        "Best epoch %d (validation MAP %.4f).", best_epoch, best_val
    )

    from cunvsm.parallel.distributed import is_primary

    engine = load_query_engine(prefix, best_epoch, nonlinearity=None)
    nvsm_run = engine.rank(test_queries, top_k=1000)
    if is_primary():
        write_run(
            nvsm_run, os.path.join(args.workdir, "nvsm_test.run"), "nvsm"
        )
    results = {
        "best_epoch": best_epoch,
        "validation_map": best_val,
        "validation_curve": validation_curve,
        "nvsm_test_map": evaluate_run(
            nvsm_run, test_qrels, measures=("map",)
        )["map"],
        "wall_clock_s": round(time.time() - t_start, 1),
        "num_docs": corpus.num_docs,
        "resumed": bool(args.resume),
    }

    qlm_index = build_qlm_index(corpus)
    for name, smoothing, prf in [
        ("qlm_jm_prf", "jm", True),
        ("qlm_dirichlet_prf", "dirichlet", True),
    ]:
        qlm_run = qlm_rank(qlm_index, test_queries, smoothing=smoothing, prf=prf)
        results[f"{name}_test_map"] = evaluate_run(
            qlm_run, test_qrels, measures=("map",)
        )["map"]
        fused = fuse_fixed_alpha(nvsm_run, qlm_run, 0.5)
        results[f"nvsm+{name}_test_map"] = evaluate_run(
            fused, test_qrels, measures=("map",)
        )["map"]

    print(json.dumps(results, indent=2, sort_keys=True))
    if is_primary():
        with open(os.path.join(args.workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
