#!/usr/bin/env python
"""End-to-end Cranfield pipeline (rank-cranfield-collection.sh rebuild).

corpus -> QLM runs (JM / Dirichlet, +/- PRF) -> train LSE + NVSM -> rank ->
evaluate MAP -> unsupervised alpha=0.5 fusion -> report, against the
reference's published walk-through numbers (TUTORIAL.md:55-100 /
BASELINE.md).

Canonical hyperparameters from scripts/functions.sh:263-271,369-400:
window 10, d_word 300, d_doc 256, 10 negatives, vocab 65536, min df 0,
lr 1e-3, lambda 1e-2, full_adam, 100 epochs; LSE = batch 4096 + tanh +
bias_negative_samples (queried with tanh); NVSM = batch 51200 + hard_tanh +
batch_normalization (queried --linear).

Stopwords: the reference indexes with the Lemur stoplist.dft
(functions.sh:344-350); the vendored copy (data/text.py:lemur_stopwords)
is used here, matching the reference preprocessing exactly.

Usage:
    python scripts/rank_cranfield.py --workdir /tmp/cranfield \
        [--data_dir /root/reference/test_data/cranfield_collection] \
        [--num_epochs 100] [--quick]
"""

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--data_dir",
        default="/root/reference/test_data/cranfield_collection",
    )
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--quick", action="store_true",
                   help="small dims / few epochs for smoke testing")
    p.add_argument("--stream_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--shared_negatives", action="store_true",
                   help="batch-shared negative sampling (GEMM-shaped mode)")
    p.add_argument("--num_negatives", type=int, default=10)
    p.add_argument("--negative_pool_size", type=int, default=-1,
                   help="rolled-pool negative sampling (GEMM-shaped mode "
                        "keeping the exact per-example loss)")
    p.add_argument("--negative_pool_stride", type=int, default=0)
    p.add_argument("--window_sum_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--models", default="lse,nvsm",
                   help="comma-separated subset of models to train")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu)")
    p.add_argument("--mesh", default=None,
                   help="train under a 'DATAxMODEL' device mesh (e.g. 2x4 "
                        "on the 8-virtual-device CPU test platform)")
    p.add_argument("--cross_chip_reduce_dtype", default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="width of the cross-chip word-gradient psum under "
                        "a mesh (TrainConfig.cross_chip_reduce_dtype)")
    p.add_argument("--lexical_runs_dir", default=None,
                   help="directory of externally generated TREC run files "
                        "(e.g. real Indri PRF runs) to fuse the trained "
                        "models against IN ADDITION to the built-in QLM "
                        "runs — the reference's own protocol fuses against "
                        "external Indri tooling "
                        "(rank-cranfield-collection.sh:99-110); every "
                        "*.run / indri-* file in the directory becomes a "
                        "fusion cell named by its basename")
    p.add_argument("--prf_posterior", default="rm1",
                   choices=("rm1", "indri"),
                   help="feedback-document posterior of the built-in PRF "
                        "(query/qlm.py): rm1 = query likelihood; indri = "
                        "geometric-mean reconstruction of Indri's "
                        "RMExpander")
    p.add_argument("--grid_cv_fusion", default="auto",
                   choices=("auto", "on", "off"),
                   help="also report supervised fusion cells where the PRF "
                        "hyperparameters AND alpha are selected per CV fold "
                        "on train queries (qlm.PRF_GRID x 20-fold CV — the "
                        "reference's combine_runs protocol extended to the "
                        "lexical partner; no test-set tuning). auto = on "
                        "for full runs, off under --quick")
    args = p.parse_args(argv)

    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")

    from cunvsm.cli._platform import apply_platform

    apply_platform(args)
    if args.platform:
        import jax

        if args.platform == "cpu" and args.mesh:
            data_axis, model_axis = (int(x) for x in args.mesh.split("x"))
            jax.config.update(
                "jax_num_cpu_devices", data_axis * model_axis
            )

    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        DataConfig,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )
    from cunvsm.data.corpus import build_corpus
    from cunvsm.data.text import iter_trectext, lemur_stopwords, tokenize
    from cunvsm.io.trec import read_qrels, read_topics, write_run
    from cunvsm.query.engine import load_query_engine
    from cunvsm.query.fusion import fuse_fixed_alpha
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.query.qlm import build_qlm_index, qlm_rank
    from cunvsm.train.trainer import train_model

    os.makedirs(args.workdir, exist_ok=True)
    stopwords = lemur_stopwords()

    window = 10
    data_cfg = DataConfig(
        max_vocabulary_size=65536,
        min_document_frequency=0,
        max_document_frequency=0.5,
    )
    docs = list(iter_trectext(os.path.join(args.data_dir, "cranfield.trectext")))
    corpus = build_corpus(docs, data_cfg, window, stopwords=stopwords)
    logging.info(
        "Corpus: %d docs, %d terms, %d occurrences.",
        corpus.num_docs,
        corpus.vocab.size,
        corpus.vocab.total_terms,
    )

    topics = read_topics(os.path.join(args.data_dir, "cranfield.topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrels = read_qrels(os.path.join(args.data_dir, "cranfield.qrel"))

    results = {}

    # ------------------------------------------------------------------ QLM
    qlm_index = build_qlm_index(corpus)
    qlm_runs = {}
    for name, smoothing, prf in [
        ("qlm_jm", "jm", False),
        ("qlm_jm_prf", "jm", True),
        ("qlm_dirichlet", "dirichlet", False),
        ("qlm_dirichlet_prf", "dirichlet", True),
    ]:
        run = qlm_rank(qlm_index, queries, smoothing=smoothing, prf=prf,
                       prf_posterior=args.prf_posterior)
        qlm_runs[name] = run
        write_run(run, os.path.join(args.workdir, f"{name}.run"), name)
        results[name] = evaluate_run(run, qrels, measures=("map",))["map"]
        logging.info("%s MAP = %.4f", name, results[name])

    # ------------------------------------------------------------- training
    if args.quick:
        d_w, d_e, epochs = 64, 48, max(5, args.num_epochs if args.num_epochs < 100 else 10)
        lse_batch, nvsm_batch = 1024, 4096
    else:
        d_w, d_e, epochs = 300, 256, args.num_epochs
        lse_batch, nvsm_batch = 4096, 51200

    base_train = dict(
        num_epochs=epochs,
        window_size=window,
        num_random_entities=args.num_negatives,
        shared_negatives=args.shared_negatives,
        negative_pool_size=args.negative_pool_size,
        negative_pool_stride=args.negative_pool_stride,
        regularization_lambda=1e-2,
        learning_rate=1e-3,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=args.seed,
        stream_dtype=args.stream_dtype,
        window_sum_dtype=args.window_sum_dtype,
        cross_chip_reduce_dtype=args.cross_chip_reduce_dtype,
    )
    mesh = None
    if args.mesh:
        from cunvsm.parallel.mesh import make_mesh

        data_axis, model_axis = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(data_axis, model_axis)

    selected = set(args.models.split(","))
    model_runs = {}
    for model_name, desc, batch_size, query_nl in [
        (
            "lse",
            ModelDesc(
                word_repr_size=d_w,
                entity_repr_size=d_e,
                nonlinearity=Nonlinearity.TANH,
                bias_negative_samples=True,
            ),
            lse_batch,
            "tanh",
        ),
        (
            "nvsm",
            ModelDesc(
                word_repr_size=d_w,
                entity_repr_size=d_e,
                nonlinearity=Nonlinearity.HARD_TANH,
                batch_normalization=True,
            ),
            nvsm_batch,
            None,  # --linear
        ),
    ]:
        if model_name not in selected:
            continue
        cfg = TrainConfig(batch_size=batch_size, **base_train)
        prefix = os.path.join(args.workdir, model_name)
        logging.info("Training %s (%d epochs)...", model_name, epochs)
        train_model(desc, cfg, corpus, output_prefix=prefix, mesh=mesh)

        engine = load_query_engine(prefix, epochs, nonlinearity=query_nl)
        run = engine.rank(queries, top_k=1000)
        model_runs[model_name] = run
        write_run(
            run, os.path.join(args.workdir, f"{model_name}.run"), model_name
        )
        results[model_name] = evaluate_run(run, qrels, measures=("map",))["map"]
        logging.info("%s MAP = %.4f", model_name, results[model_name])

    # --------------------------------------------------------------- fusion
    # Externally supplied lexical runs (the reference's protocol fuses
    # against Indri tooling's own PRF runs) join the fusion grid by
    # basename.
    if args.lexical_runs_dir:
        from cunvsm.io.trec import read_run

        for fname in sorted(os.listdir(args.lexical_runs_dir)):
            path = os.path.join(args.lexical_runs_dir, fname)
            if not os.path.isfile(path):
                continue
            name = f"ext_{os.path.splitext(fname)[0]}"
            qlm_runs[name] = read_run(path)
            results[name] = evaluate_run(
                qlm_runs[name], qrels, measures=("map",)
            )["map"]
            logging.info("%s (external) MAP = %.4f", name, results[name])

    for model_name in sorted(model_runs):
        for qlm_name in sorted(qlm_runs):
            fused = fuse_fixed_alpha(
                model_runs[model_name],
                qlm_runs[qlm_name],
                alpha=0.5,
                normalizer="standardize",
            )
            key = f"{model_name}+{qlm_name}"
            results[key] = evaluate_run(fused, qrels, measures=("map",))["map"]
            logging.info("%s MAP = %.4f", key, results[key])

    # Supervised grid-CV fusion: per-fold joint selection of the PRF
    # variant and alpha on train queries (fuse_cross_validated_grid).
    do_grid_cv = args.grid_cv_fusion == "on" or (
        args.grid_cv_fusion == "auto" and not args.quick
    )
    if do_grid_cv and model_runs:
        from cunvsm.query.fusion import fuse_cross_validated_grid
        from cunvsm.query.qlm import PRF_GRID, prf_variant_runs

        grid_selections = {}
        for smoothing in ("jm", "dirichlet"):
            logging.info(
                "Building PRF grid runs (%s, %d variants)...",
                smoothing, len(PRF_GRID),
            )
            variants = prf_variant_runs(
                qlm_index, queries, smoothing=smoothing,
                prf_posterior=args.prf_posterior,
            )
            for model_name in sorted(model_runs):
                fused, selections = fuse_cross_validated_grid(
                    model_runs[model_name], variants, qrels,
                    num_folds=20, alpha_stepsize=0.05,
                )
                key = f"{model_name}+qlm_{smoothing}_prf_cvgrid"
                results[key] = evaluate_run(
                    fused, qrels, measures=("map",)
                )["map"]
                grid_selections[key] = selections
                logging.info("%s MAP = %.4f", key, results[key])
        with open(
            os.path.join(args.workdir, "grid_cv_selections.json"), "w"
        ) as f:
            json.dump(grid_selections, f, indent=2)

    # --------------------------------------------------------------- report
    reference = {
        # TUTORIAL.md:55-58, 82-83, 93-100.
        "qlm_jm": 0.3900,
        "qlm_jm_prf": 0.4163,
        "qlm_dirichlet": 0.3836,
        "qlm_dirichlet_prf": 0.4086,
        "lse": 0.0388,
        "nvsm": 0.3763,
        "lse+qlm_jm_prf": 0.3896,
        "nvsm+qlm_jm_prf": 0.4345,
        "nvsm+qlm_dirichlet_prf": 0.4264,
    }
    print("\n=== Cranfield MAP (ours vs reference TUTORIAL.md) ===")
    for k in sorted(results):
        ref = reference.get(k)
        ref_s = f"{ref:.4f}" if ref is not None else "  --  "
        print(f"{k:28s} {results[k]:.4f}   (reference {ref_s})")

    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
