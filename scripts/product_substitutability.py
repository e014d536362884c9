#!/usr/bin/env python
"""Mix 'n Match product-substitutability pipeline (CIKM 2018 protocol;
PRODUCT_SUBSTITUTABILITY.md rebuild).

Given a product corpus (each document = a product's description + reviews,
TRECTEXT with the product id as DOCNO), a substitutes file of
``id1 id2 weight`` lines, topics, and validation/test qrels (the evaluation
resources ship with the reference under
/root/reference/resources/product-substitutability/<category>/):

1. trains NVSM with the document/document similarity objective mixed in
   (--entity_similarity_weight, the TextEntityEntityEntity composite);
2. selects the best epoch on the validation qrels;
3. reports test MAP/nDCG, optionally against a text-only baseline.

    python scripts/product_substitutability.py \
        --corpus electronics.trectext --substitutes substitutes \
        --resources /root/reference/resources/product-substitutability/electronics \
        --workdir /tmp/electronics --entity_similarity_weight 0.1
"""

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True)
    p.add_argument("--substitutes", required=True)
    p.add_argument("--resources", required=True,
                   help="directory with product_list, topics, qrel_test, "
                        "qrel_validation")
    p.add_argument("--workdir", required=True)
    p.add_argument("--entity_similarity_weight", type=float, default=0.1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=51200)
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--train_text_only_baseline", action="store_true")
    p.add_argument("--planted_split", default=None,
                   help="salted_products.txt from make_product_fixture.py: "
                        "adds text-visible/-invisible test metrics to the "
                        "report (synthetic-fixture attribution)")
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")

    from cunvsm.cli._platform import apply_platform

    apply_platform(args)


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
    from cunvsm.data.sources import SimilaritySource, load_similarities
    from cunvsm.data.text import tokenize
    from cunvsm.io.trec import read_qrels, read_topics, write_run
    from cunvsm.query.engine import QueryEngine
    from cunvsm.query.metrics import evaluate_run
    from cunvsm.train.trainer import train_model

    os.makedirs(args.workdir, exist_ok=True)
    from cunvsm.data.text import lemur_stopwords

    stopwords = lemur_stopwords()
    # The corpus must be stopword-filtered like the queries (the reference
    # indexes with a stoplist, functions.sh:344-350); load_corpus takes a
    # file path.
    stopword_path = os.path.join(args.workdir, "stopwords.txt")
    with open(stopword_path, "w") as f:
        f.write("\n".join(sorted(stopwords)) + "\n")

    with open(os.path.join(args.resources, "product_list")) as f:
        product_list = [line.strip() for line in f if line.strip()]
    topics = read_topics(os.path.join(args.resources, "topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrel_val = read_qrels(os.path.join(args.resources, "qrel_validation"))
    qrel_test = read_qrels(os.path.join(args.resources, "qrel_test"))

    window = 10
    data_cfg = DataConfig(
        corpus_path=args.corpus,
        max_vocabulary_size=65536,
        min_document_frequency=2,
        max_document_frequency=0.5,
        document_list=None,
    )
    corpus = load_corpus(data_cfg, window, stopword_path)
    # Restrict to the evaluation product list where provided.
    logging.info(
        "Corpus: %d products, %d terms.", corpus.num_docs, corpus.vocab.size
    )

    ids, weights = load_similarities(args.substitutes, corpus.docno_to_id())
    logging.info("Loaded %d substitute pairs.", len(ids))

    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )

    planted_visible = None
    if args.planted_split:
        with open(args.planted_split) as f:
            planted_visible = {line.strip() for line in f if line.strip()}

    def run_training(sim_weight, tag):
        cfg = TrainConfig(
            num_epochs=args.num_epochs,
            batch_size=args.batch_size,
            window_size=window,
            num_random_entities=10,
            learning_rate=1e-3,
            regularization_lambda=1e-2,
            update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            text_entity_weight=1.0 - sim_weight,
            entity_entity_weight=sim_weight,
            seed=1,
        )
        sim_source = (
            SimilaritySource(ids, weights, cfg.batch_size, seed=1)
            if sim_weight > 0
            else None
        )
        curve = []

        def validate(epoch, params, cost):
            if epoch % args.eval_every and epoch != cfg.num_epochs:
                return
            engine = QueryEngine(
                params, corpus.vocab.terms, corpus.docnos, nonlinearity=None
            )
            run = engine.rank(queries, top_k=1000)
            m = evaluate_run(run, qrel_val, measures=("map",))["map"]
            curve.append((epoch, m, run))
            logging.info("[%s] epoch %d validation MAP=%.4f", tag, epoch, m)

        train_model(
            desc,
            cfg,
            corpus,
            similarity_source=sim_source,
            epoch_callback=validate,
        )
        best_epoch, best_val, _ = max(curve, key=lambda x: x[1])
        # The validation callback cached each evaluated epoch's full run;
        # score the best epoch's cached run on the test qrels.
        best_run = next(r for e, m, r in curve if e == best_epoch)
        test_metrics = evaluate_run(
            best_run, qrel_test, measures=("map", "ndcg_10")
        )
        write_run(
            best_run, os.path.join(args.workdir, f"{tag}.run"), tag
        )
        out = {
            "best_epoch": best_epoch,
            "validation_map": best_val,
            "test_map": test_metrics["map"],
            "test_ndcg_10": test_metrics["ndcg_10"],
        }
        if planted_visible is not None:
            # Synthetic-fixture attribution (make_product_fixture.py):
            # split the test qrels into text-visible (salted) and
            # text-invisible products; only the similarity stream can
            # surface the latter, so their recall isolates the Mix 'n
            # Match injection's effect from the text objective's.
            for name, keep in (
                ("text_visible", lambda p: p in planted_visible),
                ("text_invisible", lambda p: p not in planted_visible),
            ):
                sub = {
                    q: {p: r for p, r in d.items() if keep(p)}
                    for q, d in qrel_test.items()
                }
                sub = {q: d for q, d in sub.items() if d}
                m = evaluate_run(
                    best_run, sub, measures=("map", "recall_1000")
                )
                out[f"test_{name}"] = {
                    k: round(v, 4) for k, v in m.items()
                }
        return out

    results = {
        "mix_n_match": run_training(
            args.entity_similarity_weight, "mix_n_match"
        )
    }
    if args.train_text_only_baseline:
        results["text_only"] = run_training(0.0, "text_only")

    print(json.dumps(results, indent=2, sort_keys=True))
    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
