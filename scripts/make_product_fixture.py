#!/usr/bin/env python
"""Synthesize a product-text corpus for the CIKM product-substitutability
protocol rehearsal (`scripts/product_substitutability.py`).

The reference ships the REAL evaluation resources for the
sports_and_outdoors category (`resources/product-substitutability/
sports_and_outdoors/`): 2,087 topics, validation/test qrels, the 65,536-id
product list, and the 102,863-pair substitutes graph.  Only the Amazon
product text (descriptions + reviews) is licensed data absent from this
environment — this script synthesizes it, consistent with the real
evaluation structure:

* every product in product_list gets a TRECTEXT document;
* a product relevant to a topic is salted with that topic's words — but
  only with probability --salt_fraction (default 0.6): the unsalted
  relevant products are textually indistinguishable from background, so
  a text-only model cannot retrieve them;
* the real substitutes graph connects relevant products to each other
  (measured and reported by this script), which is exactly the signal the
  Mix 'n Match document/document similarity objective injects — the
  protocol rehearsal can therefore demonstrate the composite objective
  recovering relevance that text alone cannot, against the reference's
  own qrels.

Quality numbers from this fixture are against planted text (the qrels and
graph are real, the corpus is not); it rehearses the machinery, not the
published CIKM numbers.

    python scripts/make_product_fixture.py \
        --resources /root/reference/resources/product-substitutability/sports_and_outdoors \
        --out /tmp/products --doc_len 48
"""

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

BACKGROUND_VOCAB = 30000


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resources", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--doc_len", type=int, default=48)
    p.add_argument("--salt_fraction", type=float, default=0.6,
                   help="fraction of a topic's relevant products whose "
                        "text carries the topic's words")
    p.add_argument("--salt_tokens", type=int, default=10,
                   help="topic-word tokens planted per salted product")
    p.add_argument("--gen_seed", type=int, default=777)
    args = p.parse_args(argv)

    t0 = time.time()
    rng = np.random.RandomState(args.gen_seed)
    res = args.resources

    from cunvsm.io.trec import read_qrels, read_topics

    with open(os.path.join(res, "product_list")) as f:
        products = [line.strip() for line in f if line.strip()]
    topics = {
        qid: text.split()
        for qid, text in read_topics(os.path.join(res, "topics")).items()
    }

    rel = collections.defaultdict(set)  # product -> topic ids
    for name in ("qrel_validation", "qrel_test"):
        for qid, docs in read_qrels(os.path.join(res, name)).items():
            for prod, grade in docs.items():
                if grade > 0:
                    rel[prod].add(qid)

    # Measure how strongly the REAL substitutes graph connects relevant
    # products of the same topic — the signal Mix 'n Match injects.
    edges = []
    with open(os.path.join(res, "substitutes")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                edges.append((parts[0], parts[1]))
    shared = sum(
        1 for a, b in edges if rel.get(a, set()) & rel.get(b, set())
    )

    # Choose which relevant products carry their topics' words: a fixed
    # per-product coin so a product relevant to several topics is either
    # textual or graph-only for all of them.
    salted = {
        prod for prod in rel if rng.rand() < args.salt_fraction
    }

    os.makedirs(args.out, exist_ok=True)
    corpus_path = os.path.join(args.out, "corpus.trectext")
    n_salted_tokens = args.salt_tokens
    with open(corpus_path, "w") as f:
        for prod in products:
            body = [
                f"bg{w}" for w in rng.randint(
                    0, BACKGROUND_VOCAB, args.doc_len
                )
            ]
            if prod in salted:
                words = []
                for qid in sorted(rel[prod]):
                    words.extend(topics.get(qid, []))
                if words:
                    take = [
                        words[i] for i in rng.randint(
                            0, len(words), n_salted_tokens
                        )
                    ]
                    pos = rng.choice(
                        args.doc_len, min(len(take), args.doc_len),
                        replace=False,
                    )
                    for j, w in zip(pos, take):
                        body[j] = w
            f.write(
                "<DOC>\n<DOCNO>%s</DOCNO>\n<TEXT>\n%s\n</TEXT>\n</DOC>\n"
                % (prod, " ".join(body))
            )

    with open(os.path.join(args.out, "salted_products.txt"), "w") as f:
        f.write("\n".join(sorted(salted)) + "\n")

    stats = {
        "num_products": len(products),
        "num_topics": len(topics),
        "num_relevant_products": len(rel),
        "num_salted_relevant": len(salted),
        "salt_fraction": args.salt_fraction,
        "substitute_edges": len(edges),
        "edges_linking_same_topic_relevants": shared,
        "doc_len": args.doc_len,
        "corpus_path": corpus_path,
        "seconds": round(time.time() - t0, 1),
    }
    with open(os.path.join(args.out, "fixture_stats.json"), "w") as f:
        json.dump(stats, f, indent=2, sort_keys=True)
    print(json.dumps(stats, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
