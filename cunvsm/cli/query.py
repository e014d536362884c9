"""cunvsm-query: TREC run generation (cuNVSMQuery / py/query.py rebuild).

The reference fans ranking out over a 16-process pool of host-side sklearn
k-NN searches; here all queries are ranked in one on-device batched matmul +
top-k (query/engine.py), so no pool is needed.

Usage:
    python -m cunvsm.cli.query --topics topics.txt \
        --model <prefix> --epoch N [--linear] [--top_k K|all] run_out
"""

from __future__ import annotations

import argparse
import logging
import sys

from cunvsm.data.text import load_stopwords, tokenize
from cunvsm.io.trec import read_qrels, read_topics, write_run
from cunvsm.query.engine import load_query_engine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loglevel", default="INFO")
    from cunvsm.cli._platform import add_platform_flag

    add_platform_flag(p)
    p.add_argument("--topics", nargs="+", required=True)
    p.add_argument("--model", required=True, help="checkpoint prefix")
    p.add_argument("--epoch", required=True)
    p.add_argument("--linear", action="store_true", default=False,
                   help="no output nonlinearity (the NVSM query preset, "
                        "functions.sh:269-271)")
    p.add_argument("--self_information", action="store_true", default=False)
    p.add_argument("--l2norm_phrase", action="store_true", default=False)
    p.add_argument("--mesh", default=None,
                   help="Shard the document matrix for serving, as "
                        "'DATAxMODEL' (e.g. 1x8) over all visible devices; "
                        "ranking uses per-shard top-k + candidate merge "
                        "(parallel/query.py).")
    p.add_argument("--score_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="Document-matrix dtype for scoring; bfloat16 halves "
                        "the per-query HBM traffic.")
    p.add_argument("--bias_coefficient", type=float, default=0.0)
    p.add_argument("--strict", action="store_true", default=False)
    p.add_argument("--rerank_exact_matching_documents", action="store_true",
                   default=False,
                   help="Restrict each query's candidates to its top-1000 "
                        "TFIDF exact matches (py/query.py:186-205); "
                        "requires --corpus.")
    p.add_argument("--corpus", default=None,
                   help="Corpus path for the exact-match prefilter "
                        "(trectext/jsonl/packed .npz).")
    p.add_argument("--top_k", default=None,
                   help="int, 'all', or a qrels file restricting the "
                        "candidate documents per query")
    p.add_argument("--num_queries", type=int, default=None)
    p.add_argument("--stopwords", default=None)
    p.add_argument("--stemmer", default="auto",
                   help="Query-term stemmer: 'auto' (default) applies the "
                        "stemmer recorded in the checkpoint's "
                        "<prefix>_stemmer.txt sidecar (written when the "
                        "model trained from a stemmed Indri repository), "
                        "'none' disables, or 'krovetz'/'porter' forces one "
                        "(data/stemming.py).")
    p.add_argument("run_out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cunvsm.cli._platform import apply_platform

    apply_platform(args)
    logging.basicConfig(level=args.loglevel)

    import jax.numpy as jnp

    mesh = None
    if args.mesh:
        from cunvsm.parallel.mesh import make_mesh

        data_ax, model_ax = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(data_ax, model_ax)

    engine = load_query_engine(
        args.model,
        args.epoch,
        nonlinearity=None if args.linear else "tanh",
        bias_coefficient=args.bias_coefficient,
        self_information=args.self_information,
        l2norm_phrase=args.l2norm_phrase,
        score_dtype=(
            jnp.bfloat16 if args.score_dtype == "bfloat16" else None
        ),
        mesh=mesh,
    )
    logging.info(
        "Loaded model: %d terms, %d documents.",
        len(engine.term_to_id),
        len(engine.docnos),
    )

    stopwords = load_stopwords(args.stopwords)
    # With multiple topic files the reference writes one run per file,
    # suffixed with the file's basename (query.py:170-173); mirror that.
    per_file = len(args.topics) > 1
    topics = {}
    for path in args.topics:
        file_topics = read_topics(path)
        if args.num_queries is not None:
            file_topics = dict(
                list(file_topics.items())[: args.num_queries]
            )
        if per_file:
            import os as _os

            suffix = _os.path.basename(path)
            file_topics = {
                (qid, suffix): text for qid, text in file_topics.items()
            }
        topics.update(file_topics)
    logging.info("Loaded %d topics.", len(topics))

    # Stemmed repositories (e.g. Krovetz-stemmed Robust04 indexes) hold
    # stemmed vocabulary strings: apply the recorded indexing-time stemmer
    # to query tokens so inflected topic terms hit the vocabulary.
    from cunvsm.data.stemming import QueryStemmer, load_query_stemmer

    if args.stemmer == "auto":
        stemmer = load_query_stemmer(args.model, engine.term_to_id)
    elif args.stemmer == "none":
        stemmer = QueryStemmer(None)
    else:
        stemmer = QueryStemmer(args.stemmer, engine.term_to_id)
    if stemmer.name:
        logging.info("Query stemming: %s.", stemmer.name)

    tokenized = {
        qid: stemmer.stem_tokens(tokenize(text, stopwords))
        for qid, text in topics.items()
    }

    # top_k modes: int | 'all' | qrels-file document sets (query.py:118-139).
    qrel_sets = None
    if args.top_k is None:
        top_k = 1000
    elif args.top_k == "all":
        top_k = len(engine.docnos)
    else:
        try:
            top_k = int(args.top_k)
        except ValueError:
            qrel_sets = read_qrels(args.top_k)
            top_k = None

    if args.rerank_exact_matching_documents:
        # TFIDF prefilter over the corpus: each query's candidate set is its
        # top-1000 exact-matching documents (query.py:186-205).
        if not args.corpus:
            print(
                "--rerank_exact_matching_documents requires --corpus",
                file=sys.stderr,
            )
            return 1
        from cunvsm.config import DataConfig
        from cunvsm.data.corpus import Corpus, load_corpus
        from cunvsm.query.qlm import build_qlm_index, tfidf_rank

        if args.corpus.endswith(".npz"):
            # The TFIDF prefilter doesn't care about the packed corpus's
            # training window.
            corpus = Corpus.load(args.corpus)
        else:
            corpus = load_corpus(
                DataConfig(corpus_path=args.corpus, max_vocabulary_size=0,
                           min_document_frequency=0,
                           max_document_frequency=0),
                window_size=1,
                stopword_path=args.stopwords,
            )
        qlm_index = build_qlm_index(corpus)
        qrel_sets = {
            qid: {d: 1 for d, _ in tfidf_rank(qlm_index, terms, 1000)}
            for qid, terms in tokenized.items()
        }

    if qrel_sets is None:
        run = engine.rank(tokenized, top_k=top_k)
    else:
        run = {}
        for qid, terms in tokenized.items():
            key = qid[0] if isinstance(qid, tuple) else qid
            # The exact-match prefilter keys by the tokenized-dict key; a
            # qrels file keys by the plain topic id.
            docnos = list(qrel_sets.get(qid) or qrel_sets.get(key, {}))
            if not docnos:
                continue
            scored = engine.score_documents(terms, docnos)
            if scored is not None:
                run[qid] = scored

    if per_file:
        import os as _os

        for path in args.topics:
            suffix = _os.path.basename(path)
            sub_run = {
                qid[0]: ranked
                for qid, ranked in run.items()
                if isinstance(qid, tuple) and qid[1] == suffix
            }
            out = f"{args.run_out}-{suffix}"
            write_run(sub_run, out, name="cunvsm")
            logging.info(
                "Run with %d rankings written to %s.", len(sub_run), out
            )
    else:
        write_run(run, args.run_out, name="cunvsm")
        logging.info(
            "Run with %d rankings written to %s.", len(run), args.run_out
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
