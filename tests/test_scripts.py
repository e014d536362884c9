"""End-to-end pipeline-script tests on synthetic collections."""

import json
import os
import random
import sys

import pytest

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
sys.path.insert(0, SCRIPTS)


@pytest.fixture
def adhoc_collection(tmp_path):
    """Structured synthetic TREC setup: 12 topics, each owning 5 documents
    salted with its query words."""
    random.seed(0)
    vocab = [f"w{i}" for i in range(300)]
    with open(tmp_path / "corpus.trectext", "w") as f:
        for i in range(60):
            topic_words = [vocab[(i % 12) * 20 + j] for j in range(8)]
            body = " ".join(random.choices(vocab, k=40) + topic_words * 6)
            f.write(
                f"<DOC>\n<DOCNO>d{i}</DOCNO>\n<TEXT>\n{body}\n</TEXT>\n</DOC>\n"
            )
    with open(tmp_path / "topics.txt", "w") as f:
        for q in range(12):
            words = " ".join(vocab[q * 20 + j] for j in range(4))
            f.write(f"{q + 1} {words}\n")
    with open(tmp_path / "qrels.txt", "w") as f:
        for q in range(12):
            for i in range(60):
                if i % 12 == q:
                    f.write(f"{q + 1} 0 d{i} 1\n")
    os.makedirs(tmp_path / "splits", exist_ok=True)
    (tmp_path / "splits" / "validation").write_text(
        "\n".join(str(q + 1) for q in range(6)) + "\n"
    )
    (tmp_path / "splits" / "test").write_text(
        "\n".join(str(q + 1) for q in range(6, 12)) + "\n"
    )
    return tmp_path


def test_rank_adhoc_protocol(adhoc_collection, tmp_path):
    """The Robust04-style protocol end to end: train -> per-epoch
    validation -> best-epoch selection -> test MAP + fusion."""
    import rank_adhoc

    workdir = tmp_path / "out"
    rc = rank_adhoc.main([
        "--corpus", str(adhoc_collection / "corpus.trectext"),
        "--topics", str(adhoc_collection / "topics.txt"),
        "--qrels", str(adhoc_collection / "qrels.txt"),
        "--splits", str(adhoc_collection / "splits"),
        "--workdir", str(workdir),
        "--num_epochs", "4", "--eval_every", "2",
        "--word_repr_size", "16", "--entity_repr_size", "16",
        "--batch_size", "256",
    ])
    assert rc in (0, None)
    results = json.load(open(workdir / "results.json"))
    # The lexical ranker must solve this synthetic task outright, and the
    # trained model must add real signal over random (random MAP ~0.08).
    assert results["qlm_jm_prf_test_map"] > 0.95
    assert results["nvsm_test_map"] > 0.3
    assert results["best_epoch"] in (2, 4)


def test_collection_scale_corpus_generator():
    """The synthetic study corpus is deterministic, well-formed, and its
    planted relevance is sane (scripts/collection_scale_study.py)."""
    import importlib.util

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "collection_scale_study",
        os.path.join(SCRIPTS, "collection_scale_study.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    corpus, queries, qrels = mod.make_corpus(512)
    corpus2, _, _ = mod.make_corpus(512)
    np.testing.assert_array_equal(corpus.tokens, corpus2.tokens)
    assert corpus.num_docs == 512
    assert corpus.tokens.min() >= 0 and corpus.tokens.max() < mod.VOCAB
    assert len(queries) == mod.NUM_QUERIES
    # Every query has at least one relevant doc on average-sized corpora
    # (512 docs / 256 topics ~ 2 per topic; allow empty for rare topics).
    non_empty = sum(1 for r in qrels.values() if r)
    assert non_empty > mod.NUM_QUERIES * 0.8
    # Query terms come from the corpus vocabulary.
    for terms in list(queries.values())[:10]:
        for t in terms:
            assert t in corpus.vocab.term_to_id


def test_quality_stats_summarizer(tmp_path, capsys):
    import importlib.util
    import json as _json

    path = tmp_path / "q.jsonl"
    rows = [
        {"config": "perinst", "seed": s, "map": 0.90 + 0.001 * s}
        for s in range(5)
    ] + [
        {"config": "pooled", "seed": s, "map": 0.91 + 0.001 * s}
        for s in range(5)
    ]
    path.write_text("\n".join(_json.dumps(r) for r in rows) + "\n")

    spec = importlib.util.spec_from_file_location(
        "quality_stats", os.path.join(SCRIPTS, "quality_stats.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import sys

    argv = sys.argv
    sys.argv = ["quality_stats.py", str(path), "--baseline", "perinst"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "perinst" in out and "pooled" in out
    assert "diff=+0.0100" in out


def test_rank_adhoc_protocol_on_multi_index_indri_repo(
    adhoc_collection, tmp_path
):
    """The same Robust04-style protocol consuming a MULTI-INDEX Indri
    repository directly (the round-3 ingestion path): fixture-written
    two-index repo -> load_corpus dispatch -> train -> split protocol."""
    import rank_adhoc

    from cunvsm.data.text import iter_trectext, tokenize
    from tests.indri_fixture import write_repository

    docs = [
        (docno, tokenize(text, frozenset()))
        for docno, text in iter_trectext(
            str(adhoc_collection / "corpus.trectext")
        )
    ]
    repo = str(tmp_path / "repo")
    write_repository(repo, [docs[:25], docs[25:]])

    workdir = tmp_path / "out_indri"
    rc = rank_adhoc.main([
        "--corpus", repo,
        "--topics", str(adhoc_collection / "topics.txt"),
        "--qrels", str(adhoc_collection / "qrels.txt"),
        "--splits", str(adhoc_collection / "splits"),
        "--workdir", str(workdir),
        "--num_epochs", "4", "--eval_every", "2",
        "--word_repr_size", "16", "--entity_repr_size", "16",
        "--batch_size", "256",
    ])
    assert rc in (0, None)
    results = json.load(open(workdir / "results.json"))
    assert results["qlm_jm_prf_test_map"] > 0.95
    assert results["nvsm_test_map"] > 0.3


def test_fusion_study_fast_cv_matches_library():
    # cv_map_fast factorizes the fold/alpha search; it must equal
    # fuse_cross_validated + evaluate_run exactly on the same protocol.
    import numpy as np

    from cunvsm.query.fusion import fuse_cross_validated
    from cunvsm.query.metrics import evaluate_run
    from fusion_study import cv_map_fast

    rng = np.random.RandomState(3)
    docs = [f"d{i}" for i in range(40)]
    qrels = {
        f"q{q}": {d: 1 for d in rng.choice(docs, 6, replace=False)}
        for q in range(15)
    }

    def mkrun(seed, quality):
        r = np.random.RandomState(seed)
        run = {}
        for q in range(15):
            scores = r.rand(len(docs))
            for j, d in enumerate(docs):
                if d in qrels[f"q{q}"]:
                    scores[j] += quality * r.rand()
            order = np.argsort(-scores)
            run[f"q{q}"] = [(docs[j], float(scores[j])) for j in order]
        return run

    run_a, run_b = mkrun(1, 1.2), mkrun(2, 0.5)
    for folds, step in [(5, 0.1), (4, 0.25)]:
        lib = evaluate_run(
            fuse_cross_validated(
                run_a, run_b, qrels, num_folds=folds, alpha_stepsize=step
            ),
            qrels, measures=("map",),
        )["map"]
        fast = cv_map_fast(
            run_a, run_b, qrels, num_folds=folds, alpha_stepsize=step
        )
        assert abs(lib - fast) < 1e-9, (lib, fast)


def test_reference_adhoc_splits_and_product_resources_parse():
    # The protocol scripts must consume the REFERENCE'S OWN evaluation
    # resources directly: the TOIS adhoc splits (plain topic-id lists in
    # validation/test) and the CIKM product-substitutability files
    # (topics 'id;text', float-graded qrels, product_list, substitutes).
    import os

    from cunvsm.io.trec import read_qrels, read_topics

    splits = "/root/reference/resources/adhoc-splits"
    if not os.path.isdir(splits):
        pytest.skip("reference checkout not available")
    for collection in os.listdir(splits):
        for part in ("validation", "test"):
            path = os.path.join(splits, collection, part)
            with open(path) as f:
                ids = [line.strip() for line in f if line.strip()]
            assert ids and all(i.isdigit() for i in ids), (collection, part)

    res = (
        "/root/reference/resources/product-substitutability/"
        "sports_and_outdoors"
    )
    topics = read_topics(os.path.join(res, "topics"))
    assert len(topics) == 2087 and topics["0"].startswith("snow sports")
    qrels = read_qrels(os.path.join(res, "qrel_test"))
    assert len(qrels) == 1879
    assert all(
        r == 1 for docs in qrels.values() for r in docs.values()
    )
    with open(os.path.join(res, "substitutes")) as f:
        first = f.readline().split()
    assert len(first) == 3 and float(first[2]) == 1.0


def test_visualize_reuters_pipeline_with_metrics(tmp_path):
    # The Reuters E2E script end to end on synthetic SGML: extraction ->
    # training -> per-epoch plots + the quantitative class-silhouette
    # curve (metrics.json).
    import json
    import random

    import numpy as np

    from visualize_reuters import main as reuters_main

    random.seed(5)
    classes = ["grain", "oil", "ship"]
    arts = []
    for i in range(24):
        c = classes[i % 3]
        words = " ".join(
            f"{c}w{random.randint(0, 6)}" for _ in range(40)
        )
        arts.append(
            f'<REUTERS NEWID="{i + 1}"><TOPICS><D>{c}</D></TOPICS>'
            f"<TITLE>t</TITLE><BODY>{words}</BODY></REUTERS>"
        )
    sgm = tmp_path / "synth.sgm"
    sgm.write_text("\n".join(arts) + "\n")
    work = tmp_path / "work"
    rc = reuters_main([
        "--sgm", str(sgm), "--workdir", str(work),
        "--num_epochs", "6", "--batch_size", "32",
        "--word_repr_size", "8", "--entity_repr_size", "8",
    ])
    assert rc == 0
    metrics = json.load(open(work / "metrics.json"))
    curve = metrics["class_silhouette_cosine_by_epoch"]
    assert metrics["num_classes"] == 3 and len(curve) == 6
    # Topic-disjoint vocabularies: the class structure must emerge.
    assert curve[-1][1] > curve[0][1]
    assert (work / "plots" / "epoch_006.png").exists()


def test_rank_adhoc_protocol_mesh_shard_corpus(adhoc_collection, tmp_path):
    """The adhoc protocol trains under a mesh with the data-axis-sharded
    corpus (--mesh 2x4 --shard_corpus --on_device_sampling)."""
    import rank_adhoc

    workdir = tmp_path / "out_mesh"
    rc = rank_adhoc.main([
        "--corpus", str(adhoc_collection / "corpus.trectext"),
        "--topics", str(adhoc_collection / "topics.txt"),
        "--qrels", str(adhoc_collection / "qrels.txt"),
        "--splits", str(adhoc_collection / "splits"),
        "--workdir", str(workdir),
        "--num_epochs", "2", "--eval_every", "2",
        "--word_repr_size", "16", "--entity_repr_size", "16",
        "--batch_size", "64",
        "--mesh", "2x4", "--on_device_sampling", "--shard_corpus",
        "--steps_per_call", "2",
    ])
    assert rc in (0, None)
    results = json.load(open(workdir / "results.json"))
    assert results["qlm_jm_prf_test_map"] > 0.9
    assert results["best_epoch"] == 2
