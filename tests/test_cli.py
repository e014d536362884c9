"""CLI smoke tests: train -> query -> combine -> dump-vocab -> visualize."""

import os

import numpy as np
import pytest

from cunvsm.cli import (
    combine_runs as cli_combine,
    dump_vocabulary as cli_dump,
    extract_reuters as cli_reuters,
    query as cli_query,
    train as cli_train,
)
from cunvsm.io.trec import read_run


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    topics = {
        "space": "rocket orbit launch satellite astronaut".split(),
        "food": "recipe oven flour butter bake".split(),
    }
    path = d / "docs.trectext"
    with open(path, "w") as f:
        for t, words in topics.items():
            for i in range(5):
                body = " ".join(
                    words[rng.randint(len(words))] for _ in range(20)
                )
                f.write(
                    f"<DOC>\n<DOCNO>{t}_{i}</DOCNO>\n<TEXT>\n{body}\n"
                    "</TEXT>\n</DOC>\n"
                )
    return str(path)


@pytest.fixture(scope="module")
def trained_prefix(corpus_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("model") / "m")
    rc = cli_train.main(
        [
            corpus_file,
            "--output", out,
            "--num_epochs", "8",
            "--batch_size", "16",
            "--window_size", "4",
            "--num_random_entities", "3",
            "--word_repr_size", "16",
            "--entity_repr_size", "12",
            "--update_method", "full_adam",
            "--nonlinearity", "tanh",
            "--max_vocabulary_size", "0",
            "--min_document_frequency", "0",
            "--max_document_frequency", "0",
            "--seed", "1",
            "--learning_rate", "0.01",
        ]
    )
    assert rc == 0
    return out


def test_train_requires_seed(corpus_file, tmp_path):
    rc = cli_train.main(
        [
            corpus_file,
            "--output", str(tmp_path / "x"),
            "--update_method", "sgd",
            "--nonlinearity", "tanh",
        ]
    )
    assert rc == 1  # seed 0 rejected (main.cu:708 parity)


def test_train_outputs(trained_prefix):
    assert os.path.exists(f"{trained_prefix}_8.hdf5")
    assert os.path.exists(f"{trained_prefix}_meta")
    assert os.path.exists(f"{trained_prefix}_vocab.txt")
    assert os.path.exists(f"{trained_prefix}_docnos.txt")


def test_query_cli(trained_prefix, tmp_path):
    topics = tmp_path / "topics.txt"
    topics.write_text("1;rocket orbit\n2;oven bake\n")
    run_out = str(tmp_path / "out.run")
    rc = cli_query.main(
        [
            "--topics", str(topics),
            "--model", trained_prefix,
            "--epoch", "8",
            "--top_k", "5",
            run_out,
        ]
    )
    assert rc == 0
    run = read_run(run_out)
    assert set(run) == {"1", "2"}
    assert len(run["1"]) == 5
    # The trained model should put space docs on top for the space query.
    assert run["1"][0][0].startswith("space")
    assert run["2"][0][0].startswith("food")


def test_query_qrels_restricted(trained_prefix, tmp_path):
    topics = tmp_path / "topics.txt"
    topics.write_text("1;rocket orbit\n")
    qrels = tmp_path / "qrels"
    qrels.write_text("1 0 space_0 1\n1 0 food_0 0\n")
    run_out = str(tmp_path / "restricted.run")
    rc = cli_query.main(
        [
            "--topics", str(topics),
            "--model", trained_prefix,
            "--epoch", "8",
            "--top_k", str(qrels),
            run_out,
        ]
    )
    assert rc == 0
    run = read_run(run_out)
    assert {d for d, _ in run["1"]} == {"space_0", "food_0"}


def test_combine_runs_cli(tmp_path):
    a = tmp_path / "a.run"
    b = tmp_path / "b.run"
    a.write_text("1 Q0 d1 1 2.0 a\n1 Q0 d2 2 1.0 a\n")
    b.write_text("1 Q0 d2 1 5.0 b\n1 Q0 d3 2 1.0 b\n")
    out = str(tmp_path / "combined.run")
    rc = cli_combine.main(
        [
            "--runs", str(a), str(b),
            "--alpha", "0.5",
            "--score_normalizer", "minmax",
            out,
        ]
    )
    assert rc == 0
    run = read_run(out)
    assert len(run["1"]) == 3
    # Refuses to overwrite.
    assert cli_combine.main(
        ["--runs", str(a), str(b), "--alpha", "0.5",
         "--score_normalizer", "minmax", out]
    ) == 1


def test_dump_vocabulary_cli(trained_prefix, tmp_path):
    out = str(tmp_path / "vocab.txt")
    rc = cli_dump.main(["--model", trained_prefix, out])
    assert rc == 0
    terms = open(out).read().split()
    assert "rocket" in terms


def test_extract_reuters_cli(tmp_path):
    sgm = tmp_path / "reut.sgm"
    sgm.write_text(
        '<REUTERS NEWID="1"><TOPICS><D>grain</D></TOPICS>'
        "<TITLE>Wheat prices</TITLE><BODY>Wheat rose today.</BODY>"
        "</REUTERS>\n"
        '<REUTERS NEWID="2"><TOPICS><D>oil</D><D>grain</D></TOPICS>'
        "<TITLE>Oil news</TITLE><BODY>Oil fell.</BODY></REUTERS>\n"
    )
    prefix = str(tmp_path / "out")
    classes = str(tmp_path / "classes.txt")
    rc = cli_reuters.main(
        [
            str(sgm),
            "--trectext_out_prefix", prefix,
            "--document_classification_out", classes,
        ]
    )
    assert rc == 0
    from cunvsm.data.text import iter_trectext

    docs = list(iter_trectext(prefix + "_0.trectext"))
    assert len(docs) == 2
    lines = open(classes).read().splitlines()
    assert len(lines) == 2
    # Doc 2 belongs to both oil (freq 1) and grain (freq 2); the most
    # specific (least frequent) topic wins.
    assert lines[1] == "1 oil"


def test_visualize_cli(trained_prefix, tmp_path):
    from cunvsm.cli import visualize as cli_vis

    classes = tmp_path / "classes.txt"
    with open(f"{trained_prefix}_docnos.txt") as f:
        docnos = f.read().split()
    classes.write_text(
        "".join(f"{d} {d.split('_')[0]}\n" for d in docnos)
    )
    out = str(tmp_path / "plot.png")
    rc = cli_vis.main(
        [
            "--model", trained_prefix,
            "--epoch", "8",
            "--object_classification", str(classes),
            "--plot_out", out,
            "--perplexity", "3",
        ]
    )
    assert rc == 0
    assert os.path.getsize(out) > 0

    rc = cli_vis.main(
        [
            "--model", trained_prefix,
            "--epoch", "8",
            "--mode", "embedding_projector",
            "--plot_out", str(tmp_path / "proj"),
        ]
    )
    assert rc == 0
    assert os.path.exists(str(tmp_path / "proj") + "_tensors.tsv")


def test_query_multiple_topic_files(trained_prefix, tmp_path):
    """Multiple topic files produce one run per file (query.py:170-173)."""
    t1 = tmp_path / "topicsA.txt"
    t1.write_text("1;rocket orbit\n")
    t2 = tmp_path / "topicsB.txt"
    t2.write_text("9;oven bake\n")
    run_out = str(tmp_path / "multi")
    rc = cli_query.main(
        [
            "--topics", str(t1), str(t2),
            "--model", trained_prefix,
            "--epoch", "8",
            "--top_k", "3",
            run_out,
        ]
    )
    assert rc == 0
    a = read_run(f"{run_out}-topicsA.txt")
    b = read_run(f"{run_out}-topicsB.txt")
    assert set(a) == {"1"} and set(b) == {"9"}


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from cunvsm.cli import _platform

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _platform.enable_compile_cache() == str(tmp_path)
    # Left to JAX: nothing else configured.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from cunvsm.cli import _platform

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    try:
        assert _platform.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        # Fixed: a second call (another process) gets the same path.
        assert _platform.enable_compile_cache() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_record_on_cpu():
    from cunvsm.cli._platform import device_record

    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert "card" not in rec
