"""Query-side stemming (data/stemming.py).

The reference resolves query terms through pyndri's index dictionary
(py/query.py:111,141-142), so a Krovetz-stemmed repository stems query
terms implicitly.  These tests pin the rebuild's explicit equivalent:
Porter as the published algorithm, vocabulary-guided Krovetz inflection
rules, the manifest -> corpus -> checkpoint-sidecar plumbing, and — the
decisive check — inflected English query terms hitting the Krovetz-stemmed
vocabulary of the real checked-in Brown index where the raw tokenizer
misses.
"""

import os

import pytest

from cunvsm.data.stemming import (
    QueryStemmer,
    krovetz_candidates,
    load_query_stemmer,
    porter_stem,
)

BROWN = "/root/reference/test_data/Brown_index"


# ---------------------------------------------------------------------------
# Porter: pairs from Porter (1980)'s published examples.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "word,stem",
    [
        ("caresses", "caress"),
        ("ponies", "poni"),
        ("caress", "caress"),
        ("cats", "cat"),
        ("feed", "feed"),
        ("agreed", "agre"),  # 1b "agree", then 5a drops the final e
        ("plastered", "plaster"),
        ("bled", "bled"),
        ("motoring", "motor"),
        ("sing", "sing"),
        ("conflated", "conflat"),
        ("troubled", "troubl"),
        ("sized", "size"),
        ("hopping", "hop"),
        ("tanned", "tan"),
        ("falling", "fall"),
        ("hissing", "hiss"),
        ("fizzed", "fizz"),
        ("failing", "fail"),
        ("filing", "file"),
        ("happy", "happi"),
        ("sky", "sky"),
        ("relational", "relat"),
        ("conditional", "condit"),
        ("rational", "ration"),
        ("valenci", "valenc"),
        ("digitizer", "digit"),
        ("conformabli", "conform"),
        ("radicalli", "radic"),
        ("differentli", "differ"),
        ("vileli", "vile"),
        ("analogousli", "analog"),
        ("vietnamization", "vietnam"),
        ("predication", "predic"),
        ("operator", "oper"),
        ("feudalism", "feudal"),
        ("decisiveness", "decis"),
        ("hopefulness", "hope"),
        ("callousness", "callous"),
        ("formaliti", "formal"),
        ("sensitiviti", "sensit"),
        ("sensibiliti", "sensibl"),
        ("triplicate", "triplic"),
        ("formative", "form"),
        ("formalize", "formal"),
        # Step-3 produces "electric"; step 4 then strips "ic" at m>1.
        ("electriciti", "electr"),
        ("electrical", "electr"),
        ("hopeful", "hope"),
        ("goodness", "good"),
        ("revival", "reviv"),
        ("allowance", "allow"),
        ("inference", "infer"),
        ("airliner", "airlin"),
        ("gyroscopic", "gyroscop"),
        ("adjustable", "adjust"),
        ("defensible", "defens"),
        ("irritant", "irrit"),
        ("replacement", "replac"),
        ("adjustment", "adjust"),
        ("dependent", "depend"),
        ("adoption", "adopt"),
        ("homologou", "homolog"),
        ("communism", "commun"),
        ("activate", "activ"),
        ("angulariti", "angular"),
        ("homologous", "homolog"),
        ("effective", "effect"),
        ("bowdlerize", "bowdler"),
        ("probate", "probat"),
        ("rate", "rate"),
        ("cease", "ceas"),
        ("controll", "control"),
        ("roll", "roll"),
    ],
)
def test_porter_published_pairs(word, stem):
    assert porter_stem(word) == stem


# ---------------------------------------------------------------------------
# Krovetz candidates + vocabulary-guided stemming.
# ---------------------------------------------------------------------------


def test_krovetz_candidate_order():
    assert krovetz_candidates("cities")[0] == "city"
    assert "die" in krovetz_candidates("dies")
    assert "walk" in krovetz_candidates("walked")
    assert "hope" in krovetz_candidates("hoped")
    assert "hop" in krovetz_candidates("hopped")
    assert "make" in krovetz_candidates("making")
    assert "run" in krovetz_candidates("running")
    assert "study" in krovetz_candidates("studied")
    # -ss / -us / -is plurals are not stripped (kstem plural guards).
    assert krovetz_candidates("glass") == []
    assert krovetz_candidates("corpus") == []


def test_vocab_guided_krovetz():
    vocab = {"city", "walk", "run", "evidence", "glass", "dies"}
    st = QueryStemmer("krovetz", vocab)
    assert st.stem("cities") == "city"
    assert st.stem("walked") == "walk"
    assert st.stem("running") == "run"
    # In-vocabulary words are returned unchanged (dictionary check first).
    assert st.stem("dies") == "dies"
    # No in-vocabulary reduction -> unchanged.
    assert st.stem("zebras") == "zebras"


def test_krovetz_requires_vocab():
    with pytest.raises(ValueError):
        QueryStemmer("krovetz")
    with pytest.raises(ValueError):
        QueryStemmer("snowball", {"a"})


def test_porter_mode_identity_on_vocab_hit():
    st = QueryStemmer("porter", {"ponies"})
    assert st.stem("ponies") == "ponies"  # exact surface form wins
    st2 = QueryStemmer("porter")
    assert st2.stem("ponies") == "poni"


# ---------------------------------------------------------------------------
# Sidecar round trip.
# ---------------------------------------------------------------------------


def test_stemmer_sidecar_roundtrip(tmp_path):
    from cunvsm.io.checkpoint import save_corpus_sidecars

    class C:
        class vocab:
            terms = ["walk", "city"]

        docnos = ["d1"]
        stemmer = "krovetz"

    prefix = str(tmp_path / "model")
    save_corpus_sidecars(C, prefix)
    st = load_query_stemmer(prefix, {"walk", "city"})
    assert st.name == "krovetz"
    assert st.stem("walked") == "walk"
    # No sidecar -> identity.
    st2 = load_query_stemmer(str(tmp_path / "other"), {"walk"})
    assert st2.name is None
    assert st2.stem("walked") == "walked"


# ---------------------------------------------------------------------------
# The real thing: inflected topics against the Krovetz-stemmed Brown index.
# ---------------------------------------------------------------------------


@pytest.mark.skipif(
    not os.path.isdir(BROWN), reason="Brown index not available"
)
def test_brown_index_inflected_query_hits():
    from cunvsm.config import DataConfig
    from cunvsm.data.indri import build_corpus_from_indri
    from cunvsm.data.text import tokenize

    corpus = build_corpus_from_indri(
        BROWN,
        DataConfig(
            corpus_path=BROWN, max_vocabulary_size=0,
            min_document_frequency=0, max_document_frequency=0,
        ),
        window_size=10,
    )
    # The manifest records the indexing-time stemmer.
    assert corpus.stemmer == "krovetz"

    vocab = corpus.vocab.term_to_id
    st = QueryStemmer(corpus.stemmer, vocab)

    # An inflected English topic, Brown-vocabulary subject matter
    # (ca01's grand-jury story).  Raw tokens miss the stemmed vocabulary;
    # stemmed tokens hit it.
    topic = (
        "investigations of irregularities in primary elections "
        "produced evidence"
    )
    raw = [t for t in tokenize(topic) if t in vocab]
    stemmed = [t for t in st.stem_tokens(tokenize(topic)) if t in vocab]
    for miss in ("investigations", "irregularities", "elections",
                 "produced"):
        assert miss not in vocab
    # Inflectional reductions.
    assert st.stem("irregularities") == "irregularity"
    assert st.stem("elections") == "election"
    assert st.stem("produced") == "produce"
    # Chained plural + derivational -ion step: the index holds kstem's
    # "investigate", not "investigation".
    assert st.stem("investigations") == "investigate"
    assert len(stemmed) > len(raw)
    # Every stemmed hit is a real vocabulary string.
    assert all(t in vocab for t in stemmed)


def test_unknown_manifest_stemmer_degrades_with_warning(caplog):
    # A repository stemmed with a stemmer this framework does not
    # implement (e.g. Indri's 'arabic') must degrade to identity with a
    # loud warning when the name comes from a manifest/sidecar — not
    # crash the whole protocol at startup.  Explicit user requests still
    # raise.
    import logging

    from cunvsm.data.stemming import QueryStemmer

    with caplog.at_level(logging.WARNING):
        s = QueryStemmer("arabic", ["foo"], on_unknown="warn")
    assert s.name is None
    assert s.stem("running") == "running"
    assert any("not implemented" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="unknown stemmer"):
        QueryStemmer("arabic", ["foo"])


def test_porter_query_stemming_is_unconditional():
    # Indri's Porter path stems every query token: a surface form that is
    # itself in the stemmed vocabulary but is not its own Porter fixed
    # point must still map to its stem (advisor finding, round 4); the raw
    # token is used only when the stem is OOV and the raw form is not.
    from cunvsm.data.stemming import QueryStemmer, porter_stem

    assert porter_stem("university") == "univers"
    # Both forms in vocab -> the stem wins (reference resolution).
    s = QueryStemmer("porter", ["university", "univers"])
    assert s.stem("university") == "univers"
    # Stem OOV, raw in vocab -> fall back to the raw token.
    s2 = QueryStemmer("porter", ["university"])
    assert s2.stem("university") == "university"
    # Neither in vocab -> the stem (the query engine handles OOV).
    s3 = QueryStemmer("porter", ["other"])
    assert s3.stem("university") == "univers"
