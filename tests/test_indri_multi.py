"""Multi-index Indri repository support.

The reference LOG(FATAL)s on repositories with more than one on-disk index
(data_indri.cpp:43-45); this framework reads them by merging the per-index
term dictionaries (data/indri.py).  Fixtures are synthesized with
tests/indri_fixture.py, whose format conformance is anchored by the real
Brown-index tests (tests/test_indri.py) exercising the same parsers.
"""

import numpy as np
import pytest

from cunvsm.config import DataConfig
from cunvsm.data.indri import IndriIndex, build_corpus_from_indri
from tests.indri_fixture import write_repository

DOCS = [
    ("doc-a", "the quick brown fox jumps over the lazy dog".split()),
    ("doc-b", "never jump over the lazy dog quickly again fox".split()),
    ("doc-c", "brown bears eat fish and honey near the river".split()),
    ("doc-d", "the river flows past the quick brown mill".split()),
    ("doc-e", "fish swim quickly past the mill and the fox".split()),
]
STOP = ["the", "and", "over"]


def _cfg(path):
    return DataConfig(
        corpus_path=path, max_vocabulary_size=0, min_document_frequency=0,
        max_document_frequency=0,
    )


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    root = tmp_path_factory.mktemp("indri")
    single = str(root / "single")
    multi = str(root / "multi")
    write_repository(single, [DOCS], stopwords=STOP)
    write_repository(multi, [DOCS[:2], DOCS[2:4], DOCS[4:]], stopwords=STOP)
    return single, multi


def test_single_index_statistics(repos):
    single, _ = repos
    ix = IndriIndex(single)
    assert ix.document_count == 5
    assert ix.total_terms == sum(len(t) for _, t in DOCS)
    vocab = {e.term for e in ix.vocabulary()}
    expected = {t for _, ts in DOCS for t in ts} - set(STOP)
    assert vocab == expected
    assert ix.unique_terms == len(expected)


def test_multi_index_statistics_match_single(repos):
    single, multi = repos
    s, m = IndriIndex(single), IndriIndex(multi)
    assert m.document_count == s.document_count
    assert m.total_terms == s.total_terms
    assert m.document_base == s.document_base
    assert m.maximum_document == s.maximum_document
    np.testing.assert_array_equal(m.document_lengths, s.document_lengths)
    # Merged vocabulary: same terms, same summed statistics.
    sv = {e.term: (e.total_count, e.document_count) for e in s.vocabulary()}
    mv = {e.term: (e.total_count, e.document_count) for e in m.vocabulary()}
    assert mv == sv
    assert m.unique_terms == s.unique_terms
    # Merged ids are unique and dense from 1.
    ids = sorted(e.term_id for e in m.vocabulary())
    assert ids == list(range(1, len(ids) + 1))


def test_multi_index_term_lists_translate(repos):
    single, multi = repos
    s, m = IndriIndex(single), IndriIndex(multi)
    s_terms = {e.term_id: e.term for e in s.vocabulary()}
    m_terms = {e.term_id: e.term for e in m.vocabulary()}
    for doc_id in range(1, 6):
        st = [s_terms.get(int(t), "") for t in s.term_list(doc_id)]
        mt = [m_terms.get(int(t), "") for t in m.term_list(doc_id)]
        assert st == mt  # same strings, stopped positions in the same slots
        assert len(st) == s.document_length(doc_id)


def test_multi_index_docnos(repos):
    _, multi = repos
    m = IndriIndex(multi)
    assert m.docnos() == {
        i + 1: docno for i, (docno, _) in enumerate(DOCS)
    }
    assert m.docids_from_docnos(["doc-d", "doc-a"]) == [4, 1]


def test_corpus_parity_single_vs_multi(repos):
    """build_corpus_from_indri must produce the same corpus from the split
    repository as from the compacted one (modulo index_term_ids, which are
    synthetic for multi-index repositories — see the IndriIndex docstring)."""
    single, multi = repos
    cs = build_corpus_from_indri(single, _cfg(single), window_size=3)
    cm = build_corpus_from_indri(multi, _cfg(multi), window_size=3)
    assert cs.vocab.terms == cm.vocab.terms
    np.testing.assert_array_equal(cs.vocab.term_freq, cm.vocab.term_freq)
    assert cs.vocab.total_terms == cm.vocab.total_terms
    np.testing.assert_array_equal(cs.tokens, cm.tokens)
    np.testing.assert_array_equal(cs.doc_offsets, cm.doc_offsets)
    np.testing.assert_array_equal(cs.index_lengths, cm.index_lengths)
    assert cs.docnos == cm.docnos
    np.testing.assert_array_equal(cs.index_doc_ids, cm.index_doc_ids)


def test_corpus_document_list_and_subset_recount(repos):
    _, multi = repos
    sub = ["doc-e", "doc-b"]
    c = build_corpus_from_indri(
        multi, _cfg(multi), window_size=3, document_list=sub
    )
    assert c.docnos == sub
    # Subset recount: frequencies counted over the selected documents only.
    expected_counts = {}
    for docno, ts in DOCS:
        if docno in sub:
            for t in ts:
                if t not in STOP:
                    expected_counts[t] = expected_counts.get(t, 0) + 1
    got = {t: int(f) for t, f in zip(c.vocab.terms, c.vocab.term_freq) if t}
    assert got == expected_counts


def test_non_contiguous_ranges_rejected(tmp_path):
    bad = str(tmp_path / "bad")
    write_repository(bad, [DOCS[:2], DOCS[2:]])
    # Corrupt the second index's document-base.
    import re

    mpath = bad + "/index/1/manifest"
    text = open(mpath).read()
    open(mpath, "w").write(
        re.sub(r"<document-base>\d+", "<document-base>9", text)
    )
    with pytest.raises(ValueError, match="non-contiguous"):
        IndriIndex(bad)


def test_native_reader_matches_python_on_multi_index(repos):
    """The C++ reader (native/indri.cpp) must produce the identical packed
    corpus from a multi-index repository (the Python pipeline is the
    semantic oracle — same contract as tests/test_native.py)."""
    from cunvsm.data import native

    if not native.available():
        pytest.skip("native library not built (make -C native)")
    _, multi = repos
    cm = build_corpus_from_indri(multi, _cfg(multi), window_size=3)
    cn = native.build_corpus_native_indri(multi, _cfg(multi), window_size=3)
    assert cn.vocab.terms == cm.vocab.terms
    np.testing.assert_array_equal(cn.vocab.term_freq, cm.vocab.term_freq)
    np.testing.assert_array_equal(
        cn.vocab.index_term_ids, cm.vocab.index_term_ids
    )
    np.testing.assert_array_equal(cn.tokens, cm.tokens)
    np.testing.assert_array_equal(cn.doc_offsets, cm.doc_offsets)
    np.testing.assert_array_equal(cn.index_lengths, cm.index_lengths)
    assert cn.docnos == cm.docnos
    np.testing.assert_array_equal(cn.index_doc_ids, cm.index_doc_ids)


def test_native_reader_matches_python_with_document_list(repos):
    from cunvsm.data import native

    if not native.available():
        pytest.skip("native library not built (make -C native)")
    _, multi = repos
    cfg = _cfg(multi)
    import dataclasses
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".docs",
                                     delete=False) as f:
        f.write("doc-e\ndoc-b\n")
        doclist = f.name
    cfg = dataclasses.replace(cfg, document_list=doclist)
    cm = build_corpus_from_indri(
        multi, cfg, window_size=3, document_list=["doc-e", "doc-b"]
    )
    cn = native.build_corpus_native_indri(multi, cfg, window_size=3)
    assert cn.docnos == cm.docnos == ["doc-e", "doc-b"]
    np.testing.assert_array_equal(cn.tokens, cm.tokens)
    np.testing.assert_array_equal(cn.vocab.term_freq, cm.vocab.term_freq)


class TestKeyfileRobustness:
    """A leaf block the parser cannot read is silent docno loss — it must
    be reported loudly, and damage must stay contained to that block."""

    @staticmethod
    def _entries(n=400, vlen=80):
        return [
            (b"doc%04d" % i, (b"v%d-" % i) + b"x" * vlen) for i in range(n)
        ]

    def _write(self, tmp_path):
        import struct

        from tests.indri_fixture import KEYFILE_BLOCK, write_keyfile

        path = str(tmp_path / "kf")
        write_keyfile(path, self._entries())
        data = bytearray(open(path, "rb").read())
        nblocks = len(data) // KEYFILE_BLOCK
        assert nblocks >= 4, "fixture must span multiple data blocks"
        return path, data, KEYFILE_BLOCK, struct

    def test_corrupt_leaf_block_warns_and_contains_damage(
        self, tmp_path, caplog
    ):
        import logging

        from cunvsm.data.indri import iter_keyfile_entries

        path, data, blk_size, struct_mod = self._write(tmp_path)
        clean = list(iter_keyfile_entries(path))
        assert len(clean) == 400
        # Zero the entry area of the second data block: nkeys/chars stay
        # plausible but no offset (0, +-1, +-2) parses.
        base = 2 * blk_size
        nkeys, chars = struct_mod.unpack(">HH", data[base : base + 4])
        data[base + 8 : base + blk_size] = b"\xff" * (blk_size - 8)
        open(path, "wb").write(data)
        with caplog.at_level(logging.WARNING):
            got = list(iter_keyfile_entries(path))
        assert any("unparseable leaf block" in r.message for r in caplog.records)
        # Exactly that block's entries are lost; the rest still parse.
        assert len(got) == 400 - nkeys
        assert set(got) < set(clean)

    def test_zero_entry_area_control_block_is_silent(self, tmp_path, caplog):
        # A level-0 block whose claimed entry area is all zeros is a
        # control/descriptor block (the Brown index's forwardLookup0 has
        # one: nkeys=1, chars=8, payload at the block head) — zero bytes
        # cannot encode entries, so nothing is lost and no warning fires.
        import logging

        from cunvsm.data.indri import iter_keyfile_entries

        path, data, blk_size, struct_mod = self._write(tmp_path)
        clean = list(iter_keyfile_entries(path))
        base = 2 * blk_size
        nkeys, _ = struct_mod.unpack(">HH", data[base : base + 4])
        data[base + 4 : base + blk_size] = bytes(blk_size - 4)
        data[base : base + 4] = struct_mod.pack(">HH", 1, 8)
        data[base + 7] = 1  # nonzero head payload, like the Brown block
        open(path, "wb").write(data)
        with caplog.at_level(logging.WARNING):
            got = list(iter_keyfile_entries(path))
        assert not any(
            "unparseable leaf block" in r.message for r in caplog.records
        )
        assert len(got) == 400 - nkeys

    def test_truncated_file_warns(self, tmp_path, caplog):
        import logging

        from cunvsm.data.indri import iter_keyfile_entries

        path, data, blk_size, _ = self._write(tmp_path)
        open(path, "wb").write(data[: len(data) - blk_size // 2])
        with caplog.at_level(logging.WARNING):
            got = list(iter_keyfile_entries(path))
        assert any("truncated" in r.message for r in caplog.records)
        assert 0 < len(got) < 400  # the partial block is dropped, no crash

    def test_oversized_chars_block_warns(self, tmp_path, caplog):
        import logging

        from cunvsm.data.indri import iter_keyfile_entries

        path, data, blk_size, struct_mod = self._write(tmp_path)
        base = 2 * blk_size
        nkeys, _ = struct_mod.unpack(">HH", data[base : base + 4])
        struct_mod.pack_into(">H", data, base + 2, 0xFFFF)
        open(path, "wb").write(data)
        with caplog.at_level(logging.WARNING):
            got = list(iter_keyfile_entries(path))
        assert any("corrupt block skipped" in r.message for r in caplog.records)
        assert len(got) == 400 - nkeys


def test_keyfile_bulktree_randomized_roundtrip():
    # Property test: the on-disk readers must round-trip every entry the
    # fixture writers produce, across randomized key lengths (prefix
    # compression stress), value sizes, and entry counts spanning many
    # blocks.
    import tempfile

    import numpy as np

    from cunvsm.data.indri import (
        iter_bulktree_leaves,
        iter_keyfile_entries,
    )
    from tests.indri_fixture import write_bulktree, write_keyfile

    rng = np.random.RandomState(31)
    for trial in range(6):
        n = int(rng.randint(1, 1200))
        keys = set()
        while len(keys) < n:
            length = int(rng.randint(1, 40))
            keys.add(
                "".join(chr(97 + rng.randint(0, 4)) for _ in range(length))
            )
        entries = [
            (k, bytes(rng.randint(32, 127, rng.randint(1, 120)).astype(
                np.uint8).tolist()))
            for k in sorted(keys)
        ]
        with tempfile.TemporaryDirectory() as d:
            kf = d + "/kf"
            write_keyfile(
                kf, [(k.encode(), v) for k, v in entries]
            )
            got = sorted(iter_keyfile_entries(kf))
            assert got == sorted(
                (k.encode(), v) for k, v in entries
            ), f"keyfile trial {trial}: {n} entries"

            bt = d + "/bt"
            write_bulktree(bt, entries)
            got_bt = sorted(iter_bulktree_leaves(bt))
            assert got_bt == sorted(
                (k.encode(), v) for k, v in entries
            ), f"bulktree trial {trial}: {n} entries"
