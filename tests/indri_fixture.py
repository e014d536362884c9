"""Synthetic Indri DiskIndex repository writer (test support).

Writes the subset of the on-disk format that both repository readers
(`cunvsm/data/indri.py` and `native/indri.cpp`) consume — RVL direct
files, BulkTree vocabularies, Keyfile docno lookups, manifests — so
multi-index repositories can be synthesized and read back (the format
itself is pinned against the real Brown index by tests/test_indri.py).

Layout notes mirror the reader docstring (data/indri.py): per-index term
ids are assigned independently per index (1-based alphabetical, the way an
incremental Indri build gives each on-disk index its own term dictionary),
documents are numbered contiguously across indexes starting at
document-base 1, and the repository-level collection/ Keyfiles span all
documents.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

BULKTREE_BLOCK = 8192
KEYFILE_BLOCK = 4096


def rvl_encode(value: int) -> bytes:
    """lemur RVLCompress: 7 data bits per byte, high bit on the last."""
    assert value >= 0
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F)
        value >>= 7
    out.append(0x80 | value)
    return bytes(out)


def encode_docid_key(docid: int, width: int = 4) -> bytes:
    """Keyfile integer key: big-endian base-64 bytes (byte - 0x40)."""
    return bytes(0x40 + ((docid >> (6 * i)) & 63)
                 for i in reversed(range(width)))


def write_bulktree(path: str, entries: Sequence[Tuple[str, bytes]]) -> None:
    """Write leaf blocks: key/value data growing from the front, a
    (valueStart, valueEnd) uint16 directory growing from the back."""
    blocks: List[bytes] = []
    cur: List[Tuple[bytes, bytes]] = []
    used = 2  # header

    def flush():
        nonlocal cur, used
        if not cur:
            return
        blk = bytearray(BULKTREE_BLOCK)
        struct.pack_into("<H", blk, 0, len(cur) | 0x8000)
        pos = 2
        dirpos = BULKTREE_BLOCK
        for key, value in cur:
            blk[pos : pos + len(key)] = key
            vs = pos + len(key)
            blk[vs : vs + len(value)] = value
            ve = vs + len(value)
            struct.pack_into("<HH", blk, dirpos - 4, vs, ve)
            dirpos -= 4
            pos = ve
        blocks.append(bytes(blk))
        cur, used = [], 2

    for term, value in entries:
        key = term.encode("utf-8")
        need = len(key) + len(value) + 4
        if used + need > BULKTREE_BLOCK:
            flush()
        cur.append((key, value))
        used += need
    flush()
    with open(path, "wb") as f:
        f.write(b"".join(blocks))


def term_value(cf: int, df: int, tid: int) -> bytes:
    """(totalCount, documentCount, maxDocLength, minDocLength, termID,
    invertedOffset, invertedLength) RVL tuple."""
    return b"".join(
        rvl_encode(v) for v in (cf, df, 0, 0, tid, 0, 0)
    )


def write_keyfile(path: str, entries: Sequence[Tuple[bytes, bytes]]) -> None:
    """Write data blocks: entries physically back-to-front in descending
    key order filling the block tail (no prefix compression: lc = 0)."""
    entries = sorted(entries)
    blocks: List[bytes] = [bytes(KEYFILE_BLOCK)]  # header block (skipped)
    group: List[bytes] = []
    chars = 0

    def flush():
        nonlocal group, chars
        if not group:
            return
        blk = bytearray(KEYFILE_BLOCK)
        struct.pack_into(">HH", blk, 0, len(group), chars)
        blk[4] = 0  # type
        blk[5] = 0  # prefix_lc
        end_limit = KEYFILE_BLOCK - 1
        pos = end_limit - chars
        # Physical order is descending key order.
        for enc in reversed(group):
            blk[pos : pos + len(enc)] = enc
            pos += len(enc)
        assert pos == end_limit
        blocks.append(bytes(blk))
        group, chars = [], 0

    for key, value in entries:
        enc = bytes([0, len(key)]) + key + bytes([len(value) + 1]) + value
        if chars + len(enc) > KEYFILE_BLOCK - 8:
            flush()
        group.append(enc)
        chars += len(enc)
    flush()
    with open(path, "wb") as f:
        f.write(b"".join(blocks))


def _write_manifest(path: str, body: str) -> None:
    with open(path, "w") as f:
        f.write(f"<parameters>\n{body}\n</parameters>\n")


def write_repository(
    root: str,
    doc_groups: Sequence[Sequence[Tuple[str, List[str]]]],
    stopwords: Sequence[str] = (),
) -> None:
    """Write a repository with one on-disk index per document group.

    ``doc_groups[i]`` is the (docno, tokens) list of index i; a token in
    ``stopwords`` is indexed as a stopped position (term id 0), exactly
    like an indexing-time Indri stopper.
    """
    os.makedirs(os.path.join(root, "collection"), exist_ok=True)
    index_names = [str(i) for i in range(len(doc_groups))]

    stop = set(stopwords)
    all_docs: List[Tuple[int, str]] = []  # (docid, docno)
    document_base = 1
    for name, docs in zip(index_names, doc_groups):
        index_dir = os.path.join(root, "index", name)
        os.makedirs(index_dir, exist_ok=True)

        # Per-index term dictionary: 1-based alphabetical ids.
        terms = sorted({t for _, tokens in docs for t in tokens} - stop)
        tid = {t: i + 1 for i, t in enumerate(terms)}
        cf: Dict[str, int] = {t: 0 for t in terms}
        df: Dict[str, int] = {t: 0 for t in terms}

        direct = bytearray()
        stats = bytearray()
        lengths = bytearray()
        for offset_doc, (docno, tokens) in enumerate(docs):
            ids = [0 if t in stop else tid[t] for t in tokens]
            for t in set(tokens) - stop:
                df[t] += 1
            for t in tokens:
                if t not in stop:
                    cf[t] += 1
            record = rvl_encode(len(ids)) + rvl_encode(0) + b"".join(
                rvl_encode(i) for i in ids
            )
            stats += struct.pack(
                "<Qiiii",
                len(direct), len(record),
                sum(1 for i in ids if i), len(ids),
                len(set(i for i in ids if i)),
            )
            direct += record
            lengths += struct.pack("<I", len(ids))
            all_docs.append((document_base + offset_doc, docno))

        with open(os.path.join(index_dir, "directFile"), "wb") as f:
            f.write(direct)
        with open(os.path.join(index_dir, "documentStatistics"), "wb") as f:
            f.write(stats)
        with open(os.path.join(index_dir, "documentLengths"), "wb") as f:
            f.write(lengths)

        # All terms go to the infrequent tree (frequent-terms = 0);
        # BulkTree keys are in ascending string order.
        write_bulktree(
            os.path.join(index_dir, "frequentString"), []
        )
        write_bulktree(
            os.path.join(index_dir, "infrequentString"),
            [(t, term_value(cf[t], df[t], tid[t])) for t in terms],
        )

        total_terms = sum(len(tokens) for _, tokens in docs)
        _write_manifest(
            os.path.join(index_dir, "manifest"),
            "<corpus>"
            f"<document-base>{document_base}</document-base>"
            f"<frequent-terms>0</frequent-terms>"
            f"<maximum-document>{document_base + len(docs)}</maximum-document>"
            f"<total-documents>{len(docs)}</total-documents>"
            f"<total-terms>{total_terms}</total-terms>"
            f"<unique-terms>{len(terms)}</unique-terms>"
            "</corpus><type>DiskIndex</type>",
        )
        document_base += len(docs)

    write_keyfile(
        os.path.join(root, "collection", "forwardLookup0"),
        [(encode_docid_key(d), n.encode()) for d, n in all_docs],
    )
    write_keyfile(
        os.path.join(root, "collection", "reverseLookup0"),
        [(n.encode(), struct.pack("<q", d)) for d, n in all_docs],
    )

    index_tags = "".join(f"<index>{n}</index>" for n in index_names)
    stop_tags = "".join(f"<word>{w}</word>" for w in stopwords)
    body = f"<indexes>{index_tags}</indexes>"
    if stop_tags:
        body += f"<stopper>{stop_tags}</stopper>"
    _write_manifest(os.path.join(root, "manifest"), body)
