"""Pure-Python reader for Indri 5.x DiskIndex repositories.

The reference trains directly from an Indri index via the lemur C++ API
(/root/reference/cpp/data_indri.cpp:16-107) and defines its vocabulary and
document-id mappings against Indri internal term/document ids
(data_indri.cpp:652-869).  This module reads the on-disk DiskIndex format
directly — no Indri build required — so an existing index (e.g. the
checked-in ``test_data/Brown_index``, or a TOIS/Robust04 index) can be
consumed and the ``_meta`` checkpoint ids stay interoperable with
pyndri-based consumers.

On-disk layout (reverse-engineered against Brown_index, verified by the
real-index integration tests in tests/test_indri.py):

* ``manifest`` / ``index/N/manifest``: XML parameter trees with corpus
  statistics (document-base, total-documents, total-terms, unique-terms,
  frequent-terms) and the indexing-time stopper/stemmer.
* ``index/0/documentLengths``: little-endian uint32 per document (the
  Indri "document length" — includes stopped positions; their sum equals
  the manifest's total-terms).
* ``index/0/documentStatistics``: 24-byte records
  (offset u64, byteLength i32, indexedLength i32, totalLength i32,
  uniqueTermCount i32) locating each document's term list in the direct
  file.
* ``index/0/directFile``: per-document RVL-compressed term lists:
  (termCount, fieldCount, termCount * termID); termID 0 marks a stopped
  position.
* ``index/0/{frequent,infrequent}String``: BulkTree B+-trees of
  term-string -> term data.  Blocks are 8 KiB: a uint16 LE header whose
  low 15 bits are the entry count and high bit the leaf flag, entry
  key/value bytes growing from the front, and a directory of
  (valueStart, valueEnd) uint16 LE pairs growing from the back (key_i
  spans [valueEnd_{i-1}, valueStart_i)).  Leaf values are RVL tuples
  (totalCount, documentCount, maxDocLength, minDocLength, termID,
  invertedOffset, invertedLength).  Frequent terms own ids
  1..frequent-terms ordered by collection frequency; infrequent tree ids
  are alphabetical ranks, offset by the frequent count.
* ``collection/{forward,reverse}Lookup0``: lemur Keyfile B-trees mapping
  internal document id <-> docno.  Blocks are 4 KiB big-endian:
  (keys u16, chars u16, type u8, prefix_lc u8, ...), an offset table, then
  prefix-compressed entries stored back-to-front in descending key order
  (lc u8, ln u8, suffix, total_value_len u8, value[total_value_len - 1]),
  with the block-common key prefix in the final ``prefix_lc`` bytes.
  Document-id keys use a base-64 byte encoding (byte - 0x40 per 6 bits).

RVL compression (lemur RVLCompress): 7 data bits per byte, little-endian
groups, high bit set on the terminating byte.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

KEYFILE_BLOCK = 4096
BULKTREE_BLOCK = 8192


# ---------------------------------------------------------------------------
# RVL decoding.
# ---------------------------------------------------------------------------


def rvl_decode_one(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one RVL integer; returns (value, next_pos)."""
    val = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        if b & 0x80:
            return val | ((b & 0x7F) << shift), pos
        val |= b << shift
        shift += 7


def rvl_decode_all(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized decode of a whole RVL stream.

    Returns (values, start_offsets): every integer in the stream plus the
    byte offset where each begins — callers map byte offsets to value
    indices via searchsorted.
    """
    bits = (buf & 0x7F).astype(np.uint64)
    ends = (buf & 0x80) != 0
    # Group id of each byte: index of the integer it belongs to.
    group = np.zeros(len(buf), dtype=np.int64)
    group[1:] = np.cumsum(ends[:-1])
    starts = np.flatnonzero(
        np.concatenate(([True], ends[:-1]))
    )
    within = np.arange(len(buf), dtype=np.int64) - starts[group]
    contrib = bits << (7 * within.astype(np.uint64))
    values = np.add.reduceat(contrib, starts)
    return values.astype(np.int64), starts


# ---------------------------------------------------------------------------
# BulkTree (term-string / term-id B+-trees).
# ---------------------------------------------------------------------------


def iter_bulktree_leaves(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) for every entry in every leaf block."""
    data = open(path, "rb").read()
    for base in range(0, len(data), BULKTREE_BLOCK):
        blk = data[base : base + BULKTREE_BLOCK]
        header = struct.unpack("<H", blk[0:2])[0]
        count, leaf = header & 0x7FFF, bool(header & 0x8000)
        if count == 0 or not leaf:
            continue
        dirpos = BULKTREE_BLOCK
        prev_end = 2
        for _ in range(count):
            vs, ve = struct.unpack("<HH", blk[dirpos - 4 : dirpos])
            dirpos -= 4
            yield blk[prev_end:vs], blk[vs:ve]
            prev_end = ve


@dataclasses.dataclass
class TermEntry:
    term: str
    term_id: int  # Indri internal term id
    total_count: int  # collection frequency
    document_count: int  # document frequency


def _parse_term_entries(path: str, id_offset: int) -> List[TermEntry]:
    out = []
    for key, val in iter_bulktree_leaves(path):
        pos = 0
        cf, pos = rvl_decode_one(val, pos)
        df, pos = rvl_decode_one(val, pos)
        _max_dl, pos = rvl_decode_one(val, pos)
        _min_dl, pos = rvl_decode_one(val, pos)
        tid, pos = rvl_decode_one(val, pos)
        out.append(
            TermEntry(key.decode("utf-8", "replace"), tid + id_offset, cf, df)
        )
    return out


# ---------------------------------------------------------------------------
# Keyfile (docno lookups).
# ---------------------------------------------------------------------------


def _parse_keyfile_entries(blk, start, nkeys, end_limit):
    """Parse ``nkeys`` (lc, suffix, value) entries in [start, end_limit);
    returns None unless they fit exactly."""
    if start < 0:
        return None
    pos = start
    raw: List[Tuple[int, bytes, bytes]] = []
    for _ in range(nkeys):
        if pos + 2 >= end_limit:
            return None
        lc, ln = blk[pos], blk[pos + 1]
        vpos = pos + 2 + ln
        if vpos >= end_limit or blk[vpos] < 1:
            return None
        vlen = blk[vpos]
        raw.append((lc, blk[pos + 2 : vpos], blk[vpos + 1 : vpos + vlen]))
        pos = vpos + vlen
    return raw if pos == end_limit else None


def iter_keyfile_entries(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) for every entry of a lemur Keyfile B-tree.

    Only leaf data blocks (header byte 4 — the B-tree level — is 0) with a
    nonzero key count are read; keys come out in ascending order per
    block.  A leaf block whose entry list defeats the parser (and its
    small layout-variant retries) means silently-lost docnos downstream,
    so it is reported loudly instead of skipped quietly.
    """
    data = open(path, "rb").read()
    if len(data) % KEYFILE_BLOCK:
        logging.warning(
            "Keyfile %s: size %d is not a multiple of the %d-byte block "
            "(truncated file?); trailing partial block ignored.",
            path, len(data), KEYFILE_BLOCK,
        )
    for base in range(KEYFILE_BLOCK, len(data) - KEYFILE_BLOCK + 1, KEYFILE_BLOCK):
        blk = data[base : base + KEYFILE_BLOCK]
        nkeys, chars = struct.unpack(">HH", blk[0:4])
        level = blk[4]
        if nkeys == 0 or level != 0:
            continue  # free block or interior (index) block
        if chars > KEYFILE_BLOCK:
            logging.warning(
                "Keyfile %s: leaf block at offset %d claims %d entry bytes "
                "(> block size %d) — corrupt block skipped, its %d docnos "
                "are lost.",
                path, base, chars, KEYFILE_BLOCK, nkeys,
            )
            continue
        prefix_lc = blk[5]
        prefix = blk[KEYFILE_BLOCK - prefix_lc :] if prefix_lc else b""
        # Entries fill the block tail: [end - entry_bytes, end), where the
        # end sits just before a one-byte pad and the block-prefix chars,
        # and chars counts entry bytes plus the prefix.
        end_limit = KEYFILE_BLOCK - prefix_lc - 1
        start = end_limit - (chars - prefix_lc)
        raw = _parse_keyfile_entries(blk, start, nkeys, end_limit)
        if raw is None:  # tolerate off-by-small layout variations
            for delta in (-1, 1, -2, 2):
                raw = _parse_keyfile_entries(
                    blk, start + delta, nkeys, end_limit + max(delta, 0)
                )
                if raw is not None:
                    break
        if raw is None:
            if not any(blk[max(start - 2, 6):]):
                # The claimed entry area (block tail) is all zeros: this is
                # a control/descriptor block that carries its payload at
                # the block head (the Brown index's forwardLookup0 has one
                # with nkeys=1, chars=8), not an entry list.  Zero bytes
                # cannot encode entries (every value length byte must be
                # >= 1), so nothing is lost by skipping it.
                logging.debug(
                    "Keyfile %s: level-0 block at offset %d has an empty "
                    "entry area (nkeys=%d, chars=%d) — control block, "
                    "skipped.", path, base, nkeys, chars,
                )
                continue
            # A leaf-level block we cannot parse is data loss, not noise:
            # every one of its nkeys docnos will be missing from lookups
            # (a later hard KeyError in docids_from_docnos at best).
            logging.warning(
                "Keyfile %s: unparseable leaf block at offset %d "
                "(nkeys=%d, chars=%d, prefix_lc=%d) — layout variant "
                "beyond the known ±2 offsets; its docnos are lost.",
                path, base, nkeys, chars, prefix_lc,
            )
            continue
        # Entries are stored back-to-front: reverse into ascending key
        # order, then resolve the per-entry prefix compression.
        prev_tail = b""
        for lc, suffix, value in reversed(raw):
            tail = prev_tail[:lc] + suffix
            prev_tail = tail
            yield prefix + tail, value


def _decode_docid_key(key: bytes) -> int:
    """Keyfile integer keys: big-endian base-64 bytes (byte - 0x40)."""
    val = 0
    for b in key:
        val = (val << 6) | (b - 0x40)
    return val


# ---------------------------------------------------------------------------
# The index facade.
# ---------------------------------------------------------------------------


def _parse_manifest(path: str) -> Dict[str, List[str]]:
    """Flatten the <parameters> XML into dotted keys.

    Repeated children (e.g. every <stopper><word>, or multiple
    <indexes><index> entries) accumulate as lists instead of last-wins."""
    import xml.etree.ElementTree as ET

    out: Dict[str, List[str]] = {}

    def walk(node, prefix):
        children = list(node)
        if not children:
            out.setdefault(prefix, []).append((node.text or "").strip())
            return
        for child in children:
            key = f"{prefix}.{child.tag}" if prefix else child.tag
            walk(child, key)

    walk(ET.parse(path).getroot(), "")
    return out


class _DiskIndex:
    """One on-disk index (``index/N``) of a repository."""

    def __init__(self, index_dir: str):
        self.index_dir = index_dir
        info = _parse_manifest(os.path.join(index_dir, "manifest"))
        corpus = {k.split(".", 1)[1]: v[-1] for k, v in info.items()
                  if k.startswith("corpus.")}
        self.document_base = int(corpus.get("document-base", 1))
        self.maximum_document = int(corpus["maximum-document"])
        self.document_count = int(corpus["total-documents"])
        self.total_terms = int(corpus["total-terms"])
        self.unique_terms = int(corpus["unique-terms"])
        self.frequent_count = int(corpus.get("frequent-terms", 0))

        self.document_lengths = np.fromfile(
            os.path.join(index_dir, "documentLengths"), dtype="<u4"
        ).astype(np.int64)
        self._doc_stats = np.fromfile(
            os.path.join(index_dir, "documentStatistics"),
            dtype=[("offset", "<u8"), ("byte_length", "<i4"),
                   ("indexed_length", "<i4"), ("total_length", "<i4"),
                   ("unique_terms", "<i4")],
        )
        self._direct: Optional[bytes] = None
        self._vocab: Optional[List[TermEntry]] = None
        self._decoded: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def vocabulary(self) -> List[TermEntry]:
        """This index's terms with its *local* term ids."""
        if self._vocab is None:
            freq = _parse_term_entries(
                os.path.join(self.index_dir, "frequentString"), 0
            )
            infreq = _parse_term_entries(
                os.path.join(self.index_dir, "infrequentString"),
                self.frequent_count,
            )
            self._vocab = freq + infreq
        return self._vocab

    def _decode_direct(self) -> Tuple[np.ndarray, np.ndarray]:
        """One vectorized RVL decode of the whole direct file.

        Returns (values, value_start_offsets) over the entire file; per-
        document slices are located through the documentStatistics offsets
        via searchsorted — this is what makes collection-scale ingestion a
        handful of numpy passes instead of per-document Python loops.
        """
        if self._decoded is None:
            if self._direct is None:
                self._direct = open(
                    os.path.join(self.index_dir, "directFile"), "rb"
                ).read()
            buf = np.frombuffer(self._direct, np.uint8)
            # Records are separated by raw (non-RVL) length prefixes; keep
            # only in-record bytes and remap the record offsets into the
            # compacted stream so one vectorized decode covers everything.
            offsets = self._doc_stats["offset"].astype(np.int64)
            lengths = self._doc_stats["byte_length"].astype(np.int64)
            delta = np.zeros(len(buf) + 1, np.int8)
            np.add.at(delta, offsets, 1)
            np.add.at(delta, offsets + lengths, -1)
            mask = np.cumsum(delta[:-1]) > 0
            kept_before = np.concatenate(
                ([0], np.cumsum(mask, dtype=np.int64))
            )
            values, starts = rvl_decode_all(buf[mask])
            self._compact_offsets = kept_before[offsets]
            self._decoded = (values, starts)
        return self._decoded

    def term_list(self, index_doc_id: int) -> np.ndarray:
        """Positional *local* Indri term ids for one document (0 = stopped)."""
        values, starts = self._decode_direct()
        offset = self._compact_offsets[index_doc_id - self.document_base]
        first = int(np.searchsorted(starts, int(offset)))
        term_count = int(values[first])
        # Layout: termCount, fieldCount, then the positional term ids.
        return values[first + 2 : first + 2 + term_count].astype(np.int32)


class IndriIndex:
    """Read-only view of an Indri DiskIndex repository.

    Provides the subset of the lemur API the reference's IndriSource needs
    (data_indri.cpp:16-107): corpus statistics, document lengths, per-
    document term lists, the vocabulary iterator, and docno lookups.

    Multi-index repositories (incremental builds that were never
    ``dumpindex compact``-ed — the shape a large unmerged Robust04-scale
    build produces) are supported *beyond* the reference, which LOG(FATAL)s
    on them (data_indri.cpp:43-45): the per-index term dictionaries are
    merged by term string (statistics summed) and every document's term
    list is translated into the merged id space.  For a single-index
    repository the merged ids are exactly the real Indri term ids; for a
    multi-index repository Indri itself has no repository-wide term id, so
    the merged ids are synthetic: 1-based byte-order (alphabetical) ranks
    over ALL merged term strings — the id layout an all-infrequent
    compacted index uses, so the merged read of a split repository matches
    the compacted read wherever that layout holds (see ``vocabulary()``;
    ``native/indri.cpp`` implements the same convention).  Stable for this
    framework's own ``_meta`` round trip, but not meaningful to pyndri
    until the repository is compacted.
    """

    def __init__(self, repository_path: str):
        self.path = repository_path
        manifest = os.path.join(repository_path, "manifest")
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"not an Indri repository: {repository_path}")
        repo = _parse_manifest(manifest)
        index_names = [
            v for k, vs in repo.items() if k.startswith("indexes.")
            for v in vs
        ]
        if not index_names:
            raise FileNotFoundError(
                f"repository manifest lists no indexes: {repository_path}"
            )
        self._indexes = sorted(
            (_DiskIndex(os.path.join(repository_path, "index", name))
             for name in index_names),
            key=lambda ix: ix.document_base,
        )
        for a, b in zip(self._indexes, self._indexes[1:]):
            if b.document_base != a.maximum_document:
                raise ValueError(
                    "non-contiguous document ranges across indexes: "
                    f"[..., {a.maximum_document}) then [{b.document_base}, ...)"
                )
        first = self._indexes[0]
        self.index_dir = first.index_dir
        self.document_base = first.document_base
        self.maximum_document = self._indexes[-1].maximum_document
        self.document_count = sum(ix.document_count for ix in self._indexes)
        self.total_terms = sum(ix.total_terms for ix in self._indexes)
        self.frequent_count = first.frequent_count
        self.stopwords = frozenset(
            v for k, vs in repo.items() if k.startswith("stopper.")
            for v in vs
        )
        # The indexing-time stemmer (<stemmer><name>krovetz</name>, or a
        # bare <stemmer> text node).  The reference gets query-side
        # stemming for free through pyndri's dictionary resolution
        # (py/query.py:111,141-142); this framework records the stemmer so
        # query tokenization can apply it (data/stemming.py).
        stem_names = [
            v for k, vs in repo.items() if k.startswith("stemmer")
            for v in vs if v
        ]
        self.stemmer: Optional[str] = (
            stem_names[-1].strip().lower() if stem_names else None
        )
        self.document_lengths = np.concatenate(
            [ix.document_lengths for ix in self._indexes]
        )
        self._bases = np.asarray(
            [ix.document_base for ix in self._indexes], dtype=np.int64
        )
        self._vocab: Optional[List[TermEntry]] = None
        self._local_to_merged: Optional[List[np.ndarray]] = None
        self._docnos: Optional[Dict[int, str]] = None
        self._doc_stats_cache: Optional[np.ndarray] = None

    @property
    def unique_terms(self) -> int:
        if len(self._indexes) == 1:
            return self._indexes[0].unique_terms
        return len(self.vocabulary())

    @property
    def _doc_stats(self) -> np.ndarray:
        """Concatenated per-document statistics records, in doc-id order
        (cached — callers index it in per-document loops).

        The length/unique fields are meaningful repository-wide; offsets
        remain local to each index's own direct file.
        """
        if self._doc_stats_cache is None:
            self._doc_stats_cache = np.concatenate(
                [ix._doc_stats for ix in self._indexes]
            )
        return self._doc_stats_cache

    @property
    def max_term_id(self) -> int:
        """Largest merged term id (for dense id -> x translation tables)."""
        return max((e.term_id for e in self.vocabulary()), default=0)

    def _owner(self, index_doc_id: int) -> Tuple[int, "_DiskIndex"]:
        i = int(np.searchsorted(self._bases, index_doc_id, side="right")) - 1
        return i, self._indexes[i]

    # -- document term lists -------------------------------------------------

    def document_length(self, index_doc_id: int) -> int:
        return int(self.document_lengths[index_doc_id - self.document_base])

    def term_list(self, index_doc_id: int) -> np.ndarray:
        """Positional merged term ids for one document (0 = stopped)."""
        which, ix = self._owner(index_doc_id)
        local = ix.term_list(index_doc_id)
        if len(self._indexes) == 1:
            return local
        self.vocabulary()  # builds the local -> merged translations
        assert self._local_to_merged is not None
        return self._local_to_merged[which][local]

    # -- vocabulary ----------------------------------------------------------

    def vocabulary(self) -> List[TermEntry]:
        """All terms with merged ids and corpus-wide statistics.

        Single index: exactly the index's own terms/ids.  Multiple
        indexes: merged by term string (cf/df summed); see the class
        docstring for the merged-id convention.
        """
        if self._vocab is None:
            if len(self._indexes) == 1:
                self._vocab = self._indexes[0].vocabulary()
            else:
                merged: Dict[str, TermEntry] = {}
                for ix in self._indexes:
                    for e in ix.vocabulary():
                        ent = merged.get(e.term)
                        if ent is None:
                            ent = TermEntry(e.term, 0, 0, 0)
                            merged[e.term] = ent
                        ent.total_count += e.total_count
                        ent.document_count += e.document_count
                # Merged ids: 1-based alphabetical (byte-order) ranks —
                # the id layout an all-infrequent compacted index uses, so
                # the merged read of a split repository matches the
                # compacted read wherever that layout holds.
                out = sorted(
                    merged.values(), key=lambda t: t.term.encode("utf-8")
                )
                for rank, ent in enumerate(out):
                    ent.term_id = rank + 1
                maps: List[np.ndarray] = []
                for ix in self._indexes:
                    local = ix.vocabulary()
                    max_local = max((e.term_id for e in local), default=0)
                    lmap = np.zeros(max_local + 1, dtype=np.int32)
                    for e in local:
                        lmap[e.term_id] = merged[e.term].term_id
                    maps.append(lmap)
                self._vocab = out
                self._local_to_merged = maps
        return self._vocab

    # -- docno metadata --------------------------------------------------------

    def docnos(self) -> Dict[int, str]:
        """index document id -> docno (collection/forwardLookup0)."""
        if self._docnos is None:
            path = os.path.join(self.path, "collection", "forwardLookup0")
            self._docnos = {
                _decode_docid_key(k): v.decode("utf-8", "replace")
                for k, v in iter_keyfile_entries(path)
            }
        return self._docnos

    def docids_from_docnos(self, docnos: Sequence[str]) -> List[int]:
        """docno -> index document id, preserving input order
        (QueryEnvironment::documentIDsFromMetadata parity,
        data_indri.cpp:707-711)."""
        path = os.path.join(self.path, "collection", "reverseLookup0")
        reverse = {
            k.decode("utf-8", "replace"): int.from_bytes(v, "little")
            for k, v in iter_keyfile_entries(path)
        }
        return [reverse[d] for d in docnos]


# ---------------------------------------------------------------------------
# Corpus adapter: IndriIndex -> the packed Corpus the trainer consumes.
# ---------------------------------------------------------------------------


def is_indri_repository(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(
        os.path.join(path, "manifest")
    ) and os.path.isdir(os.path.join(path, "index"))


def build_corpus_from_indri(
    repository_path: str,
    cfg,
    window_size: int,
    document_list: Optional[Sequence[str]] = None,
    term_blacklist: Optional[frozenset] = None,
):
    """Build a packed Corpus from an Indri repository.

    Reproduces IndriSource::initialize (data_indri.cpp:620-887):

    * model document ids assigned in index order (or document-list order),
      skipping documents shorter than the window, truncated by the cutoff;
    * vocabulary filtered by digit/blacklist/df bounds over *corpus-wide*
      statistics, top-K by collection frequency with ids in ascending
      (cf, Indri term id) order, frequencies recomputed over the selected
      document subset (data_indri.cpp:592-618);
    * per-document token streams translate Indri term ids through the
      vocabulary (stopped/OOV positions dropped, or emitted as id 0 under
      ``include_oov`` — generate_terms, data_indri.cpp:117-133);
    * ``index_term_ids`` carry the *real* Indri term ids, so checkpoint
      ``_meta`` stays interoperable with pyndri consumers.
    """
    from cunvsm.data.corpus import Corpus
    from cunvsm.data.text import is_number
    from cunvsm.data.vocab import Vocabulary

    index = IndriIndex(repository_path)

    # -- document selection (data_indri.cpp:652-733) --------------------------
    if document_list is not None:
        candidate_ids = index.docids_from_docnos(document_list)
        num_documents = len(document_list)
    else:
        candidate_ids = list(
            range(index.document_base, index.maximum_document)
        )
        num_documents = index.document_count
    if cfg.documents_cutoff > 0:
        num_documents = min(num_documents, cfg.documents_cutoff)

    kept_ids: List[int] = []
    for doc_id in candidate_ids:
        if len(kept_ids) >= num_documents:
            break
        if index.document_length(doc_id) >= window_size:
            kept_ids.append(doc_id)

    docno_map = index.docnos()
    docnos = [docno_map[d] for d in kept_ids]
    index_lengths = np.asarray(
        [index.document_length(d) for d in kept_ids], dtype=np.int64
    )

    # -- vocabulary (data_indri.cpp:735-869) ----------------------------------
    max_df = cfg.max_document_frequency
    if 0 < max_df <= 1.0:
        max_df = int(np.ceil(index.document_count * max_df))
    max_df = int(max_df)

    candidates = []
    for entry in index.vocabulary():
        if not cfg.include_digits and is_number(entry.term):
            continue
        if term_blacklist and entry.term in term_blacklist:
            continue
        if (cfg.min_document_frequency > 0
                and entry.document_count < cfg.min_document_frequency):
            continue
        if max_df > 0 and entry.document_count > max_df:
            continue
        candidates.append((entry.total_count, entry.term_id, entry.term))
    candidates.sort()
    if cfg.max_vocabulary_size and len(candidates) > cfg.max_vocabulary_size:
        candidates = candidates[-cfg.max_vocabulary_size:]

    # Subset recount when training on a restricted document set
    # (data_indri.cpp:592-618): counted over raw Indri term ids.
    subset_cf: Optional[Dict[int, int]] = None
    if len(kept_ids) != index.document_count:
        subset_cf = {}
        for doc_id in kept_ids:
            tl = index.term_list(doc_id)
            ids, counts = np.unique(tl[tl != 0], return_counts=True)
            for i, c in zip(ids.tolist(), counts.tolist()):
                subset_cf[i] = subset_cf.get(i, 0) + c

    terms: List[str] = []
    index_ids: List[int] = []
    freqs: List[int] = []
    if cfg.include_oov:
        terms.append("")
        index_ids.append(0)
        freqs.append(1)
    for cf, tid, term in candidates:
        if subset_cf is not None:
            cf = subset_cf.get(tid, 0)
            if cf == 0:
                continue  # data_indri.cpp:843-845
        terms.append(term)
        index_ids.append(tid)
        freqs.append(cf)

    term_to_id = {t: i for i, t in enumerate(terms) if t}
    vocab = Vocabulary(
        terms=terms,
        term_to_id=term_to_id,
        term_freq=np.asarray(freqs, dtype=np.int64),
        total_terms=int(sum(f for t, f in zip(terms, freqs) if t)),
        include_oov=cfg.include_oov,
        index_term_ids=np.asarray(index_ids, dtype=np.int64),
    )

    # -- token streams (generate_terms, data_indri.cpp:117-133) ---------------
    indri_to_model = np.full(index.max_term_id + 1, -1, dtype=np.int64)
    for model_id, tid in enumerate(index_ids):
        if tid > 0:
            indri_to_model[tid] = model_id

    token_chunks: List[np.ndarray] = []
    offsets = [0]
    for doc_id in kept_ids:
        tl = index.term_list(doc_id)
        mapped = indri_to_model[tl]
        if cfg.include_oov:
            ids = np.where(mapped >= 0, mapped, 0)
        else:
            ids = mapped[mapped >= 0]
        token_chunks.append(ids.astype(np.int32))
        offsets.append(offsets[-1] + len(ids))

    return Corpus(
        vocab=vocab,
        tokens=(np.concatenate(token_chunks) if token_chunks
                else np.zeros((0,), np.int32)),
        doc_offsets=np.asarray(offsets, dtype=np.int64),
        index_lengths=index_lengths,
        docnos=docnos,
        window_size=window_size,
        index_doc_ids=np.asarray(kept_ids, dtype=np.int64),
        stemmer=index.stemmer,
    )
