"""Text preprocessing for the NLP federated benchmarks (port of
fedml_tpu/data/text.py; host-side numpy, bitwise equal to the JAX package's).

Parity targets (reference fedml_api/data_preprocessing/*):
  - shakespeare (LEAF JSON):   language_utils.py:1-55, shakespeare/
    data_loader.py:54-61 — 80-char windows -> next-char, char ids via
    ALL_LETTERS.find, VOCAB_SIZE = 86 + 4.
  - fed_shakespeare (TFF h5):  fed_shakespeare/utils.py:15-82 — snippets
    tokenized as [bos] + chars + [eos], padded to 81-multiples, chunked to
    81, x = seq[:-1], y = seq[1:].
  - stackoverflow_nwp (TFF h5): stackoverflow_nwp/utils.py:56-86 — space
    tokenizer, top-10k word vocab from `stackoverflow.word_count`,
    [bos] + ids (+[eos]) + pad to 21, x/y shifted.
  - stackoverflow_lr (TFF h5): stackoverflow_lr/utils.py:66-131 — mean
    bag-of-words features (10,000-dim) from tokens+title, multi-hot tag
    targets (500-dim) from `stackoverflow.tag_count`.

Everything is vectorized numpy (byte-LUT for chars, dict lookups batched per
client) — the output feeds straight into build_client_shards.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np

# Public vocabulary from the TFF text-generation tutorial (same constant the
# reference re-uses, language_utils.py:12-14 / fed_shakespeare/utils.py:18-20).
SHAKESPEARE_CHARS = (
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
SHAKESPEARE_VOCAB_SIZE = len(SHAKESPEARE_CHARS) + 4      # 90: +pad/bos/eos/oov
SHAKESPEARE_SEQ_LEN = 80

PAD, BOS, EOS = "<pad>", "<bos>", "<eos>"


def _char_lut(offset: int, oov_id: int) -> np.ndarray:
    """256-entry byte -> id lookup table. ids are `offset + position` in
    SHAKESPEARE_CHARS; any byte outside the vocabulary maps to oov_id."""
    lut = np.full(256, oov_id, np.int32)
    for i, ch in enumerate(SHAKESPEARE_CHARS):
        lut[ord(ch)] = offset + i
    return lut


# LEAF convention: ids are raw ALL_LETTERS positions (0..85). The reference
# leaves OOV at find()'s -1 (language_utils.py:37); we use the first reserved
# slot (86) so ids index cleanly into the 90-wide embedding.
_LEAF_LUT = _char_lut(offset=0, oov_id=len(SHAKESPEARE_CHARS))
# TFF convention (fed_shakespeare/utils.py:23-50): pad=0, chars 1..86,
# bos=87, eos=88, oov=89.
_TFF_PAD = 0
_TFF_BOS = len(SHAKESPEARE_CHARS) + 1                    # 87
_TFF_EOS = len(SHAKESPEARE_CHARS) + 2                    # 88
_TFF_OOV = len(SHAKESPEARE_CHARS) + 3                    # 89
_TFF_LUT = _char_lut(offset=1, oov_id=_TFF_OOV)


def chars_to_ids(strings: Iterable[str], lut: np.ndarray = _LEAF_LUT,
                 width: Optional[int] = None) -> np.ndarray:
    """Vectorized char -> id for equal-length strings; returns [n, width].

    Non-latin-1 characters are OOV by construction (they can't be a vocab
    byte), encoded with errors="replace" so the LUT sees a valid byte.
    """
    rows = [np.frombuffer(s.encode("latin-1", errors="replace"), np.uint8)
            for s in strings]
    if width is None:
        width = max((len(r) for r in rows), default=0)
    # byte 0 is never in the vocabulary, so short strings pad to OOV ids
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        r = r[:width]
        out[i, :len(r)] = r
    return lut[out]


def leaf_shakespeare_to_arrays(users: list[str], user_data: dict):
    """LEAF shakespeare: x = 80-char strings, y = single next chars
    (shakespeare/data_loader.py:54-61).  Returns (x [n,80] i32, y [n] i64,
    idx_map) with the LEAF char-id convention."""
    xs, ys, idx_map, off = [], [], {}, 0
    for i, u in enumerate(users):
        ux = chars_to_ids(user_data[u]["x"], _LEAF_LUT, SHAKESPEARE_SEQ_LEN)
        uy = chars_to_ids([c[0] for c in user_data[u]["y"]], _LEAF_LUT, 1)[:, 0]
        xs.append(ux.astype(np.int32))
        ys.append(uy.astype(np.int64))
        idx_map[i] = np.arange(off, off + len(uy))
        off += len(uy)
    return np.concatenate(xs), np.concatenate(ys), idx_map


def tff_snippets_to_sequences(snippets: Iterable[str],
                              seq_len: int = SHAKESPEARE_SEQ_LEN):
    """fed_shakespeare preprocess (utils.py:53-82): each snippet becomes
    [bos] + char-ids + [eos], padded to a multiple of (seq_len+1), chunked;
    returns (x [n,seq_len] i32, y [n,seq_len] i64)."""
    chunks = []
    for s in snippets:
        ids = _TFF_LUT[np.frombuffer(
            s.encode("latin-1", errors="replace"), np.uint8)]
        tok = np.concatenate([[_TFF_BOS], ids, [_TFF_EOS]])
        pad = (-len(tok)) % (seq_len + 1)
        if pad:
            tok = np.concatenate([tok, np.full(pad, _TFF_PAD)])
        chunks.append(tok.reshape(-1, seq_len + 1))
    if not chunks:
        return (np.zeros((0, seq_len), np.int32),
                np.zeros((0, seq_len), np.int64))
    seq = np.concatenate(chunks)
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int64)


# ---------------------------------------------------------------------------
# StackOverflow word vocabulary
# ---------------------------------------------------------------------------

def read_word_count_vocab(path: str, vocab_size: int = 10000) -> list[str]:
    """Top-N words from `stackoverflow.word_count` ("word count" per line,
    already frequency-sorted — stackoverflow_nwp/utils.py:27-31)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    words = []
    with open(path) as f:
        for line in f:
            words.append(line.split()[0])
            if len(words) >= vocab_size:
                break
    return words


def read_tag_count_vocab(path: str, tag_size: int = 500) -> list[str]:
    """Top-N tags from the `stackoverflow.tag_count` JSON dict (insertion-
    ordered by frequency — stackoverflow_lr/utils.py:40-44)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        return list(json.load(f).keys())[:tag_size]


class WordVocab:
    """NWP word dict: pad=0, words 1..N, bos=N+1, eos=N+2, oov=N+3
    (stackoverflow_nwp/utils.py:34-42 with the single-OOV-bucket default).
    vocab_len = N + 4 matches RNNStackOverflow's 10004."""

    def __init__(self, words: list[str]):
        self.word_to_id = {w: i + 1 for i, w in enumerate(words)}
        self.pad_id = 0
        self.bos_id = len(words) + 1
        self.eos_id = len(words) + 2
        self.oov_id = len(words) + 3
        self.vocab_len = len(words) + 4

    def sentence_to_ids(self, sentence: str, max_seq_len: int = 20) -> np.ndarray:
        """[bos] + ids (+[eos] when short) + pad, to max_seq_len+1 tokens."""
        toks = [self.word_to_id.get(w, self.oov_id)
                for w in sentence.split(" ")[:max_seq_len]]
        if len(toks) < max_seq_len:
            toks.append(self.eos_id)
        toks = [self.bos_id] + toks
        toks += [self.pad_id] * (max_seq_len + 1 - len(toks))
        return np.asarray(toks[:max_seq_len + 1], np.int32)

    def sentences_to_xy(self, sentences: Iterable[str],
                        max_seq_len: int = 20):
        seqs = np.stack([self.sentence_to_ids(s, max_seq_len)
                         for s in sentences])
        return seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int64)


class BagOfWordsVocab:
    """LR featureizer: mean bag-of-words over the top-10k vocab (OOV column
    dropped — stackoverflow_lr/utils.py:78-85, 107-124)."""

    def __init__(self, words: list[str]):
        self.word_to_id = {w: i for i, w in enumerate(words)}
        self.dim = len(words)

    def sentences_to_features(self, sentences: Iterable[str]) -> np.ndarray:
        out = []
        for s in sentences:
            toks = s.split(" ")
            v = np.zeros(self.dim, np.float32)
            for t in toks:
                i = self.word_to_id.get(t)
                if i is not None:
                    v[i] += 1.0
            out.append(v / max(len(toks), 1))
        return np.stack(out) if out else np.zeros((0, self.dim), np.float32)


class TagVocab:
    """Multi-hot tag targets over the top-500 tags; '|'-separated raw tags,
    OOV column dropped (stackoverflow_lr/utils.py:88-104)."""

    def __init__(self, tags: list[str]):
        self.tag_to_id = {t: i for i, t in enumerate(tags)}
        self.dim = len(tags)

    def tags_to_targets(self, raw_tags: Iterable[str]) -> np.ndarray:
        out = []
        for raw in raw_tags:
            v = np.zeros(self.dim, np.float32)
            for t in raw.split("|"):
                i = self.tag_to_id.get(t)
                if i is not None:
                    v[i] = 1.0
            out.append(v)
        return np.stack(out) if out else np.zeros((0, self.dim), np.float32)


def _decode(arr) -> list[str]:
    """h5py string datasets arrive as bytes; tolerate str too."""
    return [a.decode("utf-8", errors="replace") if isinstance(a, bytes)
            else str(a) for a in np.asarray(arr).ravel()]


def stackoverflow_nwp_arrays(client_data: dict, vocab: WordVocab,
                             max_seq_len: int = 20, max_clients=None):
    """{cid: {"tokens": [...]}} (read_tff_h5 output) -> stacked NWP arrays.
    Returns (x [n,T] i32, y [n,T] i64, idx_map)."""
    xs, ys, idx_map, off = [], [], {}, 0
    for i, cid in enumerate(sorted(client_data)[:max_clients]):
        sents = _decode(client_data[cid]["tokens"])
        x, y = vocab.sentences_to_xy(sents, max_seq_len)
        xs.append(x); ys.append(y)
        idx_map[i] = np.arange(off, off + len(y)); off += len(y)
    return np.concatenate(xs), np.concatenate(ys), idx_map


def stackoverflow_lr_arrays(client_data: dict, words: BagOfWordsVocab,
                            tags: TagVocab, max_clients=None):
    """{cid: {"tokens","title","tags"}} -> (x [n,10000] f32 bag-of-words over
    tokens+title, y [n,500] f32 multi-hot, idx_map). Reference joins tokens
    and title with a space (stackoverflow_lr/dataset.py:57-60)."""
    xs, ys, idx_map, off = [], [], {}, 0
    for i, cid in enumerate(sorted(client_data)[:max_clients]):
        d = client_data[cid]
        sents = [" ".join(p) for p in zip(_decode(d["tokens"]),
                                          _decode(d["title"]))]
        x = words.sentences_to_features(sents)
        y = tags.tags_to_targets(_decode(d["tags"]))
        xs.append(x); ys.append(y)
        idx_map[i] = np.arange(off, off + len(y)); off += len(y)
    return np.concatenate(xs), np.concatenate(ys), idx_map
