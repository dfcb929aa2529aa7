"""Mistral-shaped SentencePiece BPE vocabulary: seeded pieces laid out as
Mistral-7B-v0.1's tokenizer.model (32,000 ids) is, in the form BlingFire
compiles a SentencePiece BPE (``tokalgo bpe-opt``, char mode, a piece's
rank is its id).

Ids 0-258 are reserved and are no dictionary entries: ``<unk> <s> </s>``
and the 256 byte-fallback pieces ``<0x00>``..``<0xFF>``.  BlingFire has no
byte fallback, so an unknown character gives id 0.  From id 259 the
multi-symbol pieces follow in merge order, shorter first: the 15 runs of
2-16 ``▁`` (kept for indentation, ``▁▁`` first at id 259), numbers and
punctuation pairs, ``▁`` + each prefix of a frequent word and the word's
endings of 2-4 symbols.  The single characters come last, ``▁`` first:
ASCII, Latin-1, the scripts of the edge cases and ``n_cjk`` seeded CJK
ideographs (emoji stay out, so unknown runs occur).  The ``▁`` runs have
an internal ``▁``, so the model is not chunk-safe.  No charmap: Mistral's
normalizer is the identity.  The seeded pieces stand in for Mistral's
published pieces."""

from __future__ import annotations

import unicodedata

import numpy as np

from tb.corpus import EDGE_CASES, word_list

SPM = 0x2581
_SCRIPT_RANGES = [
    (0x391, 0x3CA),  # Greek
    (0x410, 0x450),  # Cyrillic
    (0x5D0, 0x5EB),  # Hebrew
    (0x621, 0x64B),  # Arabic
    (0x905, 0x93A), (0x93E, 0x94E),  # Devanagari letters, vowel signs
    (0x3041, 0x3097),  # Hiragana
    (0x30A1, 0x30FB),  # Katakana
]
_PUNCT = b".,!?;:'\"()-/%$#&*[]"


def charmap(cfg: dict | None = None) -> dict[int, list[int]] | None:
    return None


def alphabet(rng: np.random.Generator, n_cjk: int) -> list[int]:
    """The single characters other than ``▁``, in code point order."""
    chars = set(range(0x21, 0x7F)) | set(range(0xA1, 0x100))
    for lo, hi in _SCRIPT_RANGES:
        chars |= set(range(lo, hi))
    for s in EDGE_CASES:
        chars |= {ord(ch) for ch in s}
    chars = {c for c in chars
             if c < 0x1F000 and c != SPM
             and not unicodedata.category(chr(c)).startswith(("C", "Z"))}
    cjk = rng.choice(np.arange(0x4E00, 0xA000), n_cjk, replace=False)
    return sorted(chars | {int(c) for c in cjk})


def entries(cfg: dict) -> list[tuple[tuple[int, ...], int, float]]:
    """(symbols, id, score) of each entry, ids from ``reserved_ids`` with
    score -id."""
    n, seed = cfg["vocab_size"], cfg["vocab_seed"]
    reserved, n_cjk = cfg["reserved_ids"], cfg["n_cjk"]
    rng = np.random.default_rng(seed + 3)
    singles = [(SPM,)] + [(c,) for c in alphabet(rng, n_cjk)]
    runs = [(SPM,) * k for k in range(2, 2 + cfg["spm_runs"])]
    want = n - reserved - len(singles) - len(runs)
    if want <= 200:
        raise ValueError("vocabulary too small for its alphabet")
    # numbers and punctuation pairs: many entries, few automaton states
    pool = ([tuple(str(v).encode()) for v in range(10, 1000)]
            + [(SPM,) + tuple(str(v).encode()) for v in range(1000)]
            + [(a, b) for a in _PUNCT for b in _PUNCT])
    k = min(len(pool), want // 4)
    pool = [pool[i] for i in np.sort(rng.permutation(len(pool))[:k])]
    # ▁ + every prefix of a frequent word and the word's endings
    pieces: dict[tuple[int, ...], None] = dict.fromkeys(pool)
    for w in word_list(seed, max(want // 3, 64)):
        t = tuple(w)
        for j in range(1, len(t) + 1):
            pieces.setdefault((SPM,) + t[:j], None)
        for m in (2, 3, 4):
            if len(t) > m:
                pieces.setdefault(t[-m:], None)
        if len(pieces) >= want:
            break
    if len(pieces) < want:
        raise ValueError("word list too short")
    # merge order: shorter pieces first, the ▁ runs first of their length
    multi = sorted(runs + list(pieces)[:want], key=len)
    return [(ch, reserved + i, -float(reserved + i))
            for i, ch in enumerate(multi + singles)]
