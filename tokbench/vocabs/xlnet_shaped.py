"""xlnet-shaped unigram-LM vocabulary: a frozen copy of
``blingfire_tpu_torch.testing``'s ``xlnet_shaped_entries`` and
``xlnet_charmap``.

Laid out as xlnet's spiece.model is in BlingFire's xlnet.bin: char mode,
unigram LM, ids 0-2 reserved (<unk> = 0), entries from id 3 in descending
score order.  The entries are ``▁`` alone; single characters covering
ASCII, Latin-1, the scripts of the edge cases and ``n_cjk`` seeded CJK
characters (emoji stay out, so unknown runs occur); numbers and punctuation
pairs; and pieces of 2-15 symbols cut from a seeded word list.  Scores are
float32 log-probabilities falling with frequency rank, with seeded jitter,
400 of them rounded to a few shared values.  The seeded pieces stand in for
xlnet's published pieces."""

from __future__ import annotations

import unicodedata

import numpy as np

from tb.corpus import EDGE_CASES, word_list

SPM = 0x2581
RESERVED = 3
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


def charmap(cfg: dict | None = None) -> dict[int, list[int]]:
    """NFKC of the fullwidth forms U+FF01-FF5E and of the ligatures
    U+FB00-FB06, as xlnet's normalization map has them."""
    cps = list(range(0xFF01, 0xFF5F)) + list(range(0xFB00, 0xFB07))
    return {cp: [ord(ch) for ch in unicodedata.normalize("NFKC", chr(cp))]
            for cp in cps}


def _alphabet(rng: np.random.Generator, n_cjk: int) -> list[int]:
    mapped = set(charmap())
    chars = set(range(0x21, 0x7F)) | set(range(0xA1, 0x100))
    for lo, hi in _SCRIPT_RANGES:
        chars |= set(range(lo, hi))
    for s in EDGE_CASES:
        chars |= {ord(ch) for ch in s}
    chars = {c for c in chars
             if c < 0x1F000
             and c != SPM and c not in mapped
             and not unicodedata.category(chr(c)).startswith(("C", "Z"))}
    cjk = rng.choice(np.arange(0x4E00, 0xA000), n_cjk, replace=False)
    return sorted(chars | {int(c) for c in cjk})


def entries(cfg: dict) -> list[tuple[tuple[int, ...], int, float]]:
    """(symbols, id, score) of each entry, ids from 3 in score order."""
    n, seed, n_cjk = cfg["vocab_size"], cfg["vocab_seed"], cfg["n_cjk"]
    rng = np.random.default_rng(seed + 2)
    alphabet = _alphabet(rng, n_cjk)
    if n <= len(alphabet) + 200:
        raise ValueError("vocabulary too small for its alphabet")
    ascii_ = [c for c in alphabet if c < 0x80]
    rare = [c for c in alphabet if c >= 0x80]
    pool = ([tuple(str(v).encode()) for v in range(10, 1000)]
            + [(SPM,) + tuple(str(v).encode()) for v in range(1000)]
            + [(a, b) for a in _PUNCT for b in _PUNCT])
    k = min(len(pool), (n - 1 - len(alphabet)) // 2)
    pool = [pool[i] for i in np.sort(rng.permutation(len(pool))[:k])]
    fixed = 1 + len(alphabet) + len(pool)
    pieces: dict[tuple[int, ...], None] = {}
    words = word_list(seed, max((n - fixed) // 3, 64))
    for w in words:
        t = tuple(w)
        for j in range(1, len(t) + 1):
            pieces.setdefault((SPM,) + t[:j], None)
        for m in (2, 3, 4):
            if len(t) > m:
                pieces.setdefault(t[-m:], None)
        if len(pieces) >= n - fixed:
            break
    if len(pieces) < n - fixed:
        raise ValueError("word list too short")
    word_pieces = list(pieces)[: n - fixed]
    singles = [(SPM,)] + [(c,) for c in ascii_]
    head, tail = word_pieces[:2000], word_pieces[2000:]
    rest = pool + [(c,) for c in rare] + tail
    ordered = singles + head + [rest[i] for i in rng.permutation(len(rest))]
    rank = np.arange(len(ordered), dtype=np.float64)
    score = -(2.0 + np.log1p(rank)) + rng.normal(0.0, 0.3, len(ordered))
    tie = rng.choice(len(ordered), 400, replace=False)
    score[tie] = -np.round(-score[tie] * 2) / 2
    score = np.minimum(score, -1.0).astype(np.float32)
    by_score = np.argsort(-score, kind="stable")
    return [(ordered[i], RESERVED + k, float(score[i]))
            for k, i in enumerate(by_score)]
