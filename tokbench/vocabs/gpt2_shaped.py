"""gpt2-shaped byte-level BPE vocabulary: a frozen copy of
``blingfire_tpu_torch.testing.gpt2_shaped_entries``.

Laid out as BlingFire's compiler lays out gpt2 (byte mode, BPE_OPT, ids
1..n with score -id, id offset -1): the 255 non-space bytes and ``▁``
(U+2581), ids 1..256; pieces of 2-16 symbols cut from a seeded word list,
``▁`` only first; ``n_long`` punctuation runs of 17-48 symbols.  The seeded
pieces stand in for GPT-2's published merges."""

from __future__ import annotations

import numpy as np

from tb.corpus import LETTERS, LONG_CHARS, word_list

SPM = 0x2581


def entries(cfg: dict) -> list[tuple[tuple[int, ...], int, float]]:
    """(symbols, id, score) of each entry, ids 1..n, score -id."""
    n, seed, n_long = cfg["vocab_size"], cfg["vocab_seed"], cfg["n_long"]
    singles = [(b,) for b in range(256) if b != 0x20] + [(SPM,)]
    longs: list[tuple[int, ...]] = []
    k = 0
    while len(longs) < n_long:
        ch = LONG_CHARS[k % len(LONG_CHARS)]
        ln = 17 + (k // len(LONG_CHARS)) % 32
        body = (ch,) * ln
        longs.append(((SPM,) + body[1:]) if k % 2 else body)
        k += 1
    n_pieces = n - len(singles) - len(longs)
    if n_pieces <= 0:
        raise ValueError("vocabulary too small for its single symbols")
    chains: dict[tuple[int, ...], None] = {}
    taken = set(singles) | set(longs)
    rng = np.random.default_rng(seed + 1)
    words = word_list(seed, max(n_pieces // 3, 64))
    for w in words:
        t = tuple(w)
        cands = [(SPM,) + t, t]
        cands += [(SPM,) + t[:j] for j in range(2, len(t))]
        for _ in range(2):
            i = int(rng.integers(0, len(t)))
            j = int(rng.integers(i + 2, len(t) + 3))
            cands.append(t[i:j])
        for c in cands:
            if 2 <= len(c) <= 16 and c not in taken and c not in chains:
                chains[c] = None
        if len(chains) >= n_pieces:
            break
    while len(chains) < n_pieces:
        c = tuple(int(v) for v in rng.choice(LETTERS, int(rng.integers(2, 4))))
        if c not in taken:
            chains[c] = None
    pieces = list(chains)[:n_pieces]
    ordered = singles + pieces[: n_pieces // 2] + longs + pieces[n_pieces // 2:]
    return [(c, i + 1, -float(i + 1)) for i, c in enumerate(ordered)]


def charmap(cfg: dict) -> dict[int, list[int]] | None:
    return None
