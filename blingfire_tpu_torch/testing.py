"""Seeded gpt2-shaped byte-BPE, xlnet-shaped unigram-LM, SentencePiece-BPE-
shaped merges and bert-shaped WordPiece models and a corpus for the tests
and chip_smoke.py.

Not on the main path.  The gpt2-shaped model is laid out as the dict
compiler lays out gpt2 (compiler/dict.py::vocab_from_hf_gpt2): byte mode,
BPE_OPT, ids 1..n with score -id, id offset -1.  Its entries are

* the 255 non-space bytes plus ``▁`` (U+2581, the space mark), ids 1..256;
* pieces of 2-16 symbols cut from a seeded word list, ``▁`` only first;
* ``n_long`` pieces of 17-48 symbols (punctuation runs, as gpt2 has), so
  that the unbounded depth-16 walk of packed-row region B sees live states
  at its cap and flags rows for the host fallback.

The xlnet-shaped model (:func:`xlnet_shaped_model_bytes`) is a char-mode
unigram LM with a charmap, laid out as xlnet is.  In both, every piece has
``▁`` only in first position, so the model is chunk-safe and takes the
unique-unit device path.  The corpus draws Zipfian words from the same word
list, adds rare words, punctuation and long punctuation runs, and includes
the edge cases of tests/corpus.py (copied below).  The bert-shaped
WordPiece model (:func:`bert_shaped_model_bytes`) covers the corpus's word
list with whole words, prefixes and ``##`` pieces; the
multilingual-bert-shaped one (:func:`mbert_shaped_model_bytes`) adds
scripts and seeded CJK ideographs, so that the hybrid declines its dense
table.  The syllab-shaped W2H
hyphenation model (:func:`syllab_shaped_model_bytes`) is built from seeded
patterns with syllab.bin's settings; :func:`corpus_words` turns the corpus
into its traffic.  The SentencePiece-BPE-shaped model
(:func:`spm_bpe_shaped_model_bytes`) has pieces that span two words, so it
is not chunk-safe.  :func:`dp_rank` is one rank of the data-parallel tests,
started with torch.multiprocessing spawn.
"""

from __future__ import annotations

import numpy as np

from .compiler.dict import DictModelSpec, VocabEntry, compile_dict_model
from .formats.consts import TokAlgo

SPM = 0x2581
GPT2_VOCAB = 50256
LONG_CHARS = b"-=_.*#~+/!"

# copy of tests/corpus.py::EDGE_CASES
EDGE_CASES = [
    "hello world",
    "Hello, World!",
    " ",
    "  ",
    "\t\n  \t",
    "a",
    "I saw a girl with a \ttelescope.",
    "Sergei Alonichau I saw a girl with a \ttelescope.",
    "This is a test of the emergency broadcast system.",
    "don't can't won't it's",
    "3.14159 2,000,000 $5.99 100%",
    "e-mail user@example.com http://www.example.com/path?q=1",
    "naïve café résumé façade",
    "ÉPPLE Épple épple",
    "Привет мир",  # Cyrillic
    "你好世界",  # Chinese
    "こんにちは世界",  # Japanese
    "안녕하세요 세계",  # Korean
    "مرحبا بالعالم",  # Arabic
    "שלום עולם",  # Hebrew
    "Ελληνικά κείμενο",  # Greek
    "हिन्दी पाठ",  # Devanagari
    "🙂 emoji 🚀 test 🎉",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕞𝕒𝕥𝕙",  # SMP codepoints
    "mixed中文and English",
    "trailing space ",
    " leading space",
    "  double  spaces  everywhere  ",
    "hyphen-ated multi-word-token",
    "ALL CAPS TEXT HERE",
    "CamelCaseIdentifier snake_case_name kebab-case-name",
    "(parens) [brackets] {braces} <angles>",
    'quotes "double" \'single\' `back`',
    "semi;colon co:lon el...lipsis",
    "x y z　w",  # exotic whitespace
    "a▁b",  # literal U+2581 in input
    "▁",
    "ab\x01cd\x02ef",  # control chars
    "supercalifragilisticexpialidocious pneumonoultramicroscopicsilicovolcanoconiosis",
    "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    "ab" * 100,
    "word " * 50,
    "ÃÂÃÂÃÂÃÂ",  # mojibake (common in gpt2 vocab)
    "1234567890" * 10,
    "!@#$%^&*()_+-=[]{}|;:,.<>?/~`",
    "\x7f\x7f",
    "Ｆｕｌｌｗｉｄｔｈ ｔｅｘｔ",
    "ǅungla ǈljubljana",  # titlecase digraphs
    "ﬁ ﬂ ﬀ ligatures",
    "ß ẞ İ ı",  # tricky case folds
    "é combining acute",
    "\x00embedded null",
]

# English letter frequencies (a..z), for pronounceable-ish synthetic words
_LETTER_P = np.array([
    8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4,
    6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074,
])
_LETTER_P = _LETTER_P / _LETTER_P.sum()
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def _random_words(rng: np.random.Generator, n: int, lo: int = 2,
                  hi: int = 14) -> list[bytes]:
    lens = np.clip(rng.geometric(0.2, size=n) + lo - 1, lo, hi)
    letters = rng.choice(_LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cuts = np.concatenate([[0], np.cumsum(lens)])
    blob = letters.tobytes()
    return [blob[cuts[i]:cuts[i + 1]] for i in range(n)]


def word_list(seed: int, n_words: int) -> list[bytes]:
    """Distinct synthetic words, most frequent first; ~10% capitalized."""
    rng = np.random.default_rng(seed)
    out: list[bytes] = []
    seen: set[bytes] = set()
    while len(out) < n_words:
        for w in _random_words(rng, 2 * (n_words - len(out)) + 16):
            if rng.random() < 0.1:
                w = w[:1].upper() + w[1:]
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == n_words:
                    break
    return out


def gpt2_shaped_entries(n: int = GPT2_VOCAB, seed: int = 0,
                        n_long: int = 320) -> list[VocabEntry]:
    """``n`` vocabulary entries with ids 1..n and score -id (see module doc)."""
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
    assert n_pieces > 0, "vocabulary too small for its single symbols"
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
    # pad with seeded random byte pairs/triples when the words ran out
    while len(chains) < n_pieces:
        c = tuple(int(v) for v in rng.choice(_LETTERS, int(rng.integers(2, 4))))
        if c not in taken:
            chains[c] = None
    pieces = list(chains)[:n_pieces]
    ordered = singles + pieces[: n_pieces // 2] + longs + pieces[n_pieces // 2:]
    return [VocabEntry(c, i + 1, -float(i + 1)) for i, c in enumerate(ordered)]


def gpt2_shaped_model_bytes(n: int = GPT2_VOCAB, seed: int = 0,
                            n_long: int = 320,
                            tok_algo: TokAlgo = TokAlgo.BPE_OPT) -> bytes:
    """Compiled .bin image of the gpt2-shaped byte-BPE model.

    ``tok_algo=TokAlgo.BPE_OPT_WITH_MERGES`` gives the same vocabulary as a
    merges model; its scores (-id) are all negative, so it runs in
    merge-priority mode."""
    spec = DictModelSpec(
        entries=gpt2_shaped_entries(n, seed, n_long),
        tok_algo=tok_algo,
        id_offset=-1,
        use_byte_encoding=True,
    )
    return compile_dict_model(spec)


XLNET_VOCAB = 32000
XLNET_RESERVED = 3  # ids 0..2 (<unk> = 0, <s>, </s>) are not dictionary entries
# scripts beside ASCII and Latin-1 that the alphabet covers in full
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


def xlnet_charmap() -> dict[int, list[int]]:
    """NFKC of the fullwidth forms U+FF01-FF5E and of the ligatures
    U+FB00-FB06, as xlnet's normalization map has them."""
    import unicodedata

    cps = list(range(0xFF01, 0xFF5F)) + list(range(0xFB00, 0xFB07))
    return {cp: [ord(ch) for ch in unicodedata.normalize("NFKC", chr(cp))]
            for cp in cps}


def _xlnet_alphabet(rng: np.random.Generator, n_cjk: int) -> list[int]:
    import unicodedata

    mapped = set(xlnet_charmap())
    chars = set(range(0x21, 0x7F)) | set(range(0xA1, 0x100))
    for lo, hi in _SCRIPT_RANGES:
        chars |= set(range(lo, hi))
    for s in EDGE_CASES:
        chars |= {ord(ch) for ch in s}
    chars = {c for c in chars
             if c < 0x1F000  # emoji stay out: unknown runs
             and c != SPM and c not in mapped
             and not unicodedata.category(chr(c)).startswith(("C", "Z"))}
    cjk = rng.choice(np.arange(0x4E00, 0xA000), n_cjk, replace=False)
    return sorted(chars | {int(c) for c in cjk})


def xlnet_shaped_entries(n: int = XLNET_VOCAB, seed: int = 0,
                         n_cjk: int = 420) -> list[VocabEntry]:
    """``n`` unigram-LM entries, ids from 3 in score order (see
    :func:`xlnet_shaped_model_bytes`)."""
    rng = np.random.default_rng(seed + 2)
    alphabet = _xlnet_alphabet(rng, n_cjk)
    assert n > len(alphabet) + 200, "vocabulary too small for its alphabet"
    # frequency order: ▁ and ASCII first, then pieces and the rarer
    # characters interleaved
    ascii_ = [c for c in alphabet if c < 0x80]
    rare = [c for c in alphabet if c >= 0x80]
    # numbers and punctuation pairs: many entries, few automaton states
    pool = ([tuple(str(v).encode()) for v in range(10, 1000)]
            + [(SPM,) + tuple(str(v).encode()) for v in range(1000)]
            + [(a, b) for a in _PUNCT for b in _PUNCT])
    k = min(len(pool), (n - 1 - len(alphabet)) // 2)
    pool = [pool[i] for i in np.sort(rng.permutation(len(pool))[:k])]
    fixed = 1 + len(alphabet) + len(pool)
    # word pieces: ▁ + every prefix of a frequent word (the pieces of a
    # word share its path, so the automaton stays small), then the
    # word's endings of 2-4 symbols as non-initial pieces
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
    assert len(pieces) >= n - fixed, "word list too short"
    word_pieces = list(pieces)[: n - fixed]
    singles = [(SPM,)] + [(c,) for c in ascii_]
    head, tail = word_pieces[:2000], word_pieces[2000:]
    rest = pool + [(c,) for c in rare] + tail
    ordered = singles + head + [rest[i] for i in rng.permutation(len(rest))]
    # log-probabilities falling with frequency rank, with jitter; a few
    # hundred entries share a handful of exact values (first-max ties)
    rank = np.arange(len(ordered), dtype=np.float64)
    score = -(2.0 + np.log1p(rank)) + rng.normal(0.0, 0.3, len(ordered))
    tie = rng.choice(len(ordered), 400, replace=False)
    score[tie] = -np.round(-score[tie] * 2) / 2
    score = np.minimum(score, -1.0).astype(np.float32)
    by_score = np.argsort(-score, kind="stable")
    return [VocabEntry(ordered[i], XLNET_RESERVED + k, float(score[i]))
            for k, i in enumerate(by_score)]


def xlnet_shaped_model_bytes(n: int = XLNET_VOCAB, seed: int = 0,
                             n_cjk: int = 420) -> bytes:
    """Compiled .bin image of an xlnet-shaped unigram-LM model.

    Laid out as xlnet is: char mode, ``TokAlgo.DEFAULT`` (unigram), id
    offset 0, ids 0-2 reserved (unknown = 0), entries from id 3 in
    descending score order.  Its ``n`` entries are ▁ alone; single
    characters covering ASCII, Latin-1, the scripts of the edge cases and
    ``n_cjk`` seeded CJK characters (the alphabet runs to about a thousand
    symbols; emoji stay out, so unknown runs occur); numbers of 2-3 digits
    and ▁ + 1-3 digits; punctuation pairs; and pieces of 2-15 symbols cut
    from the word list (▁ + each prefix of a word, the word's endings),
    with ▁ only in first position.  Scores are float32 log-probabilities
    falling with frequency rank, with seeded jitter, 400 of them rounded to
    a few shared values.  The charmap is :func:`xlnet_charmap`.  At the
    default size the model takes the dense table mode, as xlnet does."""
    spec = DictModelSpec(
        entries=xlnet_shaped_entries(n, seed, n_cjk),
        tok_algo=TokAlgo.DEFAULT,
        id_offset=0,
        use_byte_encoding=False,
        charmap=xlnet_charmap(),
    )
    return compile_dict_model(spec)


SPM_BPE_PAIRS = 300  # ▁w1▁w2 pieces of frequent word pairs


def spm_bpe_shaped_entries(n: int = XLNET_VOCAB, seed: int = 0,
                           n_cjk: int = 3000, n_pairs: int = SPM_BPE_PAIRS
                           ) -> list[VocabEntry]:
    """``n`` BPE-with-merges entries, ids from 3 with score -k for the k-th
    (see :func:`spm_bpe_shaped_model_bytes`)."""
    rng = np.random.default_rng(seed + 2)
    alphabet = _xlnet_alphabet(rng, n_cjk)
    singles = [(SPM,)] + [(c,) for c in alphabet]
    assert n > len(singles) + n_pairs + 200, "vocabulary too small for its alphabet"
    # numbers and punctuation pairs, as in the unigram model
    pool = ([tuple(str(v).encode()) for v in range(10, 1000)]
            + [(SPM,) + tuple(str(v).encode()) for v in range(1000)]
            + [(a, b) for a in _PUNCT for b in _PUNCT])
    k = min(len(pool), (n - len(singles) - n_pairs) // 4)
    pool = [pool[i] for i in np.sort(rng.permutation(len(pool))[:k])]
    # pairs of the corpus's frequent words, as split_by_whitespace=false
    # training learns them; at most 16 symbols, so the walk stays 16 deep.
    # A first word is one of the 32 most frequent, a second of ranks 16-79:
    # two pieces chain (w1 w2, w2 w3) only through ranks 16-31, which keeps
    # the documents where JAX's fast-forward flags an anomaly rare
    top = [tuple(w) for w in word_list(seed, CORPUS_WORDS)[:80]]
    pairs: dict[tuple[int, ...], None] = {}
    while len(pairs) < n_pairs:
        a, b = top[int(rng.integers(0, 32))], top[int(rng.integers(16, 80))]
        if a != b and len(a) + len(b) <= 14:
            pairs.setdefault((SPM,) + a + (SPM,) + b, None)
    pieces: dict[tuple[int, ...], None] = dict.fromkeys(pool)
    want = n - len(singles) - n_pairs
    for w in word_list(seed, max(want // 3, 64)):
        t = tuple(w)
        for j in range(1, len(t) + 1):
            pieces.setdefault((SPM,) + t[:j], None)
        for m in (2, 3, 4):
            if len(t) > m:
                pieces.setdefault(t[-m:], None)
        if len(pieces) >= want:
            break
    assert len(pieces) >= want, "word list too short"
    # merge order: shorter pieces first, each length in frequency order,
    # and the cross-word pairs after every piece of one word.  A pair that
    # outranked a longer piece of its second word could be claimed across
    # the start where that piece fast-forwarded, and leave a symbol no arc
    # covers; the reference's emission walk then never ends
    # (oracle.py::_bpe_resolve), and the native runtime's neither
    multi = sorted(list(pieces)[:want], key=len) + sorted(pairs, key=len)
    return [VocabEntry(ch, XLNET_RESERVED + k, -float(k))
            for k, ch in enumerate(multi + singles)]


def spm_bpe_shaped_model_bytes(n: int = XLNET_VOCAB, seed: int = 0,
                               n_cjk: int = 3000,
                               n_pairs: int = SPM_BPE_PAIRS) -> bytes:
    """Compiled .bin image of a SentencePiece-BPE-shaped merges model.

    Laid out as a SentencePiece BPE export is: char mode,
    ``TokAlgo.BPE_OPT_WITH_MERGES``, id offset 0, ids 0-2 reserved (unknown
    = 0), then the pieces from id 3: multi-symbol pieces first in merge
    order (shorter first, the pairs of words last), the single characters
    last, each with score -k
    for the k-th (the first -0.0, so the largest rank is not below 0 and
    the model runs in rank mode).  The pieces are the xlnet-shaped
    alphabet's characters and ▁, numbers and punctuation pairs, ▁ + each
    prefix of a frequent word and the word's endings, and ``n_pairs`` pieces
    ▁w1▁w2 of frequent word pairs: those have an internal ▁, so the model
    is not chunk-safe and takes the classic doc-row path.  The charmap is
    :func:`xlnet_charmap`.  With ``n_cjk=3000`` its vocabulary trie is over
    the trie budget and the walk takes the comb table; with ``n_cjk=420`` it
    takes the trie."""
    spec = DictModelSpec(
        entries=spm_bpe_shaped_entries(n, seed, n_cjk, n_pairs),
        tok_algo=TokAlgo.BPE_OPT_WITH_MERGES,
        id_offset=0,
        use_byte_encoding=False,
        charmap=xlnet_charmap(),
    )
    return compile_dict_model(spec)


def rank_fault_model_bytes() -> bytes:
    """Five merges entries on which the JAX package's rank key differs from
    the reference (ROADMAP.md section C item 5): ▁ -0.0 (id 3), a -2, b -3,
    aq -4, ▁a -5; q is in the alphabet but never a piece alone, so a run of
    q's is unknown, and its arc's rank +0.0 must sort first.  The reference
    gives ``"aqq b"`` -> [7, 0, 3, 5]."""
    S, a, b, q = SPM, 0x61, 0x62, 0x71
    vocab = [((S,), -0.0), ((a,), -2.0), ((b,), -3.0), ((a, q), -4.0),
             ((S, a), -5.0)]
    return compile_dict_model(DictModelSpec(
        entries=[VocabEntry(ch, 3 + i, sc) for i, (ch, sc) in enumerate(vocab)],
        tok_algo=TokAlgo.BPE_OPT_WITH_MERGES, id_offset=0,
        use_byte_encoding=False))


RESOLVE_RANKS = np.array([-0.0, 0.0, -1.5, -2.0, -3.25, -7.0, -40.0],
                         np.float32)  # few values: rank ties are frequent


def _resolve_case(name, arcs, lengths, N, LR, a_max, spm_iw, rng,
                  mixed: bool = False):
    """One launch of K2 inputs from ``arcs``, a list per row of (d, p)
    slots holding a match: seeded ids and ranks from RESOLVE_RANKS; with
    ``mixed``, the whole-token bit (27) on a third of the matches, ▁ at a
    sixth of the valid positions and slot_overflow on 1% (the fast-forward,
    its anomaly and the overflow flag)."""
    B = len(arcs)
    m_pack = np.full((LR, B, N), -1, np.int32)
    for b, slots in enumerate(arcs):
        d, p = (np.asarray(v, np.int64) for v in zip(*slots)) if slots \
            else (np.zeros(0, np.int64),) * 2
        ids = rng.integers(0, 1 << 20, len(d)).astype(np.int32)
        whole = mixed & (rng.random(len(d)) < 1 / 3)
        m_pack[d, b, p] = ids | (whole.astype(np.int32) << 27)
    m_rank = np.where(m_pack >= 0, rng.choice(RESOLVE_RANKS, m_pack.shape),
                      0).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    valid = np.arange(N)[None, :] < lengths[:, None]
    x = rng.integers(0, 50, (B, N)).astype(np.int32)
    if mixed:
        x[(rng.random((B, N)) < 1 / 6)] = spm_iw
    x[~valid] = -1
    so = valid & mixed & (rng.random((B, N)) < 0.01)
    return dict(name=name, m_pack=m_pack, m_rank=m_rank, slot_overflow=so,
                x=x, lengths=lengths, a_max=a_max)


def resolve_edge_rows(spm_iw: int, n: int = 1024, seed: int = 0) -> list[dict]:
    """Seeded K2 (bpe_resolve) launches at its limits, as NumPy arrays:
    m_pack (LR, B, N), m_rank, slot_overflow, x, lengths and a_max each.
    At the default ``n`` = 1,024 (K2's widest row) the a_max values are
    K2's 4,096 and below; a smaller ``n`` scales them by n / 1,024.

    * ``one_segment``: a row of N = n whose 4n arcs (every start to depth
      3, six to depth 4) cross every position, so the claim is one segment
      at a_max = 4n; beside it a row of length 0.68n whose last 50 valid
      positions hold no match (an unknown run at its end).
    * ``truncation``: a row whose arcs join blocks of 4 positions (2.5n) and
      then cross every position at depth 4 (n - 4 more): past a_max =
      2.93n it is flagged, and the cut keeps the crossing arcs of the first
      starts only, so the row's one segment splits.
    * ``random``: rows of widths n, 200 (at most n) and 37 with matches at a
      seeded share of the slots (lengths below N, one 0), gaps that make
      unknown runs, the fast-forward and slot_overflow, at a_max 4n and at
      a_max 48 (most rows flagged)."""
    rng = np.random.default_rng(seed)
    N = n
    full = [(d, p) for d in range(4) for p in range(N - d)] + \
        [(4, p) for p in range(6)]
    ln_short = N * 700 // 1024
    short = [(d, p) for d in range(4) for p in range(ln_short - 50 - d)]
    cases = [_resolve_case("one_segment", [full, short], [N, ln_short], N, 5,
                           4 * N, spm_iw, rng)]
    blocks = [(d, p) for d in range(4) for p in range(N) if p % 4 + d < 4]
    cross = [(4, p) for p in range(N - 4)]
    cases.append(_resolve_case("truncation", [blocks + cross, blocks],
                               [N, N], N, 5, N * 3000 // 1024, spm_iw, rng))
    for w, a_max in ((N, 4 * N), (min(200, N), 4 * N), (37, 48), (N, 48)):
        LR = 8
        lengths = rng.integers(1, w + 1, 6)
        lengths[0], lengths[1] = w, 0
        arcs = []
        for ln in lengths:
            share = rng.choice([0.1, 0.35, 0.7])
            gap = rng.random(w) < 0.08  # starts with no match: unknown runs
            arcs.append([(d, p) for d in range(LR) for p in range(ln - d)
                         if not gap[p] and rng.random() < share])
        cases.append(_resolve_case(f"random_{w}_{a_max}", arcs, lengths, w,
                                   LR, a_max, spm_iw, rng, mixed=True))
    return cases


def unigram_edge_rows():
    """(model image, x_iw int32 (R, 12), lengths int32 (R,)) of hand-made
    rows for the unigram kernels, on a tiny unigram model of max_len 3:
    ▁, a, b, c and a few pieces, with q and u only inside "qu" (no arc ends
    at a q) and ▁+a tying ▁a exactly.  The rows hold unknown symbols (-1)
    and merged unknown runs, an empty row, a length past the row, ends
    where every candidate is -FLT_MAX, and seeded symbols past the length,
    which the walk still reads."""
    S, a, b, c, q, u = SPM, 0x61, 0x62, 0x63, 0x71, 0x75
    vocab = [((S,), -2.0), ((a,), -2.0), ((b,), -3.0), ((c,), -3.0),
             ((S, a), -4.0), ((S, a, b), -7.0), ((a, b, c), -5.5),
             ((b, c), -6.0), ((q, u), -4.5)]
    blob = compile_dict_model(DictModelSpec(entries=[
        VocabEntry(ch, 3 + i, s) for i, (ch, s) in enumerate(vocab)]))
    alphabet = sorted({v for ch, _s in vocab for v in ch})
    S, a, b, c, q, u = (alphabet.index(v) for v in (S, a, b, c, q, u))
    W = 12
    rows = [
        ([S, a, b, c], 4),
        ([S, -1, -1, a, -1, b, -1, -1, -1, c], 10),
        ([], 0),
        ([S, q, u], 3),
        ([q, u, b], 1),  # q alone; the walk reads u past the length
        ([S, q, b, c], 4),  # b's base is -FLT_MAX
        ([-1] * W, W),
        ([a, b, c] * (W // 3), W),
        ([S, a, b], W + 5),  # a length past the row: nothing is emitted
        ([S, a] + [q] * (W - 2), W),
    ]
    rng = np.random.default_rng(9)
    x = rng.integers(-1, len(alphabet), (len(rows), W)).astype(np.int32)
    lengths = np.zeros(len(rows), np.int32)
    for i, (r, n) in enumerate(rows):
        x[i, : len(r)] = r
        lengths[i] = n
    return blob, x, lengths


# walk depths of unigram_deep_rows: one, and each side of K5's 32-depth
# chunks (kernels/csrc/unigram_walk.cu)
DEEP_DEPTHS = (1, 31, 32, 33, 64)
DEEP_MAX_LEN = 70


def unigram_deep_rows(width: int = 130, seed: int = 0):
    """(model image, x_iw int32 (R, width), lengths int32 (R,)) for K5's
    depth chunks: a tiny seeded unigram model whose pieces run to
    DEEP_MAX_LEN symbols ((ab)^k for every k up to 35, runs of c of 31 to
    70, seeded pieces of 2 to 40 symbols over a, b, c, d) and rows that
    walk them to their ends: (ab)^k and c runs across the 32-depth chunks,
    seeded mixtures, unknown symbols (-1), an empty row, a length past the
    row and seeded symbols past the length, which the walk still reads.
    The default width is not a multiple of a tile of 128 starts, nor, at
    odd depths, of a 16-byte store."""
    rng = np.random.default_rng(seed + 13)
    S, a, b, c, d = SPM, 0x61, 0x62, 0x63, 0x64
    pieces = {(v,) for v in (S, a, b, c, d)}
    pieces |= {(a, b) * k for k in range(1, 36)}
    pieces |= {(S,) + (a, b) * k for k in (1, 15, 16, 17, 32)}
    pieces |= {(c,) * n for n in (2, 31, 32, 33, 63, 64, 65, DEEP_MAX_LEN)}
    for n in rng.integers(2, 41, 60):
        pieces.add(tuple(int(v) for v in rng.choice([a, b, c, d], n)))
    pieces = sorted(pieces)
    score = -(1.0 + rng.random(len(pieces)) * 3.0) * np.array(
        [len(p) for p in pieces])
    score = np.round(score * 4) / 4  # a few exact ties
    blob = compile_dict_model(DictModelSpec(entries=[
        VocabEntry(p, 3 + i, float(s)) for i, (p, s) in
        enumerate(zip(pieces, score))]))
    alphabet = sorted({v for p in pieces for v in p})
    S, a, b, c, d = (alphabet.index(v) for v in (S, a, b, c, d))
    W = width
    mix = [int(v) for v in rng.choice([a, b, c, d], W)]
    pats = [
        ([S] + [a, b] * 40, W),
        ([c] * 100 + [a, b] * 20, W),
        ([a, b] * 16 + [c] * 33 + [a, b] * 33, W - 3),
        (mix, W),
        ([c] * 64 + [-1] + [c] * 70, W),
        ([], 0),
        ([S, a, b] * 5, W + 5),  # past the row: nothing is emitted
        ([d, -1, c, c] * 10, 17),
        ([-1] * W, W),
    ]
    x = rng.integers(-1, len(alphabet), (len(pats), W)).astype(np.int32)
    lengths = np.zeros(len(pats), np.int32)
    for i, (r, n) in enumerate(pats):
        r = r[:W]
        x[i, : len(r)] = r
        lengths[i] = n
    return blob, x, lengths


# (row width N, walk cap lw) of unigram_lane_edge_rows: every N at least
# once, and L = min(lw, LANE_MAX_LEN) in {1, 3, 8, 9, 15, 16, 17, 33, 40}
# (the depths past 32 at the narrowest width past a tile: JAX's compile
# time grows with both)
LANE_MAX_LEN = 40
LANE_EDGE_CASES = ((1, 1), (1, None), (31, 3), (31, 33), (31, None), (65, 9),
                   (65, 15), (65, 17), (200, 8), (200, 16))


def unigram_lane_edge_rows():
    """(model image, {N: (x_iw int32 (R, N), lengths int32 (R,))}) of
    hand-made rows for K6's lane groups, at the widths of LANE_EDGE_CASES
    (none a multiple of K6's 16- or 32-position arc tiles but 1), on a tiny
    unigram model whose longest piece, (ab)^20, has LANE_MAX_LEN = 40
    symbols, past a warp.  Integer scores make exact ties between depths:
    a, b, c, ab, abc, (abc)^3, (ab)^8 a and (ab)^20 tie their splits into
    single symbols, c^33 ties 33 c's; bc loses to b + c, ca beats c + a.
    q and u occur only inside qu, so a q with no u after it is unknown and
    one before a u ends where every candidate is -FLT_MAX.  The rows hold
    lengths 0, below N, N and past N, unknown runs (-1) across the tile
    boundaries at 16 and 32, and seeded symbols past the length, which the
    walk still reads."""
    S, a, b, c, q, u = SPM, 0x61, 0x62, 0x63, 0x71, 0x75
    ab, abc = (a, b), (a, b, c)
    vocab = [((S,), -2.0), ((a,), -1.0), ((b,), -1.0), ((c,), -1.0),
             (ab, -2.0), (abc, -3.0), ((b, c), -2.5), ((c, a), -1.5),
             ((S, a), -3.0), (abc * 3, -9.0), (ab * 8 + (a,), -17.0),
             ((c,) * 33, -33.0), (ab * 20, -40.0), ((q, u), -4.5)]
    blob = compile_dict_model(DictModelSpec(entries=[
        VocabEntry(ch, 3 + i, s) for i, (ch, s) in enumerate(vocab)]))
    alphabet = sorted({v for ch, _s in vocab for v in ch})
    S, a, b, c, q, u = (alphabet.index(v) for v in (S, a, b, c, q, u))
    ab, abc = [a, b], [a, b, c]
    rng = np.random.default_rng(11)
    rows = {}
    for N in sorted({n for n, _lw in LANE_EDGE_CASES}):
        pats = [
            ([S] + ab * 20 + [c] * 33 + abc * 3 + [b, c, a], N),
            ([a, q, u, b] + [-1] * 14 + [c] * 8 + [-1] * 9 + [q, b], N),
            ([S, a, b] + [-1] * 10 + ab * 8 + [a, -1, -1] + [q] * 20, N - 1),
            ([c] * 40 + [q, u] + abc * 20, N // 2),
            ([], 0),
            ([S, a, b, q, u], 4),  # ends at q: every candidate -FLT_MAX
            ([S, a, q, u], N + 5),  # past the row: nothing is emitted
            ([-1] * N, N),
            ((abc * 3 + ab * 8 + [a] + [c] * 33 + [q]) * 3, N),
        ]
        x = rng.integers(-1, len(alphabet), (len(pats), N)).astype(np.int32)
        lengths = np.zeros(len(pats), np.int32)
        for i, (r, n) in enumerate(pats):
            r = r[:N]
            x[i, : len(r)] = r
            lengths[i] = n
        rows[N] = (x, lengths)
    return blob, rows


CORPUS_WORDS = 20000  # distinct frequent words
CORPUS_RARE = 50000  # rare words (3% of word draws)
WORDS_PER_DOC = 60  # mean document length in words


def zipf_corpus(target_bytes: int, seed: int = 0) -> list[bytes]:
    """Seeded Zipfian corpus of at least ``target_bytes`` bytes, starting
    with the edge cases."""
    rng = np.random.default_rng(seed + 7)
    words_per_doc, n_rare = WORDS_PER_DOC, CORPUS_RARE
    words = word_list(seed, CORPUS_WORDS)
    lex = list(words)
    w = 1.0 / np.arange(1, len(words) + 1) ** 1.05
    # punctuated variants of the frequent words
    top = min(2000, len(words))
    for p in (b",", b".", b"!", b"?", b";", b"'s"):
        lex += [x + p for x in words[:top]]
    wp = np.concatenate([w] + [w[:top] * 0.012] * 6)
    # rare words: each seldom recurs, so later batches still dispatch rows
    lex += _random_words(rng, n_rare, 3, 18)
    wr = np.full(n_rare, 0.03 * wp.sum() / n_rare)
    # numbers and long punctuation runs (some wider than a 128-symbol row)
    lex += [str(int(v)).encode() for v in rng.integers(0, 100000, 2000)]
    wn = np.full(2000, 0.01 * wp.sum() / 2000)
    runs = [bytes([LONG_CHARS[i % len(LONG_CHARS)]]) * int(n)
            for i, n in enumerate(rng.integers(17, 160, 300))]
    lex += runs
    wl = np.full(len(runs), 0.00001 * wp.sum() / len(runs))
    p = np.concatenate([wp, wr, wn, wl])
    p = p / p.sum()
    avg = float(np.dot(p, [len(x) + 1 for x in lex]))
    n_tok = int(target_bytes / avg * 1.05) + words_per_doc
    ids = rng.choice(len(lex), size=n_tok, p=p)
    docs = [e.encode("utf-8") for e in EDGE_CASES]
    total = sum(map(len, docs))
    lens = np.clip(rng.geometric(1.0 / words_per_doc, size=n_tok // 4 + 1),
                   1, 8 * words_per_doc)
    i = 0
    k = 0
    while total < target_bytes:
        if i >= len(ids):
            ids = np.concatenate([ids, rng.choice(len(lex), size=n_tok, p=p)])
        n = int(lens[k % len(lens)])
        d = b" ".join([lex[j] for j in ids[i:i + n]])
        docs.append(d)
        total += len(d)
        i += n
        k += 1
    return docs


BERT_VOCAB = 28996
BERT_UNK = 100  # ids 0..99 are [PAD] and [unused1..99]; [UNK] is 100
BERT_WHOLE_WORDS = 16000  # frequent words that are entries of their own
# three rules at level 0: whitespace runs are ignored; runs of letters and
# digits, and any other single character, are words that call the
# sub-token function FnTokWord, whose body compile_wordpiece_model makes
# from the vocabulary
BERT_GRAMMAR = r"""
< [\x20\x09\x0A\x0D\x0B\x0C\x00A0\x3000]+ > --> IGNORE
< [a-zA-Z0-9\x00C0-\x024F]+ > --> WORD _call FnTokWord
< [^\x20\x09\x0A\x0D\x0B\x0C\x00A0\x3000] > --> WORD _call FnTokWord
"""
BERT_TAGSET = {"WORD": 1, "IGNORE": 4, "FnTokWord": 5}
BERT_FN = BERT_TAGSET["FnTokWord"]


def _bert_alphabet() -> list[int]:
    """ASCII and Latin-1 letters, and the characters of the edge cases;
    whitespace, controls, × and ÷, and SMP characters (emoji, math
    letters) stay out, so some words are [UNK]."""
    import unicodedata

    chars = set(range(0x21, 0x7F)) | (set(range(0xC0, 0x100)) - {0xD7, 0xF7})
    for s in EDGE_CASES:
        chars |= {ord(ch) for ch in s}
    return sorted(c for c in chars if c < 0x10000 and c not in (0xD7, 0xF7)
                  and not unicodedata.category(chr(c)).startswith(("C", "Z")))


def bert_shaped_vocab(n: int = BERT_VOCAB, seed: int = 0) -> list[str]:
    """``n`` vocabulary lines laid out as bert-base-cased's: [PAD],
    [unused1..99], [UNK] (100), [CLS], [SEP], [MASK]; every character of
    the alphabet alone and as a ``##`` piece; numbers 10..999 and ``##``
    pairs of digits; the BERT_WHOLE_WORDS most frequent words of the
    corpus's word list whole; then prefixes of 2-4 characters and ``##``
    endings of 2-4 characters of every word, until ``n`` lines."""
    lines = (["[PAD]"] + [f"[unused{i}]" for i in range(1, BERT_UNK)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    seen = set(lines)

    def add(s: str) -> None:
        if len(lines) < n and s not in seen:
            seen.add(s)
            lines.append(s)

    alphabet = [chr(c) for c in _bert_alphabet()]
    for c in alphabet:
        add(c)
    for c in alphabet:
        add("##" + c)
    for v in range(10, 1000):
        add(str(v))
    for v in range(100):
        add(f"##{v:02d}")
    words = [w.decode() for w in word_list(seed, CORPUS_WORDS)]
    for w in words[:BERT_WHOLE_WORDS]:
        add(w)
    for w in words:
        for k in (2, 3, 4):
            if len(w) > k:
                add(w[:k])
                add("##" + w[-k:])
        if len(lines) >= n:
            break
    assert len(lines) == n, f"only {len(lines)} vocabulary lines"
    return lines


def bert_shaped_model_bytes(n: int = BERT_VOCAB, seed: int = 0) -> bytes:
    """Compiled .bin image of a bert-shaped WordPiece model: the vocabulary
    of :func:`bert_shaped_vocab` (ids = line numbers, ``[UNK]`` = 100)
    compiled into FnTokWord by the port's copy of
    compiler/wordpiece.py::compile_wordpiece_model, under the three-rule
    level-0 grammar BERT_GRAMMAR.  It stands in for bert_base_cased_tok.bin,
    which is not in the repository."""
    from .compiler.wordpiece import compile_wordpiece_model

    return compile_wordpiece_model(bert_shaped_vocab(n, seed), BERT_GRAMMAR,
                                   dict(BERT_TAGSET))


MBERT_VOCAB = 119547  # bert-base-multilingual-cased's vocab.txt
MBERT_CJK = 1500  # seeded ideographs: the dense table passes its cap
MBERT_WORDS = 60000  # word_list draws: the first MBERT_WHOLE_WORDS whole
MBERT_WHOLE_WORDS = 40000


def mbert_alphabet(seed: int = 0, n_cjk: int = MBERT_CJK) -> list[int]:
    """The xlnet-shaped alphabet (Latin, Latin-1, the script ranges and
    ``n_cjk`` seeded ideographs of U+4E00-U+9FFF) joined with the
    bert-shaped one, below U+10000."""
    rng = np.random.default_rng(seed + 3)
    return sorted(c for c in set(_xlnet_alphabet(rng, n_cjk))
                  | set(_bert_alphabet()) if c < 0x10000)


def mbert_shaped_vocab(n: int = MBERT_VOCAB, seed: int = 0,
                       n_cjk: int = MBERT_CJK) -> list[str]:
    """``n`` vocabulary lines laid out as bert-base-multilingual-cased's:
    [PAD], [unused1..99], [UNK] (100), [CLS], [SEP], [MASK]; every
    character of :func:`mbert_alphabet` alone and as a ``##`` piece;
    numbers 10..999 and ``##`` pairs of digits; the MBERT_WHOLE_WORDS most
    frequent of MBERT_WORDS words whole; then prefixes of 2-4 characters
    and ``##`` endings of 2-4 characters of every word, until ``n``
    lines."""
    lines = (["[PAD]"] + [f"[unused{i}]" for i in range(1, BERT_UNK)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    seen = set(lines)

    def add(s: str) -> None:
        if len(lines) < n and s not in seen:
            seen.add(s)
            lines.append(s)

    alphabet = [chr(c) for c in mbert_alphabet(seed, n_cjk)]
    for c in alphabet:
        add(c)
    for c in alphabet:
        add("##" + c)
    for v in range(10, 1000):
        add(str(v))
    for v in range(100):
        add(f"##{v:02d}")
    words = [w.decode() for w in word_list(seed, MBERT_WORDS)]
    for w in words[:MBERT_WHOLE_WORDS]:
        add(w)
    for w in words:
        for k in (2, 3, 4):
            if len(w) > k:
                add(w[:k])
                add("##" + w[-k:])
        if len(lines) >= n:
            break
    assert len(lines) == n, f"only {len(lines)} vocabulary lines"
    return lines


def mbert_shaped_model_bytes(n: int = MBERT_VOCAB, seed: int = 0,
                             n_cjk: int = MBERT_CJK) -> bytes:
    """Compiled .bin image of a multilingual-bert-shaped WordPiece model:
    :func:`mbert_shaped_vocab` under BERT_GRAMMAR (each ideograph a word of
    its own, as BERT's Chinese-character split makes it), compiled as
    :func:`bert_shaped_model_bytes` is.  It stands in for
    bert_multi_cased.bin, which is not in the repository.  The image is
    cached under ``build/blingfire_tpu_torch/fixtures/``, keyed by the
    arguments and the compiler's and this module's sources: the full size
    compiles in about 100 s."""
    import glob
    import os

    from .buildutil import PKG_DIR, build_dir, source_tag
    from .compiler.wordpiece import compile_wordpiece_model

    tag = source_tag(__file__, *sorted(glob.glob(
        os.path.join(PKG_DIR, "compiler", "*.py"))))
    path = os.path.join(build_dir("fixtures"),
                        f"mbert-{n}-{seed}-{n_cjk}.{tag}.bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    blob = compile_wordpiece_model(mbert_shaped_vocab(n, seed, n_cjk),
                                   BERT_GRAMMAR, dict(BERT_TAGSET))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return blob


def mbert_docs(n_bytes: int, seed: int = 7, vocab_seed: int = 0,
               n_cjk: int = MBERT_CJK) -> list[bytes]:
    """Multilingual documents for the mbert-shaped model, UTF-8, until
    ``n_bytes``: each of 3-19 parts, a run of 1-11 of the model's own
    ideographs (half the parts; each ideograph is a word under
    BERT_GRAMMAR), a word of its word list, a Cyrillic word ended by
    '.' and a Greek letter, or an ideograph outside its alphabet ([UNK])
    and an ideographic comma."""
    rng = np.random.default_rng(seed)
    cjk = np.array([c for c in mbert_alphabet(vocab_seed, n_cjk)
                    if 0x4E00 <= c < 0xA000])
    outside = np.setdiff1d(np.arange(0x4E00, 0xA000), cjk)
    words = [w.decode() for w in word_list(vocab_seed, 3000)]
    docs, total = [], 0
    while total < n_bytes:
        parts = []
        for _ in range(int(rng.integers(3, 20))):
            k = int(rng.integers(0, 6))
            if k <= 2:
                parts.append("".join(chr(int(c)) for c in rng.choice(
                    cjk, int(rng.integers(1, 12)))))
            elif k == 3:
                parts.append(words[int(rng.integers(len(words)))])
            elif k == 4:
                parts.append("".join(chr(int(c)) for c in rng.integers(
                    0x410, 0x450, int(rng.integers(1, 8)))) + "."
                             + chr(int(rng.integers(0x3B1, 0x3CA))))
            else:
                parts.append(chr(int(rng.choice(outside))) + "\u3001")
        docs.append(" ".join(parts).encode("utf-8"))
        total += len(docs[-1])
    return docs


def wp_edge_rows(l_iw: int, r_iw: int, map_raw, width: int = 128,
                 n_random: int = 5, seed: int = 0):
    """(x int32 (R, width), fn int32 (R, width)) of hand-made packed rows
    for the WordPiece sub-token kernels.  ``x`` holds dense input weights
    (``map_raw`` maps code points to them; an unmapped one becomes the
    alphabet size), ``fn`` each lane's sub-function id (BERT_FN on a unit's
    lanes, -1 elsewhere); the caller maps ``fn`` to initial states.  Rows:
    units of length 0 ([L R]); all -1; four 30-symbol units, the last
    ending at column width-1; an uncovered unit (an emoji, a ×) beside
    covered ones; a 40-symbol unit; symbols without anchors; a unit whose
    lanes have no initial state; seeded random rows of symbols, anchors,
    padding and functions."""

    def unit(word: str) -> list[int]:
        return [l_iw] + [int(v) for v in map_raw(
            np.array([ord(ch) for ch in word], np.int32))] + [r_iw]

    def row(units, fns=None) -> tuple[np.ndarray, np.ndarray]:
        x = np.full(width, -1, np.int32)
        f = np.full(width, -1, np.int32)
        o = 0
        for i, u in enumerate(units):
            x[o : o + len(u)] = u
            f[o : o + len(u)] = BERT_FN if fns is None else fns[i]
            o += len(u)
        assert o <= width
        return x, f

    rows = [
        row([[l_iw, r_iw]] * (width // 2)),
        (np.full(width, -1, np.int32), np.full(width, -1, np.int32)),
        row([unit("abcdefghijklmnopqrstuvwxyzabcd")] * (width // 32)),
        row([unit("the"), unit("ab\U0001F642cd"), unit("a\u00d7b"),
             unit("naïve")]),
        row([unit("supercalifragilisticexpialidociousaaaaaa")]),
        row([unit("hello")[1:-1], unit("world")]),
        row([unit("hello"), unit("world")], fns=[-1, BERT_FN]),
    ]
    rng = np.random.default_rng(seed)
    n_iws = int(map_raw(np.array([0x10FFFF], np.int32))[0])
    for _ in range(n_random):
        x = rng.integers(-1, n_iws + 1, width).astype(np.int32)
        anchors = rng.random(width)
        x[anchors < 0.08] = l_iw
        x[anchors > 0.92] = r_iw
        f = np.where(rng.random(width) < 0.9, BERT_FN, -1).astype(np.int32)
        rows.append((x, f))
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def slot0_probes(comb) -> tuple[int, list[int]]:
    """(s, probes): the state that owns slot 0 of a comb table and the
    symbols c >= 0 with ``base[s] + c < 0``.  Clamping such a slot into the
    array, as the JAX package does, lands on slot 0, which s owns: a false
    transition (ROADMAP.md section C).  No probes when ``base[s] >= 0``."""
    s = int(np.asarray(comb.owner)[0])
    return s, list(range(max(-int(np.asarray(comb.base)[s]), 0)))


def comb_path(comb, start: int, targets) -> list[int] | None:
    """The shortest path of dense input weights from state ``start`` to a
    state of ``targets`` (one state or several) over a comb table's real
    transitions (breadth first), or None when none is in reach."""
    goal = {int(targets)} if np.isscalar(targets) else {int(t) for t in targets}
    owner = np.asarray(comb.owner)
    base = np.asarray(comb.base)
    nxt = np.asarray(comb.nxt)
    occ = np.flatnonzero(owner >= 0)
    src, dst = owner[occ], nxt[occ]
    iw = occ - base[src]
    order = np.argsort(src, kind="stable")
    src, dst, iw = src[order], dst[order], iw[order]
    row = np.searchsorted(src, np.arange(len(base) + 1))
    back = {start: None}
    todo = [start]
    found = start if start in goal else None
    while todo and found is None:
        nxt_todo = []
        for s in todo:
            for k in range(row[s], row[s + 1]):
                d = int(dst[k])
                if d >= 0 and d not in back:
                    back[d] = (s, int(iw[k]))
                    nxt_todo.append(d)
                    if d in goal and found is None:
                        found = d
        todo = nxt_todo
    if found is None:
        return None
    path, s = [], found
    while back[s] is not None:
        s, c = back[s]
        path.append(c)
    return path[::-1]


def slot0_walks(comb, start: int) -> tuple[list[list[int]], int]:
    """(rows, at): symbol rows that walk from state ``start`` to the state
    that owns slot 0, read one probe of :func:`slot0_probes` at index
    ``at``, then follow the path from slot 0's destination (where a
    clamping lookup lands) to the nearest final state; one row a probe.  A
    clamping walk reaches that final, a guarded one dies at the probe.  No
    rows when the state is out of reach or has no probe."""
    s, probes = slot0_probes(comb)
    head = comb_path(comb, start, s)
    tail = comb_path(comb, int(np.asarray(comb.nxt)[0]),
                     np.flatnonzero(np.asarray(comb.final)))
    if head is None or tail is None:
        return [], 0
    return [head + [c] + tail for c in probes], len(head)


def unigram_slot0_model_bytes() -> bytes:
    """A tiny unigram model whose comb table false-hits under a clamp: its
    lowest symbol ``a`` never starts a piece, so the root (the state of
    highest degree, placed first) has no transition on dense symbol 0 and a
    base of -1 (:func:`slot0_probes`)."""
    a, b, c, d = 0x61, 0x62, 0x63, 0x64
    vocab = [((b,), -2.0), ((c,), -2.5), ((d,), -3.0), ((b, a), -4.0),
             ((c, a), -4.5), ((d, a, b), -6.0)]
    return compile_dict_model(DictModelSpec(entries=[
        VocabEntry(ch, 3 + i, s) for i, (ch, s) in enumerate(vocab)]))


def lexer_edge_rows(lex, width: int = 64):
    """(x int32 (R, width + 2), init int32 (R,), ext_len int32 (R,), raws)
    of hand-made rows for the pattern lexer's pass, from a
    runtime/lexer_host.py::LexerTpu ``lex``: an empty span (its only start
    is the L anchor), one character, a row of padding with no anchors, an L
    anchor with padding where the R anchor should be, unmapped characters,
    the end of document 107 of tests/corpus.py (``."`` then U+1F642), a
    row filled to its last lane, a length past the row, rows walked from
    each function's initial state, and seeded random rows.  ``raws`` holds
    each row's code points (None where the row is no span of text)."""
    M = width + 2
    texts = [("", None), ("a", None), (None, "pad"), (None, "lonely-L"),
             ("x\U0001F642y☃", None), ('y."\U0001F642\U0001D518', None),
             (("The end. " * 20)[:width], None), ("ab. cd", "long")]
    inis = [int(v) for v in dict.fromkeys(lex.engine.fn2ini) if v is not None
            and v >= 0]
    texts += [("Mr. Smith's 3.14 e-mail: a@b.com!", ini) for ini in inis]
    rng = np.random.default_rng(3)
    pool = np.array([ord(ch) for ch in "ab .,!?'\"-1\n\t"] + [0x1F642, 0x3000,
                                                              0xE9])
    texts += [("".join(map(chr, rng.choice(pool, rng.integers(1, width)))),
               None) for _ in range(6)]
    xs, inits, lens, raws = [], [], [], []
    for text, how in texts:
        x = np.full(M, -1, np.int32)
        ini = how if isinstance(how, int) else int(lex.engine.initial)
        if text is None:
            if how == "lonely-L":
                x[0] = lex._lanchor
            xs.append(x), inits.append(ini), lens.append(2), raws.append(None)
            continue
        cps = np.array([ord(ch) for ch in text], np.int32)
        n = len(cps)
        x[0] = lex._lanchor
        x[1 : n + 1] = lex.encode_chars(cps)
        x[n + 1] = lex._ranchor
        xs.append(x)
        inits.append(ini)
        lens.append(M + 3 if how == "long" else n + 2)
        raws.append(None if how == "long" else cps)
    return (np.stack(xs), np.array(inits, np.int32),
            np.array(lens, np.int32), raws)


def lexer_dead_end_state(lex) -> int:
    """The lowest state of ``lex``'s comb table that owns no slot: a walk
    from it dies at its first symbol, IW_ANY included."""
    owner = np.asarray(lex.comb.owner)
    has = np.zeros(lex.comb.n_states, bool)
    has[owner[owner >= 0]] = True
    return int(np.flatnonzero(~has)[0])


def lexer_wide_rows(lex, width: int, docs, n_rows: int = 4):
    """(x int32 (R, width + 2), init int32 (R,), ext_len int32 (R,), raws)
    of rows at the widest buckets for the pattern lexer's pass, from a
    runtime/lexer_host.py::LexerTpu ``lex``: ``n_rows`` spans of ``width``
    characters cut from the text of ``docs`` (bytes, NUL read as a space)
    from the initial state; the first span again from
    :func:`lexer_dead_end_state`, a row with no match at all, whose FromPos
    chain visits every start; and a span one character short (its R anchor
    on the last lane but one, padding after it)."""
    cps = np.concatenate([np.frombuffer(d.decode("utf-8", "replace")
                                        .encode("utf-32-le"), np.uint32)
                          for d in docs]).astype(np.int32)
    cps = np.where(cps == 0, 0x20, cps)
    if len(cps) < n_rows * width:
        raise ValueError(f"{len(cps)} characters, want {n_rows * width}")
    M = width + 2
    spans = [(cps[i * width : (i + 1) * width], int(lex.engine.initial))
             for i in range(n_rows)]
    spans += [(spans[0][0], lexer_dead_end_state(lex)),
              (spans[1][0][: width - 1], int(lex.engine.initial))]
    x = np.full((len(spans), M), -1, np.int32)
    for r, (span, _ini) in enumerate(spans):
        n = len(span)
        x[r, 0] = lex._lanchor
        x[r, 1 : n + 1] = lex.encode_chars(span)
        x[r, n + 1] = lex._ranchor
    return (x, np.array([ini for _s, ini in spans], np.int32),
            np.array([len(s) + 2 for s, _i in spans], np.int32),
            [s for s, _i in spans])


SYLLAB_PATTERNS = 78000  # puts the image within 10% of syllab.bin's 1.18 MB
SYLLAB_ANCHOR = 94  # '^': syllab.bin's left and right anchor
HYPH_OPS = (0, 1, 7)  # NO_HYPH, SIMPLE_HYPH, DONT_CARE
# Cyrillic lowercase by frequency (о е а и н т ...), and ß with the
# lowercase Latin-1 letters
_CYRILLIC = [0x43E, 0x435, 0x430, 0x438, 0x43D, 0x442, 0x441, 0x440, 0x432,
             0x43B, 0x43A, 0x43C, 0x434, 0x43F, 0x443, 0x44F, 0x44B, 0x44C,
             0x433, 0x437, 0x431, 0x447, 0x439, 0x445, 0x436, 0x448, 0x44E,
             0x446, 0x449, 0x44D, 0x444, 0x44A, 0x451]
_LATIN1 = [0xDF] + [c for c in range(0xE0, 0xFF) if c != 0xF7]


def syllab_charmap() -> dict[int, list[int]]:
    """Uppercase Latin, Latin-1 and Cyrillic folded 1:1 to lowercase."""
    pairs = [(c, c + 0x20) for c in range(0x41, 0x5B)]
    pairs += [(c, c + 0x20) for c in range(0xC0, 0xDF) if c != 0xD7]
    pairs += [(c, c + 0x20) for c in range(0x410, 0x430)] + [(0x401, 0x451)]
    return {c: [lo] for c, lo in pairs}


def _zipf_p(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def syllab_shaped_patterns(n: int, seed: int = 0
                           ) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """``n`` unique W2H patterns (key, ops) laid out as syllab.bin's: keys
    of 2-8 symbols, 75% Latin (8% of their letters Latin-1) and 25%
    Cyrillic, letters drawn Zipfian by frequency rank, an apostrophe inside
    2% of positions but never first, 15% anchored by ``^`` at one end. Ops
    are one a symbol: DONT_CARE on an anchor, else NO_HYPH, SIMPLE_HYPH or
    DONT_CARE, and 1% coded ``(sym << 4) | 2..6``; no key is all
    DONT_CARE."""
    rng = np.random.default_rng(seed + 11)
    latin = [int(c) for c in _LETTERS[np.argsort(-_LETTER_P, kind="stable")]]
    alpha = {name: (letters, np.cumsum(_zipf_p(len(letters))))
             for name, letters in (("lat", latin), ("lat1", _LATIN1),
                                   ("cyr", _CYRILLIC))}
    lens = np.arange(2, 9)
    len_p = np.array([0.08, 0.2, 0.25, 0.2, 0.14, 0.08, 0.05])
    pats: dict[tuple[int, ...], tuple[int, ...]] = {}
    while len(pats) < n:
        k = n - len(pats)
        L = rng.choice(lens, k, p=len_p)
        side = rng.random(k)
        cyr = rng.random(k) < 0.25
        for i in range(k):
            left, right = side[i] < 0.08, 0.08 <= side[i] < 0.15
            body = int(L[i]) - (left or right)
            r = rng.random((body, 3))
            syms = []
            for j in range(body):
                if j > 0 and r[j, 0] < 0.02:
                    syms.append(0x27)
                    continue
                name = "cyr" if cyr[i] else ("lat1" if r[j, 1] < 0.08 else "lat")
                letters, cdf = alpha[name]
                syms.append(letters[min(int(np.searchsorted(cdf, r[j, 2])),
                                        len(letters) - 1)])
            u = rng.random(body)
            ops = [0 if v < 0.5 else 1 if v < 0.75 else 7 if v < 0.99
                   else (int(rng.choice(latin)) << 4) | int(rng.integers(2, 7))
                   for v in u]
            if all(o == 7 for o in ops):
                ops[int(rng.integers(0, body))] = int(rng.integers(0, 2))
            key = tuple(syms)
            if left:
                key, ops = (SYLLAB_ANCHOR,) + key, [7] + ops
            elif right:
                key, ops = key + (SYLLAB_ANCHOR,), ops + [7]
            pats.setdefault(key, tuple(ops))
    return list(pats.items())


def syllab_shaped_model_bytes(n_patterns: int = SYLLAB_PATTERNS,
                              seed: int = 0, ignore_case: bool = False,
                              no_hyph_len: int | None = None) -> bytes:
    """Compiled ``[w2h]`` image of a syllab-shaped hyphenation model: the
    patterns of :func:`syllab_shaped_patterns` built by the port's copy of
    compiler/hyphpats.py::build_w2h_ldb with syllab.bin's settings (min-len
    2, both anchors ``^``) and :func:`syllab_charmap`.  It stands in for
    syllab.bin, which is not in the repository.  The root has no apostrophe
    transition and the apostrophe is the lowest dense symbol, so the root
    owns slot 0 of the comb table with base -1 (:func:`slot0_probes`)."""
    from .compiler.hyphpats import build_w2h_ldb

    return build_w2h_ldb(syllab_shaped_patterns(n_patterns, seed), min_len=2,
                         l_anchor=SYLLAB_ANCHOR, r_anchor=SYLLAB_ANCHOR,
                         charmap=syllab_charmap(), ignore_case=ignore_case,
                         no_hyph_len=no_hyph_len)


def hyph_slot0_model_bytes() -> bytes:
    """Five patterns whose comb table false-hits under a clamp: the
    apostrophe is dense symbol 0 and ``^`` symbol 1; the root has no
    apostrophe transition, so it owns slot 0 with base -1, and a clamped
    lookup of the apostrophe there takes the root's ``^`` transition."""
    from .compiler.hyphpats import build_w2h_ldb

    a, b, c, d, q, h = 0x61, 0x62, 0x63, 0x64, 0x27, SYLLAB_ANCHOR
    pats = [((h, a, b), (7, 1, 7)), ((b, q, c), (0, 1, 0)),
            ((a, c, d), (0, 1, 0)), ((c, a), (1, 0)), ((d, a), (1, 0))]
    return build_w2h_ldb(pats, min_len=2, l_anchor=h, r_anchor=h)


def hyph_edge_words() -> list[list[int]]:
    """Code point lists for hyphenation edge cases: the empty word, one
    character, lengths 28, 29, 32, 33, 300 and 301 (one past
    MAX_WORD_SIZE), unmapped characters (emoji, CJK, NUL, a space),
    uppercase and Cyrillic words the charmap folds, apostrophes (first,
    inside, last), and short words where a pattern's ops run past the
    word's end."""
    def cps(s: str) -> list[int]:
        return [ord(ch) for ch in s]

    stem = "hyphenationalgorithmictokenizerwords"
    words = [[], cps("a"), cps("ab"), cps("e'"), cps("'t")]
    words += [cps((stem * 10)[:n]) for n in (28, 29, 32, 33, 300, 301)]
    words += [cps(s) for s in (
        "ab\U0001F642cd", "你好", "\x00embedded", "two words",
        "HYPHENATION", "Straße", "ПРИВЕТ",
        "неделя", "don't", "'abab", "cab'ab",
        "'ab", "rock'n'roll", "naïve", "été", "ta", "st",
        "abc", "\U0001F642")]
    return words


def corpus_words(docs: list[bytes]) -> list[list[int]]:
    """The hyphenation traffic of a corpus: every whitespace-separated
    token, stripped of ``.,!?"'`` at its ends (bench.py's rule), as a code
    point list; tokens that strip to nothing are dropped."""
    out: list[list[int]] = []
    for d in docs:
        for w in d.decode("utf-8", "replace").split():
            w = w.strip(".,!?\"'")
            if w:
                out.append([ord(ch) for ch in w])
    return out


def shipped_lexer_bytes(name: str) -> bytes:
    """The image of a shipped pattern-lexer model of the package's
    models_data: ``"wbd"`` (TextToWords) or ``"sbd"`` (TextToSentences)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models_data", f"{name}.bin")
    with open(path, "rb") as f:
        return f.read()


def wide_window_docs() -> list[bytes]:
    """A few dozen documents for a window of 2,048 symbols: the edge cases
    and Zipfian documents, five of 1,100 to 1,900 bytes, one past 2,048
    bytes, and two long ones holding a unit past 64 symbols (which the unit
    path sends to the classic rows)."""
    zipf = zipf_corpus(300_000)
    mid = [d for d in zipf if 1100 < len(d) < 1900][:5]
    run = b" " + LONG_CHARS[:1] * 90 + b" "
    return (zipf[:24] + mid + [b" ".join(mid)[:2600]]
            + [mid[0][:500] + run + mid[1], mid[2][:300] + run])


# the data-parallel tests' models (test size): kind -> model image
DP_MODELS = {
    "gpt2": lambda: gpt2_shaped_model_bytes(2000, n_long=40),
    "xlnet": lambda: xlnet_shaped_model_bytes(4000, n_cjk=100),
    "bert": lambda: bert_shaped_model_bytes(2000),
}
DP_DOC = 128  # the SpTokenizer window of the data-parallel tests


def wp_slabs(wp, docs: list[bytes]) -> list[tuple]:
    """(bx, bi, lw) of each non-empty length class of ``wp``'s packed rows
    of ``docs`` (WordPieceHybrid._analyze and _pack, no cache)."""
    h, u_syms, u_soff, u_fn = wp._analyze(docs)
    wp._rt.BtlWpFree(h)
    px, pinit, class_rows, _row, _off = wp._pack(u_syms, u_soff, u_fn)
    return [(px[lo:hi], pinit[lo:hi], lw) for lo, hi, lw in class_rows
            if hi > lo]


def dp_rank(rank: int, world: int, init_file: str, kind: str,
            docs: list[bytes], out_dir: str) -> None:
    """One rank of a gloo group of ``world`` CPU processes joined through
    ``init_file``: the data-parallel runners of the ``kind`` model of
    DP_MODELS over ``docs`` (gpt2, xlnet: ShardedSpRunner.run and run_units
    at a window of DP_DOC; bert: ShardedWpRunner.run_rows on each length
    class of :func:`wp_slabs`), written to ``out_dir/rank<rank>.npz``."""
    import os

    import torch
    import torch.distributed as dist

    from .models.loader import load_bytes
    from .parallel import mesh

    torch.set_num_threads(1)
    mesh.init_group("cpu", init_method=f"file://{init_file}", rank=rank,
                    world_size=world)
    try:
        model = load_bytes(DP_MODELS[kind]())
        res = {}
        if kind == "bert":
            from .runtime.wp_hybrid import WordPieceHybrid

            wp = WordPieceHybrid(model, device="cpu")
            runner = mesh.ShardedWpRunner(wp)
            for k, (bx, bi, lw) in enumerate(wp_slabs(wp, docs)):
                rows, total, chk = runner.run_rows(bx, bi, lw)
                res[f"rows{k}"] = rows
                res[f"stats{k}"] = np.array([total, chk], np.int64)
        else:
            from .runtime.host import SpTokenizer

            tok = SpTokenizer(model, max_doc_symbols=DP_DOC, device="cpu")
            runner = mesh.ShardedSpRunner(tok)
            ids, counts, fb, first, st = runner.run(docs)
            res.update(run_ids=ids.numpy(), run_counts=counts.numpy(),
                       run_fb=fb.numpy(), run_first=first,
                       run_stats=[st.total_tokens, st.checksum, st.total_docs])
            ids, bounds, need, status, st = runner.run_units(docs)
            res.update(units_ids=ids, units_bounds=bounds, units_need=need,
                       units_status=status,
                       units_stats=[st.total_tokens, st.checksum,
                                    st.total_docs])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_dp_ranks(kind: str, docs: list[bytes], world: int, out_dir: str,
                 timeout: float = 120.0) -> list[dict]:
    """Starts :func:`dp_rank` in ``world`` spawned processes and returns
    each rank's results (parallel/mesh.py::spawn_ranks: a rank that fails
    or a timeout raises)."""
    import os

    from .parallel import mesh

    init_file = os.path.join(out_dir, "init")
    mesh.spawn_ranks(dp_rank, (world, init_file, kind, docs, out_dir), world,
                     timeout)
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out
