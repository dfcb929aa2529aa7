"""The one traffic generator: a seeded Zipfian text corpus.

A frozen copy of ``blingfire_tpu_torch.testing``'s ``word_list`` and
``zipf_corpus`` (with its ``EDGE_CASES``), kept here so that a change to the
program cannot move the benchmark's traffic.  Every number the original
fixes is a parameter read from a traffic mix's file (``traffic/<mix>.json``);
at the defaults below, ``zipf_docs`` equals ``testing.zipf_corpus`` given
``lexicon_seed == seed``.

The lexicon (the frequent words) comes from ``lexicon_seed``, the language
the configurations' vocabularies were built for; ``seed`` draws the
documents: which words, in which order, how long, and the rare words,
numbers and punctuation runs.

A mix's documents, and the orders in which the calls send them, are the
same for every ``--seed`` (``CONTENT_SEED``): how much work a call makes
depends on the order of its documents (which units first share a device
row), so that runs of different seeds would otherwise do different work.
"""

from __future__ import annotations

import numpy as np

CONTENT_SEED = 0  # the documents and their orders
ORDERS = 4  # orders of the documents that a run's calls take in turn
# the edge cases of tests/corpus.py, as testing.EDGE_CASES
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
    "Привет мир",
    "你好世界",
    "こんにちは世界",
    "안녕하세요 세계",
    "مرحبا بالعالم",
    "שלום עולם",
    "Ελληνικά κείμενο",
    "हिन्दी पाठ",
    "🙂 emoji 🚀 test 🎉",
    "𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝕞𝕒𝕥𝕙",
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
    "x y z　w",
    "a▁b",
    "▁",
    "ab\x01cd\x02ef",
    "supercalifragilisticexpialidocious pneumonoultramicroscopicsilicovolcanoconiosis",
    "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    "ab" * 100,
    "word " * 50,
    "ÃÂÃÂÃÂÃÂ",
    "1234567890" * 10,
    "!@#$%^&*()_+-=[]{}|;:,.<>?/~`",
    "\x7f\x7f",
    "Ｆｕｌｌｗｉｄｔｈ ｔｅｘｔ",
    "ǅungla ǈljubljana",
    "ﬁ ﬂ ﬀ ligatures",
    "ß ẞ İ ı",
    "é combining acute",
    "\x00embedded null",
]

LONG_CHARS = b"-=_.*#~+/!"

# English letter frequencies (a..z)
_LETTER_P = np.array([
    8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4,
    6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074,
])
_LETTER_P = _LETTER_P / _LETTER_P.sum()
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)

DEFAULTS = {
    "lexicon_seed": 0,  # the frequent words' seed (the vocabularies' language)
    "words": 20000,  # distinct frequent words
    "zipf_s": 1.05,  # Zipf exponent of the frequent words
    "top_punct": 2000,  # frequent words that also appear punctuated
    "punct_share": 0.012,  # weight of each punctuated variant, of its word's
    "rare": 50000,  # rare words
    "rare_share": 0.03,  # of the frequent words' total weight
    "numbers": 2000,
    "number_share": 0.01,
    "runs": 300,  # long punctuation runs of 17..159 characters
    "run_share": 0.00001,
    "words_per_doc": 60,  # mean of the geometric document length in words
    "max_doc_words": 480,
    "edge_cases": True,  # EDGE_CASES first
    # documents given as bytes, after the edge cases (hex, one a document):
    # UTF-8 that is not valid, a bare byte-order mark
    "bytes_docs_hex": [],
}


def random_words(rng: np.random.Generator, n: int, lo: int = 2,
                 hi: int = 14) -> list[bytes]:
    lens = np.clip(rng.geometric(0.2, size=n) + lo - 1, lo, hi)
    letters = rng.choice(LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cuts = np.concatenate([[0], np.cumsum(lens)])
    blob = letters.tobytes()
    return [blob[cuts[i]:cuts[i + 1]] for i in range(n)]


def word_list(seed: int, n_words: int) -> list[bytes]:
    """Distinct synthetic words, most frequent first; ~10% capitalized."""
    rng = np.random.default_rng(seed)
    out: list[bytes] = []
    seen: set[bytes] = set()
    while len(out) < n_words:
        for w in random_words(rng, 2 * (n_words - len(out)) + 16):
            if rng.random() < 0.1:
                w = w[:1].upper() + w[1:]
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == n_words:
                    break
    return out


def zipf_docs(target_bytes: int, seed: int, params: dict | None = None
              ) -> list[bytes]:
    """Documents of at least ``target_bytes`` bytes in all, the edge cases
    first (when asked), then documents of geometric length in words drawn
    from the lexicon by Zipf's law, with punctuated variants, rare words,
    numbers and long punctuation runs.  The edge cases and the byte
    documents count towards ``target_bytes``."""
    p_ = dict(DEFAULTS, **(params or {}))
    rng = np.random.default_rng(seed + 7)
    words_per_doc = int(p_["words_per_doc"])
    n_rare = int(p_["rare"])
    words = word_list(int(p_["lexicon_seed"]), int(p_["words"]))
    lex = list(words)
    w = 1.0 / np.arange(1, len(words) + 1) ** float(p_["zipf_s"])
    top = min(int(p_["top_punct"]), len(words))
    for p in (b",", b".", b"!", b"?", b";", b"'s"):
        lex += [x + p for x in words[:top]]
    wp = np.concatenate([w] + [w[:top] * float(p_["punct_share"])] * 6)
    lex += random_words(rng, n_rare, 3, 18)
    wr = np.full(n_rare, float(p_["rare_share"]) * wp.sum() / n_rare)
    n_num = int(p_["numbers"])
    lex += [str(int(v)).encode() for v in rng.integers(0, 100000, n_num)]
    wn = np.full(n_num, float(p_["number_share"]) * wp.sum() / n_num)
    runs = [bytes([LONG_CHARS[i % len(LONG_CHARS)]]) * int(n)
            for i, n in enumerate(rng.integers(17, 160, int(p_["runs"])))]
    lex += runs
    wl = np.full(len(runs), float(p_["run_share"]) * wp.sum() / len(runs))
    p = np.concatenate([wp, wr, wn, wl])
    p = p / p.sum()
    avg = float(np.dot(p, [len(x) + 1 for x in lex]))
    n_tok = int(target_bytes / avg * 1.05) + words_per_doc
    ids = rng.choice(len(lex), size=n_tok, p=p)
    docs = ([e.encode("utf-8") for e in EDGE_CASES] if p_["edge_cases"]
            else [])
    docs += [bytes.fromhex(h) for h in p_["bytes_docs_hex"]]
    total = sum(map(len, docs))
    lens = np.clip(rng.geometric(1.0 / words_per_doc, size=n_tok // 4 + 1),
                   1, int(p_["max_doc_words"]))
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


def traffic_docs(traffic: dict) -> list[bytes]:
    """A mix's documents, the edge cases and invalid ones first."""
    return zipf_docs(int(traffic["bytes"]), CONTENT_SEED,
                     traffic.get("corpus"))


def orders(n_docs: int, head: int) -> list[np.ndarray]:
    """ORDERS fixed orders of ``n_docs`` documents: the first ``head`` in
    place, the rest shuffled."""
    rng = np.random.default_rng(CONTENT_SEED)
    return [np.concatenate([np.arange(head),
                            rng.permutation(n_docs - head) + head])
            for _ in range(ORDERS)]
