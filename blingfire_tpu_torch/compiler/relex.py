# Copy of blingfire_tpu/compiler/relex.py, kept here so that this package imports nothing of the JAX package.
"""Character regular-expression front end for the lex-rules compiler.

Faithful to the reference's lexing quirks (blingfirecompile.library/src/
FARegexpLexer_char.cpp:49-168, FARegexpLexer_triv.cpp:18-90,
FANfaCreator_char.cpp:70-378):

  - specials: . ( ) | * + ? ^ $ < >   (when not backslash-escaped)
  - '[' starts a range token that ends at the FIRST unescaped ']' (with
    [:class:] protection) — macro-expanded nested classes therefore produce
    a literal '[' member plus a trailing literal ']' token, exactly like the
    shipped models (e.g. wbd.bin really does tokenize "-]" as one word)
  - '\\xHEX' symbol + one following space consumed
  - space class: ' ', TAB, CR, LF and backslash itself
  - ranges support literals, '\\xHEX', escapes, a-b intervals, [:names:],
    and '^' negation

Character sets are represented as sorted, disjoint (lo, hi) interval lists.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPECIALS = {
    ".": "ANY",
    "(": "LBR",
    ")": "RBR",
    "|": "ALT",
    "*": "STAR",
    "+": "PLUS",
    "?": "OPT",
    "^": "LA",
    "$": "RA",
    "<": "LTRBR",
    ">": "RTRBR",
}
SPACE = {" ", "\t", "\n", "\r", "\\"}

MAX_CP = 0x10FFFF


def _is_escaped(s: str, pos: int) -> bool:
    n = 0
    i = pos - 1
    while i >= 0 and s[i] == "\\":
        n += 1
        i -= 1
    return n % 2 == 1


@dataclass
class Token:
    kind: str  # special name, SYMBOL, or RANGE
    text: str
    pos: int


def tokenize(s: str) -> list[Token]:
    out: list[Token] = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c in SPECIALS and not _is_escaped(s, i):
            kind = SPECIALS[c]
            length = 1
            if kind == "LTRBR":
                while i + length < n and s[i + length].isdigit():
                    length += 1
                if i + length < n and s[i + length] in SPACE:
                    length += 1
            out.append(Token(kind, s[i : i + length], i))
            i += length
            continue
        if _is_escaped(s, i) and c in ("x", "X"):
            length = 1
            while i + length < n and s[i + length] in "0123456789abcdefABCDEF":
                length += 1
            if i + length < n and s[i + length] in SPACE:
                length += 1
            out.append(Token("SYMBOL", s[i : i + length], i))
            i += length
            continue
        if c == "[" and not _is_escaped(s, i):
            length = 1
            in_spec = False
            while i + length < n:
                cc = s[i + length]
                if cc == "]" and not _is_escaped(s, i + length) and not in_spec:
                    break
                if cc == "[" and not in_spec and i + length + 1 < n and s[i + length + 1] == ":":
                    in_spec = True
                    length += 1
                elif cc == ":" and in_spec and i + length + 1 < n and s[i + length + 1] == "]":
                    in_spec = False
                    length += 1
                length += 1
            if i + length >= n:
                raise SyntaxError(f"missing ] at {i}: {s[i:i+40]!r}")
            out.append(Token("RANGE", s[i : i + length + 1], i))
            i += length + 1
            continue
        if c in SPACE and not _is_escaped(s, i):
            i += 1
            continue
        # ordinary (possibly escaped) character symbol
        out.append(Token("SYMBOL", c, i))
        i += 1
    return out


# -- interval sets ----------------------------------------------------------


def iv_norm(ivs: list[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    ivs = sorted(ivs)
    out: list[tuple[int, int]] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


NAMED = {
    "digit": [(0x30, 0x39)],
    "lower": [(0x61, 0x7A)],
    "upper": [(0x41, 0x5A)],
    "alpha": [(0x41, 0x5A), (0x61, 0x7A)],
    "alnum": [(0x30, 0x39), (0x41, 0x5A), (0x61, 0x7A)],
    "punct": [(0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)],
    "cntrl": [(0x01, 0x1F), (0x7F, 0x7F)],
    "space": [(0x20, 0x20), (0x09, 0x0A), (0x0D, 0x0D), (0x0C, 0x0C), (0x0B, 0x0B)],
    "blank": [(0x20, 0x20), (0x09, 0x09)],
    "xdigit": [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)],
    "print": [(0x20, 0x20), (0x30, 0x39), (0x41, 0x5A), (0x61, 0x7A), (0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)],
    "graph": [(0x30, 0x39), (0x41, 0x5A), (0x61, 0x7A), (0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)],
}

_ESCAPES = {"s": 0x20, "t": 0x09, "r": 0x0D, "n": 0x0A, "b": 0x08, "v": 0x0B, "f": 0x0C}


def _range_next(content: str, i: int):
    """One element of a range body: returns (kind, value, next_i) where kind
    is 'cp' or 'named' (FANfaCreator_char::GetIw:70-190)."""
    n = len(content)
    if content[i] == "[" and i + 1 < n and content[i + 1] == ":":
        j = content.find(":]", i + 2)
        if j > 0:
            name = content[i + 2 : j]
            if name not in NAMED:
                raise SyntaxError(f"unknown class [:{name}:]")
            return "named", name, j + 2
    if content[i] == "\\" and i + 1 < n:
        c1 = content[i + 1]
        if c1 in _ESCAPES:
            return "cp", _ESCAPES[c1], i + 2
        if c1 in ("x", "X"):
            j = i + 2
            while j < n and content[j] in "0123456789abcdefABCDEF":
                j += 1
            return "cp", int(content[i + 2 : j] or "0", 16), j
        return "cp", ord(c1), i + 2
    return "cp", ord(content[i]), i + 1


def parse_range(token_text: str):
    """Range token '[...]' -> (intervals, negative)."""
    content = token_text[1:-1]
    assert content, "empty character range"
    neg = False
    i = 0
    if content and content[0] == "^" and len(content) > 1:
        neg = True
        i = 1
    ivs: list[tuple[int, int]] = []
    n = len(content)
    while i < n:
        kind, v, i = _range_next(content, i)
        if kind == "named":
            ivs.extend(NAMED[v])
            continue
        # interval "a-b" (the '-' must not be the last char)
        if i + 1 < n and content[i] == "-":
            kind2, v2, i2 = _range_next(content, i + 1)
            if kind2 == "cp" and v2 - v >= 0:
                ivs.append((v, v2))
                i = i2
                continue
            raise SyntaxError(f"bad range interval in {token_text!r}")
        ivs.append((v, v))
    return iv_norm(ivs), neg


def symbol_to_ivs(text: str):
    """SYMBOL token -> interval set of one codepoint."""
    if text and text[0] in ("x", "X") and len(text) > 1:
        # \xHEX token (escape backslash was consumed as space by the lexer)
        hexpart = text[1:].strip(" \t\n\r\\")
        return ((int(hexpart, 16), int(hexpart, 16)),)
    cp = ord(text[0])
    return ((cp, cp),)


# -- AST --------------------------------------------------------------------


@dataclass
class Node:
    kind: str  # sym | any | la | ra | cat | alt | star | plus | opt | trbr
    ivs: tuple = ()  # for sym
    neg: bool = False
    children: list = field(default_factory=list)
    trbr_num: int = 0


def parse(tokens: list[Token]) -> Node:
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def parse_alt() -> Node:
        parts = [parse_cat()]
        while peek() and peek().kind == "ALT":
            nonlocal pos
            pos += 1
            parts.append(parse_cat())
        return parts[0] if len(parts) == 1 else Node("alt", children=parts)

    def parse_cat() -> Node:
        parts = []
        while True:
            t = peek()
            if t is None or t.kind in ("ALT", "RBR", "RTRBR"):
                break
            parts.append(parse_post())
        if not parts:
            return Node("cat", children=[])  # epsilon
        return parts[0] if len(parts) == 1 else Node("cat", children=parts)

    def parse_post() -> Node:
        node = parse_atom()
        while peek() and peek().kind in ("STAR", "PLUS", "OPT"):
            nonlocal pos
            k = peek().kind
            pos += 1
            node = Node({"STAR": "star", "PLUS": "plus", "OPT": "opt"}[k], children=[node])
        return node

    def parse_atom() -> Node:
        nonlocal pos
        t = peek()
        if t is None:
            raise SyntaxError("unexpected end of regexp")
        pos += 1
        if t.kind == "LBR":
            inner = parse_alt()
            if not (peek() and peek().kind == "RBR"):
                raise SyntaxError(f"missing ) at {t.pos}")
            pos += 1
            return inner
        if t.kind == "LTRBR":
            num = int(t.text[1:].strip() or "0")
            inner = parse_alt()
            if not (peek() and peek().kind == "RTRBR"):
                raise SyntaxError(f"missing > at {t.pos}")
            pos += 1
            return Node("trbr", children=[inner], trbr_num=num)
        if t.kind == "SYMBOL":
            return Node("sym", ivs=symbol_to_ivs(t.text))
        if t.kind == "RANGE":
            ivs, neg = parse_range(t.text)
            return Node("sym", ivs=ivs, neg=neg)
        if t.kind == "ANY":
            return Node("any")
        if t.kind == "LA":
            return Node("la")
        if t.kind == "RA":
            return Node("ra")
        raise SyntaxError(f"unexpected token {t.kind} at {t.pos}")

    root = parse_alt()
    if peek() is not None:
        raise SyntaxError(f"trailing tokens at {peek().pos}: {peek().text!r}")
    return root


def parse_regexp(text: str) -> Node:
    return parse(tokenize(text))
