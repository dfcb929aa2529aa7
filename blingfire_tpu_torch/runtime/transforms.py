# Copy of blingfire_tpu/runtime/transforms.py, kept here so that this package imports nothing of the JAX package.
"""Word transformations (FATransform_* family).

Reversible rewrites applied to a word before/after the morphology automata:
hyphenated-reduplication folding, prefix rotation, upper-case-first folding,
escape-sequence decoding, and their inverses, plus the cascade combinator
(reference: blingfireclient.library/inc/FATransform_{hyph_redup,
hyph_redup_rev,prefix,prefix_rev,capital,capital_rev,unescape,cascade}_t.h,
selected/configured by FATrsConfKeeper_t.h:140-365).

Each transform maps a sequence of code points to a new sequence, or returns
None when it does not apply (the reference's ``-1`` Process result).  Inputs
and outputs are plain Python int lists — these run host-side at model-load /
word-lookup granularity, not in the device hot path.
"""

from __future__ import annotations

from .casefold import to_lower, to_upper

HYPHEN = 0x2D  # '-'
DEF_REDUP_DELIM = 2
DEF_PREF_DELIM = 3
DEF_UCF_DELIM = 2
BACKSLASH = 0x5C  # '\\'

_UNESC = {ord("n"): ord("\n"), ord("r"): ord("\r"), ord("t"): ord("\t"),
          BACKSLASH: BACKSLASH}


class Transform:
    """Base: callable word -> word-or-None."""

    def __call__(self, seq: list[int]) -> list[int] | None:
        raise NotImplementedError


class HyphRedup(Transform):
    """"aaab-aaabce" -> "aaab<delim>ce" (FATransform_hyph_redup_t.h:44-118)."""

    def __init__(self, delim: int = DEF_REDUP_DELIM):
        self.delim = delim

    def __call__(self, seq: list[int]) -> list[int] | None:
        n = len(seq)
        half = (n + 1) >> 1
        hyph = -1
        for i in range(half):
            if seq[i] == HYPHEN and seq[:i] == seq[i + 1 : 2 * i + 1]:
                hyph = i
                break
        if hyph == -1:
            return None
        return seq[:hyph] + [self.delim] + seq[2 * hyph + 1 :]


class HyphRedupRev(Transform):
    """"aaab<delim>ce" -> "aaab-aaabce" (FATransform_hyph_redup_rev_t.h:43-115)."""

    def __init__(self, delim: int = DEF_REDUP_DELIM):
        self.delim = delim

    def __call__(self, seq: list[int]) -> list[int] | None:
        try:
            d = seq.index(self.delim)
        except ValueError:
            return None
        pre = seq[:d]
        return pre + [HYPHEN] + pre + seq[d + 1 :]


class Prefix(Transform):
    """Rotate a recognized prefix to the end: "preword" -> "word<delim>pre".

    The prefix set is a DFA over code points; the longest final match wins
    but at most the first len-1 characters are scanned
    (FATransform_prefix_t.h:46-121: ``i < InCount - 1``)."""

    def __init__(self, dfa, delim: int = DEF_PREF_DELIM):
        """`dfa` exposes initial/get_dest/is_final over dense state ids."""
        self.dfa = dfa
        self.delim = delim

    def _pref_len(self, seq: list[int]) -> int:
        state = self.dfa.initial
        pref = 0
        for i in range(len(seq) - 1):
            state = self.dfa.get_dest(state, seq[i])
            if state == -1:
                return pref
            if self.dfa.is_final(state):
                pref = i + 1
        return pref

    def __call__(self, seq: list[int]) -> list[int] | None:
        p = self._pref_len(seq)
        if p == 0:
            return None
        return seq[p:] + [self.delim] + seq[:p]


class PrefixRev(Transform):
    """"word<delim>pre" -> "preword" (FATransform_prefix_rev_t.h:44-110)."""

    def __init__(self, delim: int = DEF_PREF_DELIM):
        self.delim = delim

    def __call__(self, seq: list[int]) -> list[int] | None:
        try:
            d = seq.index(self.delim)
        except ValueError:
            return None
        return seq[d + 1 :] + seq[:d]


class Capital(Transform):
    """"Word" -> "word<delim>" when the first cp case-folds differently
    (FATransform_capital_t.h:36-64)."""

    def __init__(self, delim: int = DEF_UCF_DELIM):
        self.delim = delim

    def __call__(self, seq: list[int]) -> list[int] | None:
        if not seq:
            return None
        lo = to_lower(seq[0])
        if lo == seq[0]:
            return None
        return [lo] + seq[1:] + [self.delim]


class CapitalRev(Transform):
    """"word<delim>" -> "Word" (FATransform_capital_rev_t.h:36-58)."""

    def __init__(self, delim: int = DEF_UCF_DELIM):
        self.delim = delim

    def __call__(self, seq: list[int]) -> list[int] | None:
        if len(seq) <= 1 or seq[-1] != self.delim:
            return None
        return [to_upper(seq[0])] + seq[1:-1]


class Unescape(Transform):
    """Decode \\n, \\r, \\t, \\\\ escapes; bare TAB characters outside escapes
    become NUL (FATransform_unescape_t.h:40-100,158-196).  Any invalid escape
    sequence makes the whole transform inapplicable."""

    def __call__(self, seq: list[int]) -> list[int] | None:
        n = len(seq)
        # validate and count (GetEscSequenceCount)
        esc = 0
        i = 0
        while i < n - 1:
            if seq[i] == BACKSLASH:
                if seq[i + 1] not in _UNESC:
                    return None
                esc += 1
                i += 2
            else:
                i += 1
        if esc == 0:
            return None
        out: list[int] = []
        i = 0
        while i < n:
            c = seq[i]
            if c == BACKSLASH and i < n - 1 and seq[i + 1] in _UNESC:
                out.append(_UNESC[seq[i + 1]])
                i += 2
            else:
                out.append(0 if c == ord("\t") else c)
                i += 1
        return out


class Cascade(Transform):
    """Apply up to 4 transforms in order; a transform that does not apply
    leaves the intermediate word unchanged (FATransform_cascade_t.h:68-106).
    Unlike the single transforms, the cascade always returns a word."""

    def __init__(self, transforms: list[Transform]):
        if not 1 <= len(transforms) <= 4:
            raise ValueError("cascade holds 1..4 transforms")
        self.transforms = list(transforms)

    def __call__(self, seq: list[int]) -> list[int]:
        out = self.transforms[0](seq)
        if out is None:
            out = list(seq)
        for tr in self.transforms[1:]:
            nxt = tr(out)
            if nxt is not None:
                out = nxt
        return out
