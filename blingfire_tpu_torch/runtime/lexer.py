# Copy of blingfire_tpu/runtime/lexer.py, kept here so that this package imports nothing of the JAX package.
"""Pattern-lexer ("wbd") engine: scalar oracle + product assembly.

Replicates FALexTools_t (blingfireclient.library/inc/FALexTools_t.h:205-458):
for every start position, longest match in a Moore DFA with IW_ANY fallback
and left/right anchors; matched rule actions emit (Tag, From, To) triples and
may recursively invoke sub-functions (bounded depth, once-flags, FnFrom
advancement).  Drives TextToWords, TextToSentences and WordPiece TextToIds.

Product assembly semantics: blingfiretokdll.cpp:163-582 (words/sentences) and
:1097-1314 (WordPiece stitching).
"""

from __future__ import annotations

import numpy as np

from ..formats.consts import (
    Iw,
    WBD_IGNORE_TAG,
    WBD_WORD_TAG,
    is_whitespace,
)
from ..models.loader import Model, WbdModel
from .casefold import to_lower
from .oracle import TransitionIndex, normalize, utf8_to_utf32

MIN_ACT_SIZE = 3


class LexerEngine:
    """Scalar FALexTools_t equivalent over dense tables."""

    def __init__(self, model: WbdModel):
        self.m = model
        self.trans = TransitionIndex(model.aut)
        self.final = model.aut.final
        self.moore_ow = model.aut.moore_ow
        self.iw2iw = model.aut.iw2iw
        self.acts = model.acts
        self.max_depth = model.max_depth
        self.max_token_length = model.max_token_length
        self.ignore_case = model.ignore_case
        self.initial = model.aut.initial
        self.fn2ini = self._calc_fn_ini()

    # -- transitions -------------------------------------------------------

    def dest(self, state: int, raw_iw: int) -> int:
        """GetDest with original->internal remap (FARSDfa_pack_triv.cpp:141-157)."""
        if state < 0:
            return -1
        if self.iw2iw is not None:
            if raw_iw < 0 or raw_iw >= len(self.iw2iw):
                return -1
            iw = int(self.iw2iw[raw_iw])
            if iw == -1:
                return -1
        else:
            iw = raw_iw
        dst, _ow = self.trans.step(state, iw)
        return dst

    def dest_any(self, state: int, raw_iw: int) -> int:
        """exact transition with IW_ANY fallback (FALexTools_t.h:265-270)."""
        d = self.dest(state, raw_iw)
        if d == -1:
            d = self.dest(state, Iw.ANY)
        return d

    # -- function initial states (FAWbdConfKeeper.cpp:246-314) -------------

    def _calc_fn_ini(self) -> list[int]:
        state_r = self.dest(self.initial, Iw.R_ANCHOR)
        if state_r == -1:
            return []
        max_fn = -1
        for act in self.acts.values():
            i = 2
            n = len(act)
            while i < n:
                if act[i] == 0 and i + 1 < n:
                    i += 1
                    break
                i += 1
            while i < n:
                max_fn = max(max_fn, int(act[i]))
                i += 1
        if max_fn == -1:
            return []
        fn2ini = [self.initial] + [
            self.dest(state_r, fn) for fn in range(1, max_fn + 1)
        ]
        return fn2ini

    # -- the main loop (FALexTools_t.h:205-400) ----------------------------

    def process(
        self,
        seq: list[int],
        max_out: int = 1 << 30,
        fn_tag: int | None = None,
    ) -> list[int]:
        out: list[int] = []
        if fn_tag is None or fn_tag == 0:
            ini = self.initial
        else:
            if not (0 < fn_tag < len(self.fn2ini)):
                return []
            ini = self.fn2ini[fn_tag]
            if ini == -1:
                return []
        self._process_int(ini, 0, seq, 0, len(seq), out, max_out, 1, False)
        return out

    def _process_int(
        self,
        initial: int,
        offset: int,
        seq: list[int],
        lo: int,
        hi: int,
        out: list[int],
        max_out: int,
        rec_depth: int,
        once: bool,
    ) -> int:
        """Process seq[lo:hi]; returns triples appended (×3)."""
        if self.max_depth < rec_depth:
            return 0
        in_size = hi - lo
        n0 = len(out)
        from_pos = -1
        while from_pos < in_size:
            state = initial
            final_state = -1
            final_pos = -1
            j = from_pos
            length_bound = min(from_pos + self.max_token_length, in_size)
            if j == -1:
                state = self.dest(initial, Iw.L_ANCHOR)
                if state == -1:
                    state = self.dest(initial, Iw.ANY)
                    if state == -1:
                        from_pos += 1
                        continue
                j += 1
            while j < length_bound:
                iw = seq[lo + j]
                if iw < Iw.EPSILON:
                    iw = Iw.EPSILON  # control-weight guard (FALexTools_t.h:259-261)
                if self.ignore_case:
                    iw = to_lower(iw)  # FALexTools_t.h:262-264
                dst = self.dest_any(state, iw)
                if dst == -1:
                    break
                if dst >= 0 and self.final[dst]:
                    final_state = dst
                    final_pos = j
                state = dst
                j += 1
            if j == in_size:
                dst = self.dest(state, Iw.R_ANCHOR)
                if dst == -1:
                    dst = self.dest(state, Iw.ANY)
                if dst != -1 and dst >= 0 and self.final[dst]:
                    final_state = dst
                    final_pos = j
            if final_pos != -1:
                ow = int(self.moore_ow[final_state])
                act = self.acts.get(ow)
                assert act is not None and len(act) >= MIN_ACT_SIZE
                left_cx, right_cx, tag = int(act[0]), int(act[1]), int(act[2])
                from2 = min(max(from_pos + left_cx, 0), in_size - 1)
                to2 = min(max(final_pos - right_cx, 0), in_size - 1)
                fn_idx = MIN_ACT_SIZE
                if tag != 0:
                    if len(out) + 3 <= max_out:
                        out.extend((tag, from2 + offset, to2 + offset))
                    else:
                        return len(out) - n0
                    fn_idx = MIN_ACT_SIZE + 1
                fn_once = (len(act) - fn_idx) > 1
                fn_from = from2
                while fn_idx < len(act):
                    fn_id = int(act[fn_idx])
                    fn_ini = self.fn2ini[fn_id]
                    n_before = len(out)
                    self._process_int(
                        fn_ini,
                        fn_from + offset,
                        seq,
                        lo + fn_from,
                        lo + to2 + 1,
                        out,
                        max_out,
                        rec_depth + 1,
                        False if fn_id == 0 else fn_once,
                    )
                    if len(out) > n_before:
                        fn_from = out[-1] + 1 - offset
                        if fn_from > to2:
                            break
                    fn_idx += 1
                if once:
                    return len(out) - n0
                if final_pos - right_cx > from_pos:
                    from_pos = final_pos - right_cx
            from_pos += 1
        return len(out) - n0


def _first_non_ws(seq: list[int], lo: int, hi: int) -> int:
    for i in range(lo, hi):
        if not is_whitespace(seq[i]):
            return i - lo
    return hi - lo


def _cps_to_utf8(seq: list[int]) -> str:
    return "".join(chr(c) if 0 <= c <= 0x10FFFF else "�" for c in seq)


def _utf8_size_b(text: bytes, off: int) -> int:
    if not (0 <= off < len(text)):
        return 0
    b0 = text[off]
    if b0 & 0x80 == 0:
        return 1
    if b0 & 0xE0 == 0xC0:
        return 2
    if b0 & 0xF0 == 0xE0:
        return 3
    if b0 & 0xF8 == 0xF0:
        return 4
    return 0


class LexerOracleApi:
    """TextToWords / TextToSentences / WordPiece TextToIds over one model."""

    def __init__(self, model: Model):
        assert model.wbd is not None
        self.model = model
        self.engine = LexerEngine(model.wbd)
        self.charmap = model.wbd.charmap

    def _decode(self, text: bytes):
        dec = utf8_to_utf32(text)
        if dec is None:
            return None
        cps, offs = dec
        cps = [0x20 if c == 0 else c for c in cps]  # blingfiretokdll.cpp:482
        return cps, offs

    def text_to_words(self, text: bytes | str) -> str | None:
        r = self.text_to_words_with_offsets(text)
        return r if r is None else r[0]

    def text_to_words_with_offsets(self, text: bytes | str):
        """Returns (words_str, starts, ends) — blingfiretokdll.cpp:416-566."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if len(text) == 0:
            return "", [], []
        dec = self._decode(text)
        if dec is None:
            return None
        cps, offs = dec
        res = self.engine.process(cps, max_out=len(cps) * 3)
        words, starts, ends = [], [], []
        for i in range(0, len(res), 3):
            tag, f, t = res[i], res[i + 1], res[i + 2]
            if tag == WBD_IGNORE_TAG:
                continue
            words.append(_cps_to_utf8(cps[f : t + 1]).replace(" ", "_"))
            starts.append(offs[f])
            sz = _utf8_size_b(text, offs[t])
            ends.append(offs[t] + (sz - 1 if sz > 0 else 0))
        return " ".join(words), starts, ends

    def text_to_sentences(self, text: bytes | str) -> str | None:
        r = self.text_to_sentences_with_offsets(text)
        return r if r is None else r[0]

    def text_to_sentences_with_offsets(self, text: bytes | str):
        """Returns (sents_str, starts, ends) — blingfiretokdll.cpp:163-355."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if len(text) == 0:
            return "", [], []
        dec = self._decode(text)
        if dec is None:
            return None
        cps, offs = dec
        n = len(cps)
        res = self.engine.process(cps, max_out=n * 3)
        sents, starts, ends = [], [], []

        def emit(frm: int, to: int):
            delta = _first_non_ws(cps, frm, to + 1)
            if delta < to + 1 - frm:
                sents.append(
                    _cps_to_utf8(cps[frm + delta : to + 1]).replace("\n", " ")
                )
                starts.append(offs[frm + delta])
                sz = _utf8_size_b(text, offs[to])
                ends.append(offs[to] + (sz - 1 if sz > 0 else 0))

        prev_end = -1
        for i in range(0, len(res), 3):
            frm = prev_end + 1
            to = res[i + 2]
            prev_end = to
            emit(frm, to)
        if prev_end + 1 < n:
            emit(prev_end + 1, n - 1)
        return "\n".join(sents), starts, ends

    def text_to_ids(
        self, text: bytes | str, max_len: int = 1 << 30, unk_id: int = 0
    ) -> list[int]:
        """WordPiece TextToIds (blingfiretokdll.cpp:1108-1314)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if len(text) == 0:
            return []
        dec = utf8_to_utf32(text)
        if dec is None:
            return []
        cps, _offs = dec
        if len(cps) == 0 or len(cps) > len(text):
            return []
        if self.charmap is not None:
            cps, _norm_offs = normalize(cps, self.charmap)
            if len(cps) <= 0 or len(cps) > len(text):
                return []
        res = self.engine.process(cps, max_out=len(cps) * 6)
        return self._stitch(res, max_len, unk_id)

    def text_to_ids_with_offsets(
        self, text: bytes | str, max_len: int = 1 << 30, unk_id: int = 0
    ):
        """WordPiece ids + byte offsets (blingfiretokdll.cpp:1109-1314)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if len(text) == 0:
            return [], [], []
        dec = utf8_to_utf32(text)
        if dec is None:
            return [], [], []
        cps, offs = dec
        if len(cps) == 0 or len(cps) > len(text):
            return [], [], []
        norm_offs = None
        if self.charmap is not None:
            cps, norm_offs = normalize(cps, self.charmap)
            if len(cps) <= 0 or len(cps) > len(text):
                return [], [], []
        res = self.engine.process(cps, max_out=len(cps) * 6)

        def to_byte(p: int) -> int:
            return offs[norm_offs[p]] if norm_offs is not None else offs[p]

        ids, starts, ends = [], [], []
        for tid, f, t in self._stitch_spans(res, max_len, unk_id):
            ids.append(tid)
            fo = to_byte(f)
            to = to_byte(t)
            starts.append(fo)
            sz = _utf8_size_b(text, to)
            ends.append(to + (sz - 1 if sz > 0 else 0))
        return ids, starts, ends

    def _stitch(self, res, max_len, unk_id):
        return [tid for tid, _f, _t in self._stitch_spans(res, max_len, unk_id)]

    def _stitch_spans(self, res, max_len, unk_id):
        """(id, from, to) per emitted token (blingfiretokdll.cpp:1210-1311)."""
        out: list[tuple[int, int, int]] = []
        i = 0
        n = len(res)
        while i < n:
            tag, tok_from, tok_to = res[i], res[i + 1], res[i + 2]
            if tag == WBD_IGNORE_TAG:
                i += 3
                continue
            if tag == WBD_WORD_TAG:
                j = i + 3
                num_sub = 0
                covered = False
                if j < n:
                    expected_from = tok_from
                    while (
                        j < n
                        and res[j] > WBD_IGNORE_TAG
                        and expected_from == res[j + 1]
                    ):
                        expected_from = res[j + 2] + 1
                        num_sub += 1
                        j += 3
                    if num_sub > 0 and expected_from - 1 == tok_to:
                        for k in range(num_sub):
                            if len(out) < max_len:
                                b = i + (k + 1) * 3
                                out.append((res[b], res[b + 1], res[b + 2]))
                        covered = True
                if not covered:
                    if len(out) < max_len:
                        out.append((unk_id, tok_from, tok_to))
                # skip past consumed subtokens (j == i+3 when none consumed)
                i = j - 3
            if len(out) >= max_len:
                break
            i += 3
        return out
