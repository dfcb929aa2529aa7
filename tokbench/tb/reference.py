"""The plain reference: BlingFire's TextToIds for a [pos-dict] model, in
plain Python, from the vocabulary entries themselves.

It reads neither the program's compiled image nor its tables: the pieces go
into a dict trie here.  It follows BlingFire's sources as the port's scalar
oracle (``runtime/oracle.py``) reads them, written again over the entries:

- decode (blingfiretokdll.cpp:1349-1535): raw bytes in byte mode, else
  strict UTF-8 (an invalid document has no ids); a BOM is dropped;
- the dummy ``▁`` prefix, unless the model has none;
- the charmap, one character to 1..10 (none: dropped; absent: kept);
- whitespace runs to one ``▁``, a trailing ``▁`` dropped;
- BPE (FATokenSegmentationTools_1best_bpe_t.h:125-316): every match is an
  arc, with BPE_OPT's fast-forward over a whole ▁-word; arcs sorted by
  (id, start) claim their span when it is free;
- unigram LM (FATokenSegmentationTools_1best_t.h:117-279): Viterbi over the
  matches, float32 scores summed in double, unknown characters at
  UNK_SCORE, adjacent unknowns joined;
- the model's id offset.

Three controls sit beside it (``control=``): ``"f32_sums"`` sums the
unigram scores in float32, the precision below the double of the sums;
``"bf16_scores"`` rounds each score (unigram) or each arc's rank, its id
(BPE), to bfloat16, the precision below the float32 of the scores;
``"window_cut"`` cuts every document to the device window's symbols, as a
program would that dropped its path for longer documents.
"""

from __future__ import annotations

import struct

SP_DELIMITER = 0x2581
UNK_SCORE = -100000.0  # FATokenSegmentationTools_1best_t.h:97
_FINAL = -1  # trie key of a node's (id, score)
_F32 = struct.Struct("<f")


def _f32(x: float) -> float:
    return _F32.unpack(_F32.pack(x))[0]


def _bf16(x: float) -> float:
    """``x`` rounded to bfloat16 (to nearest, ties to even)."""
    b = _F32.pack(x)
    u = int.from_bytes(b, "little")
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(u.to_bytes(4, "little"))[0]


def is_whitespace(c: int) -> bool:
    """The product whitespace class (blingfiretokdll.h:16-21)."""
    return (c <= 0x20 or c == 0xA0 or 0x2000 <= c <= 0x200F or c == 0x202F
            or c == 0x205F or c == 0x2060 or c == 0x2420 or c == 0x2424
            or c == 0x3000 or c == 0xFEFF)


class Reference:
    """TextToIds of one configuration.  ``cfg`` is the configuration's file
    (``tok_algo`` "BPE_OPT" or "UNIGRAM", ``id_offset``,
    ``use_byte_encoding``, ``no_dummy_prefix``, ``max_doc_symbols``);
    ``entries`` (symbols, id, score); ``charmap`` code point -> list."""

    def __init__(self, cfg: dict, entries, charmap=None,
                 control: str | None = None):
        if cfg["tok_algo"] not in ("BPE_OPT", "UNIGRAM"):
            raise ValueError(f"no reference for {cfg['tok_algo']}")
        if control not in (None, "f32_sums", "bf16_scores", "window_cut"):
            raise ValueError(f"no control {control}")
        self.cfg = cfg
        self.bpe = cfg["tok_algo"] == "BPE_OPT"
        self.offset = int(cfg["id_offset"])
        self.raw = bool(cfg["use_byte_encoding"])
        self.prefix = not cfg["no_dummy_prefix"]
        self.charmap = charmap
        self.control = control
        self.trie: dict = {}
        for chain, tid, score in entries:
            node = self.trie
            for s in chain:
                node = node.setdefault(s, {})
            score = _f32(float(score))
            if control == "bf16_scores":
                score = _bf16(score)
            node[_FINAL] = (int(tid), score)

    # -- the text pipeline ---------------------------------------------

    def symbols(self, text: bytes) -> list[int] | None:
        """The symbols BlingFire segments, or None for no ids."""
        if len(text) == 0:
            return None
        body = text[3:] if text[:3] == b"\xef\xbb\xbf" else text
        if self.raw:
            chars = list(body)
        else:
            try:
                chars = [ord(ch) for ch in body.decode("utf-8")]
            except UnicodeDecodeError:
                return None
        if len(chars) == 0 or len(chars) > len(text):
            return None
        if self.prefix:
            chars = [SP_DELIMITER] + chars
        if self.charmap is not None:
            norm: list[int] = []
            for c in chars:
                m = self.charmap.get(c)
                if m is None:
                    norm.append(c)
                elif 1 <= len(m) <= 10:
                    norm.extend(m)
            if len(norm) == 0 or len(norm) > 2 * (len(text) + 1):
                return None
            chars = norm
        out: list[int] = []
        for c in chars:
            if not is_whitespace(c):
                out.append(c)
            elif not out or out[-1] != SP_DELIMITER:
                out.append(SP_DELIMITER)
        if len(out) > 1 and out[-1] == SP_DELIMITER:
            out.pop()
        if self.control == "window_cut":
            out = out[: int(self.cfg["max_doc_symbols"])]
        return out

    def text_to_ids(self, text: bytes, unk_id: int) -> list[int]:
        seq = self.symbols(text)
        if not seq:
            return []
        pieces = (self._bpe(seq, unk_id) if self.bpe
                  else self._unigram(seq, unk_id))
        return [t + self.offset for t in pieces]

    # -- matches -----------------------------------------------------------

    def _matches(self, seq: list[int], start: int):
        """(end, id, score) of every piece that starts at ``start``."""
        node = self.trie
        for i in range(start, len(seq)):
            node = node.get(seq[i])
            if node is None:
                return
            hit = node.get(_FINAL)
            if hit is not None:
                yield i, hit[0], hit[1]

    # -- BPE_OPT -------------------------------------------------------------

    def _bpe(self, seq: list[int], unk_id: int) -> list[int]:
        n = len(seq)
        arcs: list[list] = []  # [id, start, end]
        start = 0
        while start < n:
            known = False
            word_start = seq[start] == SP_DELIMITER
            first = len(arcs)
            ff = start
            for end, tid, _score in self._matches(seq, start):
                whole = (word_start and first < len(arcs)
                         and (end == n - 1 or seq[end + 1] == SP_DELIMITER))
                if whole:
                    del arcs[first:]
                    ff = end
                arcs.append([tid, start, end])
                known = True
            if not known:
                if arcs and arcs[-1][0] == unk_id:
                    arcs[-1][2] = start
                else:
                    arcs.append([unk_id, start, start])
            start = ff + 1
        if self.control == "bf16_scores":
            arcs.sort(key=lambda a: (_bf16(float(a[0])), a[1]))
        else:
            arcs.sort(key=lambda a: (a[0], a[1]))
        to = [0] * n
        ids = [unk_id] * n
        inner = [False] * n
        for tid, s, e in arcs:
            if not inner[s] and (e + 1 == n or not inner[e + 1]):
                to[s] = e
                ids[s] = tid
                for j in range(s + 1, e + 1):
                    inner[j] = True
        out = []
        s = 0
        while s < n:
            out.append(ids[s])
            s = to[s] + 1
        return out

    # -- unigram LM ------------------------------------------------------------

    def _unigram(self, seq: list[int], unk_id: int) -> list[int]:
        n = len(seq)
        f32 = self.control == "f32_sums"
        begin = [-1] * n
        best_id = [-1] * n
        best = [float("-inf")] * n
        for start in range(n):
            prev = best[start - 1] if start > 0 else 0.0
            known = False
            for end, tid, score in self._matches(seq, start):
                cand = _f32(score + prev) if f32 else score + prev
                if best[end] < cand:
                    begin[end] = start
                    best_id[end] = tid
                    best[end] = cand
                known = True
            if not known:
                cand = _f32(UNK_SCORE + prev) if f32 else UNK_SCORE + prev
                if best[start] < cand:
                    begin[start] = start
                    best_id[start] = -1
                    best[start] = cand
                    if start > 0 and best_id[start - 1] == -1:
                        begin[start] = begin[start - 1]
        out = []
        end = n - 1
        while end >= 0:
            s = begin[end]
            tid = best_id[end]
            out.append(tid if tid != -1 else unk_id)
            end = s - 1
        out.reverse()
        return out
