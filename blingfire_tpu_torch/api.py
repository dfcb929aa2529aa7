"""Public API: port of blingfire_tpu/api.py.  It mirrors the reference C ABI
(blingfiretokdll.h:25-103) with a Pythonic face and batched entry points
that run on the card.

  load_model(path)           ~ LoadModel
  TokenizerHandle methods:
    .text_to_ids / .text_to_ids_batch            ~ TextToIds
    .text_to_ids_with_offsets                    ~ TextToIdsWithOffsets
    .text_to_words / .text_to_sentences          ~ TextToWords/Sentences
    .word_hyphenation                            ~ WordHyphenationWithModel
    .ids_to_text                                 ~ IdsToText
    .set_no_dummy_prefix                         ~ SetNoDummyPrefix
  normalize_spaces(text)     ~ NormalizeSpaces
  text_to_hashes(text)       ~ TextToHashes
  get_version()              ~ GetBlingFireTokVersion
  normalize_text(text, algo) ~ FAStrUtf8Normalize (diacritics maps)
  to_lower/to_upper/...      ~ FAUtf32ToLower/ToUpper/IsLower/IsUpper

Single-string calls run in the native runtime (native/runtime.cpp, built at
first use; a failed build raises), or in the scalar engines when
``BTL_NATIVE=0``.  ``text_to_ids_batch`` runs on ``device``: the [pos-dict]
models through ``runtime.host.SpTokenizer`` (K1-K4, or K5, K6 and K4), the
WordPiece models through ``runtime.wp_hybrid.WordPieceHybrid`` (K3, K7 or
K8), or ``runtime.lexer_host.WordPieceTpu`` (K9) for a model without the
hybrid's iw map or that is not pack-safe.  Nothing here touches the card
before a batch call, and torch is imported only with a batch engine or a
[w2h] model.
"""

from __future__ import annotations

import ctypes
import os
import weakref
from typing import TYPE_CHECKING

from .formats.consts import SP_DELIMITER, DEFAULT_HYPHEN, NormAlgo, is_whitespace  # noqa: F401
from .models.loader import Model, load_model as _load_model
from .runtime.casefold import is_lower, is_upper, to_lower, to_upper  # noqa: F401
from .runtime.lexer import LexerOracleApi
from .runtime.normalize import normalize_text  # noqa: F401
from .runtime.oracle import SpTokenizerOracle, utf8_to_utf32

if TYPE_CHECKING:
    import torch

VERSION = (1, 0)
MAX_HYPH_WORD = 300  # code points WordHyphenationWithModel reads of a word


def get_version() -> int:
    """major*1000+minor, like GetBlingFireTokVersion (blingfiretokdll.cpp:107)."""
    return VERSION[0] * 1000 + VERSION[1]


def _utf8(text: bytes | str) -> bytes:
    return text.encode("utf-8") if isinstance(text, str) else text


class TokenizerHandle:
    """One loaded model with all its engines, analogous to FAModelData.

    The batch engines are built at their first call, on ``device``
    (``device="cpu"`` runs the kernels' plain PyTorch versions);
    ``device_opts`` go to ``SpTokenizer`` (``max_doc_symbols``, ``a_max``)."""

    def __init__(self, model: Model, use_device: bool = True,
                 device: str | torch.device = "cuda", **device_opts):
        self.model = model
        self._sp = None
        self._sp_oracle = None
        self._lexer = None
        self._hyph = None
        self._words_dev = None
        self._wp_dev = None
        self._use_device = use_device
        self._device = device
        self._device_opts = device_opts
        self._native = False  # unresolved; resolved lazily to None or a tuple
        if model.seg is not None:
            self._sp_oracle = SpTokenizerOracle(model.seg)
        if model.wbd is not None:
            self._lexer = LexerOracleApi(model)
        if model.w2h is not None:
            from .runtime.hyph import HyphEngine

            self._hyph = HyphEngine(model.w2h)

    # -- the native runtime for single-string calls -------------------------

    def _native_rt(self):
        """(lib, handle, image buffer) of the native runtime for this model,
        or None when ``BTL_NATIVE=0`` asks for the scalar engines.  A failed
        build, or an image the runtime rejects, raises."""
        if self._native is False:
            self._native = None
            if os.environ.get("BTL_NATIVE", "1") != "0":
                from .native import get_runtime

                lib = get_runtime()
                img = self.model.ldb.image
                buf = ctypes.create_string_buffer(img, len(img))
                h = lib.SetModel(buf, len(img))
                if not h:
                    raise ValueError("the native runtime rejected the model "
                                     "image")
                if self.model.seg is not None:
                    lib.SetNoDummyPrefix(ctypes.c_void_p(h),
                                         bool(self.model.seg.no_dummy_prefix))
                self._native = (lib, h, buf)
                weakref.finalize(self, lib.FreeModel, ctypes.c_void_p(h))
        return self._native

    # -- the batch engines, built at first use ------------------------------

    def _device_sp(self):
        if self._sp is None and self.model.seg is not None:
            from .runtime.host import SpTokenizer

            self._sp = SpTokenizer(self.model, device=self._device,
                                   **self._device_opts)
        return self._sp

    def _device_words(self):
        if self._words_dev is None and self.model.wbd is not None:
            from .runtime.lexer_host import WordsTpu

            self._words_dev = WordsTpu(self.model, device=self._device)
        return self._words_dev

    def _device_wp(self):
        """The hybrid (native level 0, K7 or K8 on the card) when the model
        has its iw map and is pack-safe, else WordPieceTpu (K9)."""
        if self._wp_dev is None and self.model.wbd is not None:
            wp = None
            if self.model.wbd.aut.iw2iw is not None:
                from .runtime.wp_hybrid import WordPieceHybrid

                wp = WordPieceHybrid(self.model, device=self._device)
            if wp is not None and wp.available():
                self._wp_dev = wp
            else:
                from .runtime.lexer_host import WordPieceTpu

                self._wp_dev = WordPieceTpu(self.model, device=self._device)
        return self._wp_dev

    # -- TextToIds family --------------------------------------------------

    def _native_ids(self, text, max_len, unk_id, offsets: bool):
        nt = self._native_rt()
        if nt is None:
            return None
        lib, h, _buf = nt
        text = _utf8(text)
        cap = len(text) + 2
        if max_len is not None:
            cap = min(cap, max_len)
        ids = (ctypes.c_int32 * max(cap, 1))()
        if offsets:
            st = (ctypes.c_int32 * max(cap, 1))()
            en = (ctypes.c_int32 * max(cap, 1))()
            n = lib.TextToIdsWithOffsets(
                ctypes.c_void_p(h), text, len(text), ids, st, en, cap, unk_id
            )
            n = min(n, cap)
            return list(ids[:n]), list(st[:n]), list(en[:n])
        n = lib.TextToIds(ctypes.c_void_p(h), text, len(text), ids, cap, unk_id)
        return list(ids[: min(n, cap)])

    def _native_str(self, fname: str, text, extra=()):
        nt = self._native_rt()
        if nt is None:
            return None
        lib, h, _buf = nt
        text = _utf8(text)
        maxn = 4 * len(text) + 64
        out = ctypes.create_string_buffer(maxn)
        n = getattr(lib, fname)(
            text, len(text), out, maxn, ctypes.c_void_p(h), *extra
        )
        if n < 0:
            return None  # invalid input
        if n == 0:
            return ""
        if n > maxn:
            out = ctypes.create_string_buffer(n)
            n = getattr(lib, fname)(
                text, len(text), out, n, ctypes.c_void_p(h), *extra
            )
        return out.raw[: n - 1].decode("utf-8", errors="replace")

    def text_to_ids(
        self, text: bytes | str, max_len: int | None = None, unk_id: int = 0
    ) -> list[int]:
        """Single-string TextToIds (dispatches wp vs sp like the reference)."""
        r = self._native_ids(text, max_len, unk_id, offsets=False)
        if r is not None:
            return r
        if self.model.has_seg:
            return self._sp_oracle.text_to_ids(text, max_len, unk_id)
        assert self._lexer is not None, "model has no tokenizer sections"
        return self._lexer.text_to_ids(
            _utf8(text), max_len if max_len is not None else 1 << 30, unk_id
        )

    def text_to_ids_with_offsets(
        self, text: bytes | str, max_len: int | None = None, unk_id: int = 0
    ):
        r = self._native_ids(text, max_len, unk_id, offsets=True)
        if r is not None:
            return r
        if self.model.has_seg:
            return self._sp_oracle.text_to_ids_with_offsets(text, max_len, unk_id)
        assert self._lexer is not None, "model has no tokenizer sections"
        return self._lexer.text_to_ids_with_offsets(
            _utf8(text), max_len if max_len is not None else 1 << 30, unk_id
        )

    def text_to_ids_batch(
        self, docs: list[bytes | str], unk_id: int = 0
    ) -> list[list[int]]:
        """Batched TextToIds on ``device``."""
        if self._use_device:
            if self.model.has_seg:
                return self._device_sp().encode_batch(docs, unk_id=unk_id)
            if self.model.wbd is not None:
                return self._device_wp().text_to_ids_batch(docs, unk_id=unk_id)
        return [self.text_to_ids(d, unk_id=unk_id) for d in docs]

    def text_to_words_batch(self, docs: list[bytes | str]) -> list[str | None]:
        # the native runtime first (DFA lexing is bound by lookup latency,
        # which favours the host); the card's lexer (WordsTpu, K9) only
        # without it
        if self._native_rt() is not None:
            return [self.text_to_words(d) for d in docs]
        if self._use_device and self.model.wbd is not None:
            return self._device_words().text_to_words_batch(docs)
        return [self.text_to_words(d) for d in docs]

    def text_to_sentences_batch(self, docs: list[bytes | str]) -> list[str | None]:
        if self._native_rt() is not None:
            return [self.text_to_sentences(d) for d in docs]
        if self._use_device and self.model.wbd is not None:
            return self._device_words().text_to_sentences_batch(docs)
        return [self.text_to_sentences(d) for d in docs]

    # -- words / sentences -------------------------------------------------

    def text_to_words(self, text: bytes | str) -> str | None:
        assert self._lexer is not None, "model has no [wbd] section"
        if self._native_rt() is not None:
            return self._native_str("TextToWordsWithModel", text)
        return self._lexer.text_to_words(text)

    def text_to_sentences(self, text: bytes | str) -> str | None:
        assert self._lexer is not None, "model has no [wbd] section"
        if self._native_rt() is not None:
            return self._native_str("TextToSentencesWithModel", text)
        return self._lexer.text_to_sentences(text)

    def _native_str_offsets(self, fname: str, text, sep: str):
        """(text, starts, ends) via the native runtime, or None."""
        lib, h, _buf = self._native_rt()
        text = _utf8(text)
        maxn = 4 * len(text) + 64
        out = ctypes.create_string_buffer(maxn)
        starts = (ctypes.c_int32 * maxn)()
        ends = (ctypes.c_int32 * maxn)()
        n = getattr(lib, fname)(
            text, len(text), out, starts, ends, maxn, ctypes.c_void_p(h)
        )
        if n < 0:
            return None
        s = out.raw[: max(n - 1, 0)].decode("utf-8", errors="replace")
        k = len(s.split(sep)) if s else 0
        return s, list(starts[:k]), list(ends[:k])

    def text_to_words_with_offsets(self, text: bytes | str):
        """(words_text, starts, ends) ~ TextToWordsWithOffsetsWithModel
        (blingfiretokdll.cpp:415-573)."""
        assert self._lexer is not None, "model has no [wbd] section"
        if self._native_rt() is not None:
            return self._native_str_offsets(
                "TextToWordsWithOffsetsWithModel", text, " "
            )
        return self._lexer.text_to_words_with_offsets(text)

    def text_to_sentences_with_offsets(self, text: bytes | str):
        """(sents_text, starts, ends) ~ TextToSentencesWithOffsetsWithModel."""
        assert self._lexer is not None, "model has no [wbd] section"
        if self._native_rt() is not None:
            return self._native_str_offsets(
                "TextToSentencesWithOffsetsWithModel", text, "\n"
            )
        return self._lexer.text_to_sentences_with_offsets(text)

    # -- hyphenation (blingfiretokdll.cpp:824-911) -------------------------

    def word_hyphenation(
        self, text: bytes | str, uhy: int = DEFAULT_HYPHEN
    ) -> str | None:
        """The word with ``uhy`` after each hyphenation point; NUL reads as
        a space and a word is cut to its first 300 code points."""
        assert self._hyph is not None, "model has no [w2h] section"
        if self._native_rt() is not None:
            return self._native_str("WordHyphenationWithModel", text, (uhy,))
        text = _utf8(text)
        if len(text) == 0:
            return ""
        dec = utf8_to_utf32(text)
        if dec is None:
            return None
        cps = [0x20 if c == 0 else c for c in dec[0][:MAX_HYPH_WORD]]
        res = self._hyph.process(cps)
        if res is None:
            return None
        from .runtime.hyph import HYPH_NO_HYPH

        out = []
        for c, h in zip(cps, res):
            out.append(chr(c))
            if h > HYPH_NO_HYPH:
                out.append(chr(uhy))
        return "".join(out)

    # -- detokenization (blingfiretokdll.cpp:1689-1745) --------------------

    def ids_to_text(self, ids, skip_special_tokens: bool = True) -> str | None:
        i2w = self.model.i2w
        if i2w is None:
            return None
        chunks: list[bytes] = []
        first = True
        for id_ in ids:
            id_ = int(id_)
            if skip_special_tokens and (
                id_ < i2w.min_token_id or id_ > i2w.max_token_id
            ):
                continue
            tok = i2w.get(id_)
            if tok is None:
                return None  # unknown id: reference returns 0
            if first and len(tok) > 0 and tok[0] == 0x20:
                tok = tok[1:]
            if len(tok):
                chunks.append(tok)
                first = False  # reference strips while ActualLength == 0
        return b"".join(chunks).decode("utf-8", errors="replace")

    def set_no_dummy_prefix(self, value: bool) -> None:
        """SetNoDummyPrefix: the model, its native handle (when resolved)
        and the batch engine (rebuilt at the next batch call) all take it."""
        assert self.model.seg is not None
        self.model.seg.no_dummy_prefix = value
        if self._native:
            lib, h, _buf = self._native
            lib.SetNoDummyPrefix(ctypes.c_void_p(h), bool(value))
        self._sp = None


def load_model(path: str, i2w_path: str | None = None, **opts) -> TokenizerHandle:
    model = _load_model(path)
    if i2w_path:
        aux = _load_model(i2w_path)
        model.i2w = aux.i2w
    return TokenizerHandle(model, **opts)


# -- standalone functions --------------------------------------------------


def normalize_spaces(text: bytes | str, u_space: int = SP_DELIMITER) -> str | None:
    """NormalizeSpaces (blingfiretokdll.cpp:629-683)."""
    text = _utf8(text)
    if len(text) == 0:
        return None
    dec = utf8_to_utf32(text)
    if dec is None:
        return None
    out: list[int] = []
    for c in dec[0]:
        if not is_whitespace(c):
            out.append(c)
        elif out and out[-1] != u_space:
            out.append(u_space)
    if len(out) > 1 and out[-1] == u_space:
        out.pop()
    return "".join(chr(c) for c in out)


_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


def _fnv_hash(data: bytes) -> int:
    """FNV-1a over *signed* chars (the reference hashes `const char*`, so
    bytes >= 0x80 are sign-extended before the xor)."""
    h = 2166136261
    for b in data:
        h = ((h ^ ((b - 256 if b >= 0x80 else b) & _U32)) * 16777619) & _U32
    return h


def _sext32(v: int) -> int:
    """int32 -> uint64 via sign extension (C implicit conversion)."""
    v &= _U32
    return (v | 0xFFFFFFFF00000000) if v & 0x80000000 else v


EOS_HASH = _fnv_hash(b"</s>")


def text_to_hashes(
    text: bytes | str, word_ngrams: int, bucket_size: int = 2_000_000
) -> list[int]:
    """fastText-compatible word+ngram hashing (blingfiretokdll.cpp:686-815).

    Input must be pre-tokenized, single-space separated."""
    words = _utf8(text).split(b" ")
    # word hashes are stored as int32 (negative when bit 31 set)
    hashes = [h - (1 << 32) if h & 0x80000000 else h
              for h in (_fnv_hash(w) for w in words)]
    n = len(hashes)
    out = hashes + [0] * ((word_ngrams - 1) * n)

    for i in range(n):
        h = _sext32(out[i])
        for j in range(i + 1, i + word_ngrams):
            temp = _sext32(out[j]) if j < n else _sext32(EOS_HASH)
            h = (h * 116049371 + temp) & _U64
            out[(j - i) * n + i] = h % bucket_size
    return out
