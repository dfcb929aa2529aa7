# Copy of blingfire_tpu/native/__init__.py (get_lib, prep_sp_batch,
# NativeUnits, UnitCache, units_analyze, get_runtime).  Both libraries are
# built from the copies of prep.cpp and runtime.cpp in this directory, at
# first use, into build/blingfire_tpu_torch/native/.
"""ctypes bindings for the native host library (prep, unit dedup, stitch)
and the native runtime (the reference-compatible C ABI: TextToIds and its
family, WordHyphenationWithModel, and the WordPiece hybrid's level-0 scan,
intern and stitch).

A failed build raises: there is no NumPy fallback."""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from ..buildutil import build_all, build_dir, source_tag

_DIR = os.path.dirname(os.path.abspath(__file__))
_lib = None
_rt = None
_lock = threading.Lock()


def lib_path() -> str:
    src = os.path.join(_DIR, "prep.cpp")
    mk = os.path.join(_DIR, "Makefile")
    return os.path.join(build_dir("native"),
                        f"libbtl_host.{source_tag(src, mk)}.so")


def build_job():
    """(out_path, argv_of) for buildutil.build_all."""
    return lib_path(), lambda tmp: ["make", "-s", "-C", _DIR, f"OUT={tmp}"]


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            out, argv_of = build_job()
            build_all([(out, argv_of)])
            lib = ctypes.cdll.LoadLibrary(out)
            lib.btl_version.restype = ctypes.c_int
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.btl_prep_sp_batch.restype = I
            lib.btl_prep_sp_batch.argtypes = [
                ctypes.c_char_p, P, I, I, I, P, P, I, I, I, P, ctypes.c_int64,
                I, P, P, P, P, P,
            ]
            lib.btl_units_analyze_c.restype = ctypes.c_void_p
            lib.btl_units_analyze_c.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.btl_ucache_new.restype = ctypes.c_void_p
            lib.btl_ucache_new.argtypes = []
            lib.btl_ucache_free.restype = None
            lib.btl_ucache_free.argtypes = [ctypes.c_void_p]
            lib.btl_ucache_stats.restype = None
            lib.btl_ucache_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.btl_units_emit.restype = None
            lib.btl_units_emit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_void_p]
            lib.btl_units_stitch_m.restype = ctypes.c_int64
            lib.btl_units_stitch_m.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.btl_units_free.restype = None
            lib.btl_units_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _charmap_args(charmap):
    """(counts, values, width, min_key, max_key) of a loader.CharMap for
    the C entry points, with the arrays kept alive by the caller."""
    if charmap is None:
        return None, None, 0, 0, 0
    return (np.ascontiguousarray(charmap.counts, np.int32),
            np.ascontiguousarray(charmap.values, np.int32),
            charmap.values.shape[1], charmap.min_key, charmap.max_key)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def prep_sp_batch(
    docs: list[bytes],
    n_sym: int,
    sym2iw: np.ndarray,
    use_raw_bytes: bool,
    no_dummy_prefix: bool,
    charmap=None,  # loader.CharMap or None
):
    """Native prep of a batch of documents into doc rows (prep.cpp
    btl_prep_sp_batch; JAX native/__init__.py:75-130): decode, dummy
    prefix, charmap, whitespace squeeze, dense input weights.

    Returns (x_iw int32 (B, n_sym), -1 past the length; is_spm bool (B,
    n_sym), the raw symbol is ▁; lengths int32 (B,); status uint8 (B,): 0
    ok, 1 invalid input, 2 over n_sym symbols; rows of status 1 and 2 are
    empty)."""
    lib = get_lib()
    B = len(docs)
    blob = b"".join(docs)
    doc_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=doc_off[1:])
    x = np.empty((B, n_sym), np.int32)
    spm = np.empty((B, n_sym), np.uint8)
    lengths = np.empty(B, np.int32)
    status = np.empty(B, np.uint8)
    sym2iw = np.ascontiguousarray(sym2iw, np.int32)
    cc, cv, cm_width, cm_min, cm_max = _charmap_args(charmap)
    rc = lib.btl_prep_sp_batch(
        ctypes.c_char_p(blob), _ptr(doc_off), B, int(use_raw_bytes),
        int(no_dummy_prefix), _ptr(cc), _ptr(cv), cm_width, cm_min, cm_max,
        _ptr(sym2iw), len(sym2iw), n_sym, _ptr(x), _ptr(spm), _ptr(lengths),
        None, _ptr(status),
    )
    assert rc == 0, "btl_prep_sp_batch failed"
    return x, spm.astype(bool), lengths, status


class NativeUnits:
    """One batch's unique-unit decomposition held in native state.

    Produced by :func:`units_analyze`; ``px``/``plen``/``status`` are the
    device inputs, :meth:`stitch` consumes the device's packed output rows
    and returns (flat_ids, bounds, need_fb), and counts the rows the device
    flagged (``flagged_rows``) and the units it made resolved-fallback
    (``fallback_units``).  The native state is freed by stitch (or by
    GC)."""

    def __init__(self, handle, n_docs: int, n_sym: int, counts):
        self._handle = handle
        self.n_docs = n_docs
        self.n_sym = n_sym
        self.n_units = int(counts[0])
        self.n_instances = int(counts[1])
        self.n_rows = int(counts[2])
        self.total_syms = int(counts[3])
        # rows [0, split_rows1) hold only SPM-initial units <= 8 symbols,
        # rows [split_rows1, split_rows) units of 9..16 symbols (prep.cpp
        # BTL_LW1/BTL_LW2); the device walks each region at its class depth
        self.split_rows = int(counts[4])
        self.split_rows1 = int(counts[5])
        # units packed into THIS batch's rows (the cross-batch cache-miss
        # count when a cache is shared)
        self.n_local = int(counts[6])
        # set by stitch: rows flagged whole or holding a marked lane, and
        # the units resolved-fallback
        self.flagged_rows = 0
        self.fallback_units = 0
        lib = get_lib()
        self.px = np.empty((max(self.n_rows, 1), n_sym), np.int32)
        self.plen = np.zeros(max(self.n_rows, 1), np.int32)
        self.status = np.empty(n_docs, np.uint8)
        lib.btl_units_emit(
            handle,
            self.px.ctypes.data_as(ctypes.c_void_p),
            self.plen.ctypes.data_as(ctypes.c_void_p),
            self.status.ctypes.data_as(ctypes.c_void_p),
        )

    def stitch(self, rows: np.ndarray, shift: int,
               row_map: np.ndarray | None = None):
        """rows: (rows_n, n_sym+2) int32 packed device output: lanes
        ``(id + 1) | (start << shift)``, bit 31 K2's mark of the token
        (prep.cpp btl_units_stitch_m), then the count and the row's flag.
        row_map maps packed row r -> its row index in ``rows`` (None =
        identity).  Returns (ids int32 (T,), bounds int64 (n_docs+1,),
        need_fb bool (n_docs,)): a unit with a marked lane, or in a flagged
        row, takes the documents that hold it to the fallback."""
        assert self._handle is not None, "stitch called twice"
        assert rows.dtype == np.int32 and rows.shape[1] == self.n_sym + 2
        rows = np.ascontiguousarray(rows)
        if row_map is not None:
            row_map = np.ascontiguousarray(row_map, np.int32)
            assert len(row_map) >= self.n_rows
        lib = get_lib()
        cap = self.total_syms + 16
        out_ids = np.empty(cap, np.int32)
        bounds = np.empty(self.n_docs + 1, np.int64)
        need = np.empty(self.n_docs, np.uint8)
        stats = np.zeros(2, np.int64)
        t = lib.btl_units_stitch_m(
            self._handle,
            rows.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(rows.shape[0]),
            row_map.ctypes.data_as(ctypes.c_void_p)
            if row_map is not None else None,
            ctypes.c_int(shift),
            out_ids.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(cap),
            bounds.ctypes.data_as(ctypes.c_void_p),
            need.ctypes.data_as(ctypes.c_void_p),
            stats.ctypes.data_as(ctypes.c_void_p),
        )
        self.flagged_rows, self.fallback_units = int(stats[0]), int(stats[1])
        self.close()
        assert t >= 0, "stitch capacity exceeded (total_syms bound violated)"
        return out_ids[:t], bounds, need.astype(bool)

    def close(self):
        if self._handle is not None:
            get_lib().btl_units_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UnitCache:
    """Cross-batch unit->ids cache (prep.cpp::BtlUnitCache).

    Pass to :func:`units_analyze` to make the unique-unit dedup CUMULATIVE
    over a corpus: a batch only packs units never resolved before; the
    stitch stores fresh resolutions and reads recurring units straight from
    the cache.  Batches sharing a cache must be stitched in dispatch order
    (encode_corpus_flat's in-order pipeline guarantees this)."""

    def __init__(self):
        self._handle = get_lib().btl_ucache_new()

    def stats(self) -> dict:
        s = np.zeros(4, np.int64)
        get_lib().btl_ucache_stats(self._handle,
                                   s.ctypes.data_as(ctypes.c_void_p))
        return {"units": int(s[0]), "resolved": int(s[1]),
                "arena_ids": int(s[2]), "bytes": int(s[3])}

    def close(self):
        if self._handle is not None:
            get_lib().btl_ucache_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def units_analyze(
    docs: list[bytes],
    n_sym: int,
    sym2iw: np.ndarray,
    spm_iw: int,
    use_raw_bytes: bool,
    no_dummy_prefix: bool,
    charmap=None,
    cache: UnitCache | None = None,
) -> NativeUnits:
    """Full native prep -> unit split -> dedup -> dense packing for a batch."""
    lib = get_lib()
    B = len(docs)
    blob = b"".join(docs)
    doc_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=doc_off[1:])
    sym2iw = np.ascontiguousarray(sym2iw, np.int32)
    cm_counts, cm_values, cm_width, cm_min, cm_max = _charmap_args(charmap)
    cc, cv = _ptr(cm_counts), _ptr(cm_values)
    counts = np.zeros(7, np.int64)
    handle = lib.btl_units_analyze_c(
        cache._handle if cache is not None else None,
        ctypes.c_char_p(blob),
        doc_off.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(B),
        ctypes.c_int(1 if use_raw_bytes else 0),
        ctypes.c_int(1 if no_dummy_prefix else 0),
        cc,
        cv,
        ctypes.c_int(cm_width),
        ctypes.c_int(cm_min),
        ctypes.c_int(cm_max),
        sym2iw.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(sym2iw)),
        ctypes.c_int(int(spm_iw)),
        ctypes.c_int(n_sym),
        counts.ctypes.data_as(ctypes.c_void_p),
    )
    assert handle, "btl_units_analyze failed"
    nu = NativeUnits(handle, B, n_sym, counts)
    nu._cache_ref = cache  # keep the cache alive while the state lives
    return nu


# -- full native host runtime (libbtf_runtime, reference-compatible C ABI) --


def _runtime_tag() -> str:
    srcs = [os.path.join(_DIR, f) for f in
            ("runtime.cpp", "gen_default_models.py", "Makefile")]
    srcs += [os.path.join(_DIR, "..", "models_data", f"{m}.bin")
             for m in ("wbd", "sbd")]
    return source_tag(*srcs)


def runtime_lib_path() -> str:
    return os.path.join(build_dir("native"),
                        f"libbtf_runtime.{_runtime_tag()}.so")


def runtime_build_job():
    """(out_path, argv_of) for buildutil.build_all: generates the default
    models' source beside the library (the generator replaces it
    atomically), then compiles runtime.cpp with it."""
    gen = os.path.join(build_dir("native"),
                       f"default_models.{_runtime_tag()}.cxx")
    return runtime_lib_path(), lambda tmp: [
        "make", "-s", "-C", _DIR, "runtime", f"RT_OUT={tmp}", f"GEN={gen}",
        f"PYTHON={sys.executable}",
    ]


def _bind_wp(lib) -> None:
    """Signatures of the WordPiece hybrid's entry points (runtime.cpp
    BtlWp*; runtime/wp_hybrid.py)."""
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "BtlWpAnalyzeC": (P, [P, P, ctypes.c_char_p, P, I, I, P]),
        "BtlWpCacheNew": (P, []),
        "BtlWpCacheFree": (None, [P]),
        "BtlWpCacheStats": (None, [P, P]),
        "BtlWpUnits": (None, [P, P, P, P]),
        "BtlWpStitch": (I64, [P, P, I64, I, P, P, I, P, I64, P, P]),
        "BtlWpFree": (None, [P]),
    }
    for name, (res, args) in sigs.items():
        f = getattr(lib, name)
        f.restype = res
        f.argtypes = args


def _bind_api(lib) -> None:
    """Signatures of the entry points api.py calls besides TextToIds and
    WordHyphenationWithModel (runtime.cpp, the reference's C ABI)."""
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    sigs = {
        "TextToIdsWithOffsets": [P, S, I, P, P, P, I, I],
        "TextToWordsWithModel": [S, I, S, I, P],
        "TextToSentencesWithModel": [S, I, S, I, P],
        "TextToWordsWithOffsetsWithModel": [S, I, S, P, P, I, P],
        "TextToSentencesWithOffsetsWithModel": [S, I, S, P, P, I, P],
        "TextToHashes": [S, I, P, I, I, I],
    }
    for name, args in sigs.items():
        f = getattr(lib, name)
        f.restype = I
        f.argtypes = args


def get_runtime():
    """ctypes handle to the native C-ABI runtime (TextToIds/Words/... family).

    Builds it at first use from runtime.cpp, installs the full-Unicode
    casefold table (runtime.cpp SetCaseFoldTable) and returns the loaded
    library.  A failed build raises."""
    global _rt
    with _lock:
        if _rt is None:
            out, argv_of = runtime_build_job()
            build_all([(out, argv_of)])
            lib = ctypes.cdll.LoadLibrary(out)
            lib.LoadModel.restype = ctypes.c_void_p
            lib.LoadModel.argtypes = [ctypes.c_char_p]
            lib.SetModel.restype = ctypes.c_void_p
            lib.SetModel.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.FreeModel.restype = ctypes.c_int
            lib.FreeModel.argtypes = [ctypes.c_void_p]
            lib.SetNoDummyPrefix.restype = ctypes.c_int
            lib.SetNoDummyPrefix.argtypes = [ctypes.c_void_p, ctypes.c_bool]
            lib.TextToIds.restype = ctypes.c_int
            lib.TextToIds.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            _bind_wp(lib)
            for name in ("TextToWords", "TextToSentences"):
                f = getattr(lib, name)
                f.restype = ctypes.c_int
                f.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_int]
            lib.WordHyphenationWithModel.restype = ctypes.c_int
            lib.WordHyphenationWithModel.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int,
            ]
            _bind_api(lib)
            lib.SetCaseFoldTable.restype = None
            lib.SetCaseFoldTable.argtypes = [ctypes.c_void_p, ctypes.c_int]
            from ..runtime.casefold import tolower_table

            table = np.ascontiguousarray(tolower_table(), dtype=np.int32)
            lib.SetCaseFoldTable(table.ctypes.data_as(ctypes.c_void_p),
                                 len(table))
            lib._casefold_table = table  # keep the buffer alive
            _rt = lib
    return _rt


def text_to_words(data: bytes, sentences: bool = False) -> str | None:
    """The native runtime's TextToWords (TextToSentences with
    ``sentences``) with its compiled-in wbd (sbd) model: the words joined by
    spaces (the sentences by newlines), or None for input it rejects."""
    rt = get_runtime()
    fn = rt.TextToSentences if sentences else rt.TextToWords
    cap = 4 * len(data) + 64
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = fn(data, len(data), buf, cap)
        if n <= cap:
            break
        cap = n
    if n < 0:
        return None
    return buf.raw[: max(n - 1, 0)].decode("utf-8")


def set_model(image: bytes) -> int:
    """A native runtime handle (SetModel, which copies the image) of a
    ``.bin`` image; raises when the runtime rejects it.  Free it with
    ``get_runtime().FreeModel``."""
    h = get_runtime().SetModel(image, len(image))
    if not h:
        raise ValueError("the native runtime rejected the model image")
    return h


def word_hyphenation(handle: int, word: bytes | str,
                     hyphen: int = 0x2012) -> str | None:
    """The native runtime's WordHyphenationWithModel of one UTF-8 word with
    the [w2h] model of ``handle`` (:func:`set_model`): the word with
    ``hyphen`` after each hyphenation point, or None for input it rejects.
    It reads NUL as a space and cuts a word to its first 300 code points
    (runtime.cpp WordHyphenationWithModel)."""
    data = word.encode("utf-8") if isinstance(word, str) else word
    cap = 4 * len(data) + 64
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = get_runtime().WordHyphenationWithModel(
            data, len(data), buf, cap, ctypes.c_void_p(handle), hyphen)
        if n <= cap:
            break
        cap = n
    if n < 0:
        return None
    return buf.raw[: max(n - 1, 0)].decode("utf-8")
