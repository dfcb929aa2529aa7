# Copy of blingfire_tpu/runtime/normalize.py, kept here so that this package imports nothing of the JAX package.
"""Diacritics normalization — FAStrUtf8Normalize equivalent.

Reference: ``FAUtf8Utils.cpp:580-676`` interpreting three compiled-in
``uint16[65536][2]`` maps (``FANormalizeDiacriticsMap{Preserve,Prod,Remove}
.cxx``).  Semantics per input codepoint ``c``:

* a UTF-8 BOM at the start of the input is skipped;
* ``c >= 0xFFFF`` or no map entry: copied through unchanged;
* entry ``(c1, c2)``: emit ``c1`` if ``> 0``, then ``c2`` if ``> 0`` (so an
  entry can delete, substitute, or expand 1->2);
* invalid UTF-8 returns an error (None here).

The nontrivial map entries are recorded behavioral data (the API is defined
by its table); see ``tools/gen_unicode_data.py`` for provenance.  Exposed as
:func:`blingfire_tpu.api.normalize_text`.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..formats.consts import NormAlgo

_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "unicode_compat.npz")

_ALGO_KEY = {
    int(NormAlgo.DEFAULT): "prod",
    int(NormAlgo.PRESERVE_DIACRITICS): "preserve",
    int(NormAlgo.REMOVE_DIACRITICS): "remove",
}

_MAP_MAX = 0xFFFF  # exclusive: cps >= 0xFFFF bypass the map (FAUtf8Utils.cpp:637)


@functools.lru_cache(maxsize=None)
def _tables(key: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense (has_entry, out1, out2) tables of size ``_MAP_MAX``.

    ``has_entry[c]`` marks a nontrivial mapping; for those, emit ``out1`` if
    > 0 then ``out2`` if > 0 (0/-1 slots are dropped, matching the
    reference's "0 < c1/c2" emission guards).
    """
    has = np.zeros(_MAP_MAX, bool)
    out1 = np.arange(_MAP_MAX, dtype=np.int32)
    out2 = np.full(_MAP_MAX, -1, np.int32)
    if os.path.exists(_DATA):
        z = np.load(_DATA)
        cps = z[f"diac_{key}_cp"]
        has[cps] = True
        out1[cps] = z[f"diac_{key}_out1"]
        out2[cps] = z[f"diac_{key}_out2"]
    return has, out1, out2


def normalize_cps(cps: np.ndarray, algo: int = NormAlgo.DEFAULT) -> np.ndarray:
    """Vectorized map over an int array of codepoints; drops/expands entries."""
    key = _ALGO_KEY[int(algo)]
    has, t1, t2 = _tables(key)
    cps = np.asarray(cps, np.int32)
    inb = (cps >= 0) & (cps < _MAP_MAX)
    idx = np.clip(cps, 0, _MAP_MAX - 1)
    mapped = inb & has[idx]
    c1 = np.where(mapped, t1[idx], cps)
    c2 = np.where(mapped, t2[idx], -1)
    keep1 = ~mapped | (c1 > 0)
    keep2 = mapped & (c2 > 0)
    pairs = np.stack([c1, c2], axis=1).ravel()
    keep = np.stack([keep1, keep2], axis=1).ravel()
    return pairs[keep]


def normalize_text(text: bytes | str, algo: int = NormAlgo.DEFAULT) -> str | None:
    """FAStrUtf8Normalize (FAUtf8Utils.cpp:580-676); None on invalid UTF-8."""
    if isinstance(text, bytes):
        try:
            text = text.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if text.startswith('\ufeff'):
        text = text[1:]
    cps = np.array([ord(c) for c in text], np.int32)
    out = normalize_cps(cps, algo)
    return "".join(chr(int(c)) for c in out)
