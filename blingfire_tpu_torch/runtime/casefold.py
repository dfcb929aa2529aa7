# Copy of blingfire_tpu/runtime/casefold.py, kept here so that this package imports nothing of the JAX package.
"""Full-Unicode case folding, bit-exact with the reference client library.

Reference: ``FAUtf32Utils.cpp:45-176`` (``FAUtf32ToLower/ToUpper/IsLower/
IsUpper/StrLower/StrUpper``) backed by machine-generated nested page tables
(``FAUtf32ToLower.cpp``/``FAUtf32ToUpper.cpp``).  Engines consult it only when
a model sets ``ignore-case`` (reference ``FALexTools_t.h:263``,
``FAHyphInterpreter_core_t.h:169``, ``FADictInterpreter_t.h:235``).

Semantics being reproduced (NOT a table copy — see
``tools/gen_unicode_data.py`` for how the compat delta is produced):

* codepoints <= 0xFF take a hard-coded fast path that never consults the
  table: ``[0x41,0x5A] | [0xC0,0xDE] -> +0x20`` for lowering (this range
  includes U+00D7 MULTIPLICATION SIGN, so x lowers to / -- a reference quirk
  kept for parity) and ``[0x61,0x7A] | [0xE0,0xFE] -> -0x20`` plus
  ``0xB5 -> 0x39C`` for uppering.
* codepoints in (0xFF, 0x1FFFF] go through a 1:1 simple-mapping table; we
  build it from :mod:`unicodedata` and patch the recorded deviations (the
  reference tables predate Unicode 15).
* codepoints > 0x1FFFF are returned unchanged (``FAUtf32Utils.cpp:53,68``).
* ``IsLower(c)`` is defined as "the ToUpper table has an entry for c" (and
  the fast-path set below 0x100), not as a Unicode category test
  (``FAUtf32Utils.cpp:112-140``); likewise ``IsUpper`` via the ToLower table.
"""

from __future__ import annotations

import functools
import os

import numpy as np

CASE_MAX = 0x20000  # exclusive; reference tables cover <= 0x1FFFF

_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "unicode_compat.npz")


def _base_tolower() -> np.ndarray:
    """unicodedata-derived base table (before compat deltas)."""
    t = np.arange(CASE_MAX, dtype=np.int32)
    # fast path below 0x100: the table is never consulted there
    t[0x41:0x5B] += 0x20
    t[0xC0:0xDF] += 0x20
    for cp in range(0x100, CASE_MAX):
        low = chr(cp).lower()
        if len(low) == 1 and ord(low) != cp:
            t[cp] = ord(low)
    return t


def _base_toupper() -> np.ndarray:
    t = np.arange(CASE_MAX, dtype=np.int32)
    t[0x61:0x7B] -= 0x20
    t[0xE0:0xFF] -= 0x20
    t[0xB5] = 0x39C
    for cp in range(0x100, CASE_MAX):
        up = chr(cp).upper()
        if len(up) == 1 and ord(up) != cp:
            t[cp] = ord(up)
    return t


@functools.lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    lower = _base_tolower()
    upper = _base_toupper()
    if os.path.exists(_DATA):
        z = np.load(_DATA)
        lower[z["lower_delta_cp"]] = z["lower_delta_out"]
        upper[z["upper_delta_cp"]] = z["upper_delta_out"]
    return lower, upper


def tolower_table() -> np.ndarray:
    """Dense int32 ``cp -> lower(cp)`` table of size ``CASE_MAX``."""
    return _tables()[0]


def toupper_table() -> np.ndarray:
    return _tables()[1]


def to_lower(cp: int) -> int:
    return int(_tables()[0][cp]) if 0 <= cp < CASE_MAX else cp


def to_upper(cp: int) -> int:
    return int(_tables()[1][cp]) if 0 <= cp < CASE_MAX else cp


def is_lower(cp: int) -> bool:
    if cp <= 0xFF:
        return (0x61 <= cp <= 0x7A) or (0xE0 <= cp <= 0xFE) or cp == 0xB5
    if cp < CASE_MAX:
        return int(_tables()[1][cp]) != cp
    return False


def is_upper(cp: int) -> bool:
    if cp <= 0xFF:
        return (0x41 <= cp <= 0x5A) or (0xC0 <= cp <= 0xDE)
    if cp < CASE_MAX:
        return int(_tables()[0][cp]) != cp
    return False


def str_lower(arr: np.ndarray) -> np.ndarray:
    """Vectorized ``FAUtf32StrLower``: fold an int array of codepoints."""
    arr = np.asarray(arr)
    table = _tables()[0]
    inb = (arr >= 0) & (arr < CASE_MAX)
    return np.where(inb, table[np.clip(arr, 0, CASE_MAX - 1)], arr).astype(arr.dtype)


def str_upper(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    table = _tables()[1]
    inb = (arr >= 0) & (arr < CASE_MAX)
    return np.where(inb, table[np.clip(arr, 0, CASE_MAX - 1)], arr).astype(arr.dtype)
