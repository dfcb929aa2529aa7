"""Drop-in compatibility layer for the `blingfire` Python package: port of
blingfire_tpu/compat.py.

Mirrors the reference binding's function names, signatures and padding
conventions (reference dist-pypi/blingfire/__init__.py) so existing users can
`import blingfire_tpu_torch.compat as blingfire` unchanged.  The default wbd
and sbd models are looked up in $BLINGFIRE_TPU_MODELS, then in the package's
own models_data/ (the framework compiler's wbd and sbd, which the tests hold
to the reference).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from . import api

_MODEL_DIRS = [
    os.environ.get("BLINGFIRE_TPU_MODELS", ""),
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "models_data"),
]


def _find_model(name: str) -> str:
    for d in _MODEL_DIRS:
        if d and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    raise FileNotFoundError(f"model {name} not found in {_MODEL_DIRS}")


@functools.lru_cache(maxsize=8)
def _default(name: str) -> api.TokenizerHandle:
    return api.load_model(_find_model(name))


def get_blingfiretok_version() -> int:
    return api.get_version()


def text_to_sentences(s: str) -> str:
    return _default("sbd.bin").text_to_sentences(s) or ""


def text_to_sentences_with_model(h, s: str) -> str:
    return h.text_to_sentences(s) or ""


def text_to_words(s: str) -> str:
    return _default("wbd.bin").text_to_words(s) or ""


def text_to_words_with_model(h, s: str) -> str:
    return h.text_to_words(s) or ""


def text_to_words_with_offsets(s: str):
    r = _default("wbd.bin").text_to_words_with_offsets(s)
    if r is None:
        return "", []
    text, starts, ends = r
    return text, list(zip(starts, ends))


def text_to_sentences_and_offsets(s: str):
    r = _default("sbd.bin").text_to_sentences_with_offsets(s)
    if r is None:
        return "", []
    text, starts, ends = r
    return text, list(zip(starts, ends))


def normalize_spaces(s: str, uSpace: int = 0x20) -> str:
    return api.normalize_spaces(s, u_space=uSpace) or ""


def text_to_hashes(s: str, word_n_grams: int, bucketSize: int):
    r = api.text_to_hashes(s, word_n_grams, bucketSize)
    return np.array(r, dtype=np.int32) if r is not None else None


def word_hyphenation_with_model(h, s: str, uHy: int = 0x2D) -> str:
    return h.word_hyphenation(s, uhy=uHy) or ""


def load_model(file_name: str):
    h = api.load_model(file_name)
    if file_name.endswith(".i2w") and h.model.i2w is None:
        raise ValueError(f"{file_name} has no [i2w] section")
    return h


def free_model(h) -> None:
    pass  # garbage collected


def text_to_ids(h, s: str, max_len: int, unk: int = 0, no_padding: bool = False):
    ids = h.text_to_ids(s, max_len=max_len, unk_id=unk)
    out = np.zeros(max_len, dtype=np.uint32)
    out[: len(ids)] = np.asarray(ids, dtype=np.int64).astype(np.uint32)
    return out[: len(ids)] if no_padding else out


def utf8text_to_ids_with_offsets(
    h, s_bytes: bytes, max_len: int, unk: int = 0, no_padding: bool = False
):
    ids, starts, ends = h.text_to_ids_with_offsets(s_bytes, max_len=max_len, unk_id=unk)
    n = len(ids)
    o = np.zeros(max_len, dtype=np.uint32)
    o_s = np.zeros(max_len, dtype=np.int32)
    o_e = np.zeros(max_len, dtype=np.int32)
    o[:n] = np.asarray(ids, dtype=np.int64).astype(np.uint32)
    o_s[:n] = starts
    o_e[:n] = ends
    if no_padding:
        return o[:n], o_s[:n], o_e[:n]
    return o, o_s, o_e


def ids_to_text(h, ids, skip_special_tokens: bool = True, output_buffer_size=None):
    r = h.ids_to_text(ids, skip_special_tokens=skip_special_tokens)
    return r if r is not None else ""


def change_settings_dummy_prefix(h, add_prefix: bool) -> None:
    h.set_no_dummy_prefix(not add_prefix)
