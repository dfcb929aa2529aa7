"""A configuration's vocabulary and its compiled model image.

The benchmark makes the vocabulary entries from the configuration's fixed
seed (``vocabs/<vocab>.py``) and hands the same entries to both sides: the
program compiles them into its ``.bin`` image with its own compiler, the
reference (tb/reference.py) reads them as they are.  The image is compiled
at the first run in a checkout and kept at a fixed path under
``tokbench/.cache/models/``, named by the configuration and a hash of
everything that builds it: the configuration's file, the vocabulary
builder, the traffic generator it draws words from, and the program's
compiler and format sources."""

from __future__ import annotations

import glob
import hashlib
import os

from tb import find

CACHE = os.path.join(find.ROOT, ".cache")


def vocabulary(cfg: dict):
    """(entries, charmap) of a configuration."""
    vocab = find.module("vocabs", cfg["vocab"])
    return vocab.entries(cfg), vocab.charmap(cfg)


def image_key(cfg_name: str, cfg: dict) -> str:
    pkg = os.path.join(find.REPO, "blingfire_tpu_torch")
    files = [find.path("configs", cfg_name, ".json"),
             find.path("vocabs", cfg["vocab"], ".py"),
             os.path.join(find.ROOT, "tb", "corpus.py")]
    files += sorted(glob.glob(os.path.join(pkg, "compiler", "*.py")))
    files += sorted(glob.glob(os.path.join(pkg, "formats", "*.py")))
    h = hashlib.sha1()
    for p in files:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def compile_image(cfg: dict) -> bytes:
    """The program's compiler over the configuration's entries."""
    from blingfire_tpu_torch.compiler.dict import (DictModelSpec, VocabEntry,
                                                   compile_dict_model)
    from blingfire_tpu_torch.formats.consts import TokAlgo

    entries, charmap = vocabulary(cfg)
    algo = {"BPE_OPT": TokAlgo.BPE_OPT, "UNIGRAM": TokAlgo.DEFAULT}
    spec = DictModelSpec(
        entries=[VocabEntry(c, i, s) for c, i, s in entries],
        tok_algo=algo[cfg["tok_algo"]],
        id_offset=int(cfg["id_offset"]),
        use_byte_encoding=bool(cfg["use_byte_encoding"]),
        no_dummy_prefix=bool(cfg["no_dummy_prefix"]),
        charmap=charmap,
    )
    return compile_dict_model(spec)


def image_path(cfg_name: str, cfg: dict) -> tuple[str, bool]:
    """(path of the configuration's image, whether this call compiled it)."""
    d = os.path.join(CACHE, "models")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, f"{cfg_name}.{image_key(cfg_name, cfg)}.bin")
    if os.path.exists(p):
        return p, False
    tmp = f"{p}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(compile_image(cfg))
    os.replace(tmp, p)
    return p, True
