"""A Mistral-shaped SentencePiece BPE (tokbench's ``mistral_spm_shaped``
vocabulary at about 3,000 ids: ids 0-258 reserved, runs of ▁ as pieces,
char mode, BPE_OPT with rank = id) on the port's classic doc rows:
the model is not chunk-safe, so ``SpTokenizer._route`` gives the classic
rows; ``encode_corpus_flat(device="cpu")`` equals the JAX package's
``SpTokenizer``, the native ``TextToIds`` and the benchmark's plain
reference (``tokbench/tb/reference.py``) on a seeded corpus past a window
of 128 symbols and on documents where a ▁-run piece matches; and the
classic path's sub-stages fit in their parents, its lanes hold its
symbols."""

from __future__ import annotations

import functools
import os
import sys

import pytest

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.runtime import host as jax_host
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer

TOKBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tokbench")
if TOKBENCH not in sys.path:
    sys.path.insert(0, TOKBENCH)

from tb import find, model, reference  # noqa: E402

N = 128
CFG = dict(find.data("configs", "mistral-spmbpe"), vocab_size=3000, n_cjk=20,
           max_doc_symbols=N)
# a literal ▁ run that a ▁-run piece matches: at the document's end, before
# a symbol that starts no ▁-word piece, and after a word
RUN_DOCS = ["x ▁▁", "▁▁▁▁.", "ab ▁▁▁ ,", "▁▁", "tab\t▁▁▁▁▁▁▁▁▁▁▁▁▁▁▁▁▁▁ !"]
SUB_STAGES = {"dispatch.prep": "dispatch", "collect.wait": "collect",
              "collect.rows_out": "collect", "chunk.prep": "chunk",
              "chunk.crossed": "chunk", "chunk.rows": "chunk"}


@functools.lru_cache(maxsize=1)
def _blob() -> bytes:
    return model.compile_image(CFG)


@functools.lru_cache(maxsize=1)
def _tok() -> SpTokenizer:
    return SpTokenizer(load_bytes(_blob()), max_doc_symbols=N, device="cpu")


@functools.lru_cache(maxsize=1)
def _docs() -> tuple[bytes, ...]:
    docs = testing.zipf_corpus(40_000) + [d.encode() for d in RUN_DOCS]
    return tuple(d if isinstance(d, bytes) else d.encode() for d in docs)


@functools.lru_cache(maxsize=1)
def _encoded() -> tuple[list[list[int]], metrics.Counters]:
    c = metrics.Counters()
    ids, bounds = _tok().encode_corpus_flat(list(_docs()), batch_docs=100,
                                            counters=c)
    return ([ids[bounds[i]:bounds[i + 1]].tolist()
             for i in range(len(bounds) - 1)], c)


def test_the_model_is_not_chunk_safe_and_takes_the_classic_rows():
    tok = _tok()
    entries, _cm = model.vocabulary(CFG)
    assert min(i for _c, i, _s in entries) == 259
    assert max(i for _c, i, _s in entries) == CFG["vocab_size"] - 1
    assert entries[0][0] == (0x2581, 0x2581)  # ▁▁ is the first merge
    assert tok._splittable and not tok._chunk_safe
    dispatch, collect = tok._route()
    assert dispatch == tok._classic_dispatch
    assert collect == tok._classic_collect


def test_ids_equal_jax_native_and_the_reference():
    docs = list(_docs())
    got, c = _encoded()
    ref = reference.Reference(CFG, *model.vocabulary(CFG))
    assert got == [ref.text_to_ids(d, CFG["unk_id"]) for d in docs]
    tok = _tok()
    assert got == [tok._fallback_ids(d, 0) if d else [] for d in docs]
    jtok = jax_host.SpTokenizer(jax_load_bytes(_blob()), max_doc_symbols=N)
    assert got == jtok.encode_corpus(docs, batch_docs=64)
    # documents past the window took the chunk rows, and a ▁-run piece
    # matched in the run documents
    assert c.chunked_docs > 0 and c.chunk_rows > c.chunked_docs
    runs = {i for chain, i, _s in model.vocabulary(CFG)[0]
            if len(chain) > 1 and set(chain) == {0x2581}}
    assert all(set(ids) & runs for ids in got[-len(RUN_DOCS):])


def test_the_classic_stages_fit_in_their_parents_and_lanes_hold_symbols():
    _got, c = _encoded()
    s = c.stage_seconds
    assert set(SUB_STAGES) | set(SUB_STAGES.values()) <= set(s)
    for sub, parent in SUB_STAGES.items():
        assert 0 <= s[sub] <= s[parent], sub
    for parent in set(SUB_STAGES.values()):
        assert sum(s[k] for k, p in SUB_STAGES.items() if p == parent) \
            <= s[parent]
    assert c.classic_lanes >= c.classic_symbols > 0
    assert c.classic_rows > c.chunk_rows > 0
    assert c.classic_rows == c.dispatched_rows + c.chunk_rows
    assert c.classic_lanes % 128 == 0
    d = c.as_dict()
    for k in ("classic_rows", "classic_lanes", "classic_symbols",
              "chunk_rows"):
        assert d[k] == getattr(c, k)


@pytest.mark.parametrize("doc", RUN_DOCS)
def test_a_run_document_alone(doc):
    """One document a call, on a row of its own (the card may flag the
    row, and the native runtime then answers)."""
    tok = _tok()
    ref = reference.Reference(CFG, *model.vocabulary(CFG))
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat([doc.encode()], counters=c)
    assert ids.tolist() == ref.text_to_ids(doc.encode(), 0)
    assert c.oracle_docs == 0 and c.classic_rows == 1
