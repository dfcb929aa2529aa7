"""The port's stages and counters (runtime/metrics.py) on the corpus path,
SpTokenizer(..., device="cpu").encode_corpus_flat, of a seeded gpt2-shaped
byte-BPE model with the kernels' plain versions: every stage is entered
where its work happens, the sub-stages fit in their parents, the fallback's
bytes and the flagged device rows are counted, the ids do not change, and a
stage opens a profiler range only while a profile records."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer

# documents the card's pass flags: a run of one long character walks region
# B of the unit rows to its depth cap (tests/test_torch_host.py)
FLAGGED = [b"see " + bytes([ch]) * k + b" end"
           for ch in testing.LONG_CHARS[:3] for k in (18, 40, 200)]
SUB_STAGES = {"dispatch.analyze": "dispatch", "collect.wait": "collect",
              "collect.stitch": "collect", "fallback.native": "fallback"}


@functools.lru_cache(maxsize=None)
def _tok(a_max: int | None = None, window: int = 128) -> SpTokenizer:
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    return SpTokenizer(load_bytes(blob), max_doc_symbols=window, a_max=a_max,
                       device="cpu")


@functools.lru_cache(maxsize=None)
def _plain_docs() -> tuple[bytes, ...]:
    return tuple(testing.zipf_corpus(12_000))


def _docs() -> list[bytes]:
    return list(_plain_docs()) + FLAGGED + [b""]


def _native_ids(tok, docs):
    return [tok._fallback_ids(d, 0) if d else [] for d in docs]


def _lists(ids, bounds):
    return [ids[bounds[i]:bounds[i + 1]].tolist()
            for i in range(len(bounds) - 1)]


def test_corpus_path_enters_every_stage_inside_its_parent():
    tok = _tok()
    docs = _docs()
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=16, counters=c)
    assert _lists(ids, bounds) == _native_ids(tok, docs)
    s = c.stage_seconds
    assert {"dispatch", "collect", "fallback", "call.split",
            "call.join"} | set(SUB_STAGES) <= set(s)
    assert c.batches > 1 and c.fallback_docs > 0
    for parent in set(SUB_STAGES.values()):
        assert sum(s[k] for k, p in SUB_STAGES.items() if p == parent) \
            <= s[parent]
    assert c.as_dict()["stage_seconds"] == dict(s)


def test_fallback_bytes_are_the_patched_documents_bytes(monkeypatch):
    tok = _tok()
    patched = []
    orig = tok._fallback_native

    def spy(d, unk_id, c=None):
        patched.append(d)
        return orig(d, unk_id, c)
    monkeypatch.setattr(tok, "_fallback_native", spy)
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(_docs(), batch_docs=16, counters=c)
    assert patched and c.fallback_docs == len(patched)
    assert c.fallback_bytes == sum(map(len, patched))
    assert set(FLAGGED) <= set(patched)
    assert c.invalid_docs == 1  # the empty document is no fallback
    d = c.as_dict()
    assert (d["fallback_bytes"], d["flagged_rows"]) == (c.fallback_bytes,
                                                        c.flagged_rows)


@pytest.mark.parametrize("flagged", [False, True])
def test_flagged_rows_count_the_rows_the_card_flags(flagged):
    tok = _tok()
    docs = list(_plain_docs()) + (FLAGGED if flagged else [])
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=16, counters=c)
    assert _lists(ids, bounds) == _native_ids(tok, docs)
    # a document past the window goes to the fallback too, with no row
    # flagged
    assert (c.flagged_rows >= 1) == flagged


@pytest.mark.parametrize("route", ["classic", "numpy_units"])
def test_flagged_rows_of_the_other_routes(route):
    """The classic doc rows (``fb`` of ``_rows_out``) and the NumPy unit
    path (``row_fb``) count their flagged rows too: an arc budget of 16 a
    row flags every row with more arcs."""
    tok = _tok(a_max=16, window=2048 if route == "numpy_units" else 128)
    assert tok._native_units_ok() == (route == "classic")
    docs = list(_plain_docs()[:12])
    c = metrics.global_counters()
    before = (c.flagged_rows, c.fallback_docs, c.fallback_bytes)
    got = tok.encode_batch(docs, dedup=False if route == "classic" else None)
    assert got == _native_ids(tok, docs)
    assert c.flagged_rows - before[0] >= 1
    assert c.fallback_docs - before[1] >= 1
    assert c.fallback_bytes - before[2] >= c.fallback_docs - before[1]


def test_without_a_profile_a_stage_opens_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profile")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    tok = _tok()
    docs = _docs()
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=16, counters=c)
    assert tok.encode_batch(docs) == _lists(ids, bounds)
    assert c.stage_seconds["dispatch.analyze"] > 0


def test_a_stage_is_a_profiler_range_while_a_profile_records():
    from torch.profiler import ProfilerActivity, profile

    c = metrics.Counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.stage("outer", c):
            with metrics.stage("outer.inner", c):
                torch.zeros(4).add_(1)
    with metrics.stage("after", c):
        pass
    spans = {e.name: e.time_range for e in prof.events()
             if e.name.startswith("stage.")}
    assert set(spans) == {"stage.outer", "stage.outer.inner"}
    outer, inner = spans["stage.outer"], spans["stage.outer.inner"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert set(c.stage_seconds) == {"outer", "outer.inner", "after"}
    assert c.stage_seconds["outer.inner"] <= c.stage_seconds["outer"]
    assert np.isfinite(c.stage_seconds["after"])
