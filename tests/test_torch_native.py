"""The port's copy of the native host library (blingfire_tpu_torch/native)
against blingfire_tpu.native on the same documents: unit analysis (packed
rows, regions, statuses, counts) and the stitch of the same device rows,
with and without a unit cache shared across batches; and the port's stitch
of marked rows, which sends the overflowing unit alone to the fallback where
the JAX package's stitch sends its whole row, and keeps the row's other
units in the unit cache."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu import native as jax_native
from blingfire_tpu_torch import native, testing
from blingfire_tpu_torch.formats.consts import SP_DELIMITER
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime import dedup, metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer

N = 128


def _tok():
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    return SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")


def _docs():
    docs = [d.encode("utf-8") for d in full_corpus()]
    docs += [b"", b"\xff\xfe bad utf8 is fine in byte mode", b"x" * 300]
    return docs


def _device_rows(tok, nu, mark: bool = False):
    """Packed device rows for a NativeUnits batch, from the port's plain
    kernels region by region; ``mark``: with K2's marks, as
    UnitRunner.dispatch_docs computes them."""
    runner = tok._unit_runner()
    R = nu.n_rows
    out = torch.zeros((R, N + 2), dtype=torch.int32)
    x = torch.from_numpy(nu.px[:R].copy())
    ln = torch.from_numpy(nu.plen[:R].copy())
    for lo, hi, lw, bounded in ((0, nu.split_rows1, 8, True),
                                (nu.split_rows1, nu.split_rows, 16, True),
                                (nu.split_rows, R, 16, False)):
        if hi > lo:
            ids, st, counts, fb = runner._kernel(
                x[lo:hi], ln[lo:hi], 0, lw=lw, bounded=bounded, mark=mark)
            out[lo:hi] = dedup.pack_out_compact(ids, st, counts, fb)
    return out.numpy()


def _analyze(mod, tok, docs, cache):
    spm_iw = int(tok._sym2iw[SP_DELIMITER])
    return mod.units_analyze(docs, N, tok._sym2iw, spm_iw, True, False, None,
                             cache=cache)


def _match_jax_native(tok, batches, shared_cache: bool):
    """Each batch analysed by both libraries (with a cache shared across
    the batches, or none) gives the same rows, regions, statuses and
    counts, and the stitch of the same device rows the same ids."""
    caches = ((jax_native.UnitCache(), native.UnitCache()) if shared_cache
              else (None, None))
    for batch in batches:
        nj = _analyze(jax_native, tok, batch, caches[0])
        npt = _analyze(native, tok, batch, caches[1])
        for attr in ("n_units", "n_instances", "n_rows", "total_syms",
                     "split_rows", "split_rows1", "n_local"):
            assert getattr(npt, attr) == getattr(nj, attr), attr
        np.testing.assert_array_equal(npt.px, nj.px)
        np.testing.assert_array_equal(npt.plen, nj.plen)
        np.testing.assert_array_equal(npt.status, nj.status)
        assert npt.n_rows > 0 and (npt.status != 0).any()
        rows = _device_rows(tok, npt)
        ids_j, bounds_j, need_j = nj.stitch(rows, dedup.ID_SHIFT)
        ids_p, bounds_p, need_p = npt.stitch(rows, dedup.ID_SHIFT)
        np.testing.assert_array_equal(ids_p, ids_j)
        np.testing.assert_array_equal(bounds_p, bounds_j)
        np.testing.assert_array_equal(need_p, need_j)
    if shared_cache:
        assert caches[1].stats() == caches[0].stats()


@pytest.mark.parametrize("shared_cache", [False, True],
                         ids=["per_batch", "shared_cache"])
def test_units_analyze_and_stitch_match_jax_native(shared_cache):
    docs = _docs()
    _match_jax_native(_tok(), [docs[: len(docs) // 2], docs[len(docs) // 3 :]],
                      shared_cache)


def _threaded_docs(n_docs: int, first: int = 0) -> list[bytes]:
    """Documents ``first`` to ``first + n_docs`` of 1.1-1.6 KB of Zipfian
    text, past the threaded scan's 64 documents and 64 KiB, with an empty
    document (status 1) in the middle, a long run and a unit wider than the
    window (status 2) last."""
    text = b" ".join(testing.zipf_corpus(4_400_000)[len(testing.EDGE_CASES):])
    docs, at = [], 0
    for i in range(first + n_docs):
        n = 1100 + (i * 37) % 500
        if i >= first:
            docs.append(text[at : at + n] + b" %d" % i)
        at += n
    docs[n_docs // 2] = b""
    docs[n_docs // 3] = RUN_DOC
    docs[-1] = b"z" * 600
    return docs


@pytest.mark.parametrize("n_docs", [64, 65, 130, 1200])
def test_threaded_analyze_matches_jax_native(n_docs):
    """The threaded scan (each thread a fixed share of the batch, merged in
    doc order) at the thread threshold and past it: rows, statuses and the
    stitch equal the JAX package's library on two batches of ``n_docs``
    that share a cache and 16 documents."""
    batches = [_threaded_docs(n_docs), _threaded_docs(n_docs, n_docs - 16)]
    assert all(sum(map(len, b)) >= 64 << 10 for b in batches)
    _match_jax_native(_tok(), batches, True)


def test_native_library_builds_under_build_dir():
    path = native.lib_path()
    native.get_lib()
    assert "build" in path.split("/") and path.endswith(".so")
    assert native.get_lib().btl_version() == 1000


# one region-B row: a run of "-" past the depth-16 walk beside rare long
# words, each word in a document of its own; the last document's one unit
# is wider than the window (status 2)
RUN_DOC = b"see " + b"-" * 20 + b" end"
WORD_DOCS = [b"an internationalization", b"the counterrevolutionary",
             b"one electroencephalogram", b"so uncharacteristically"]
FLAG_BATCH = [RUN_DOC] + WORD_DOCS + [b"x" * 300]


def _native_ids(tok, docs):
    return [tok._fallback_ids(d, 0) if d else [] for d in docs]


def test_stitch_sends_only_the_run_unit_to_the_fallback():
    tok = _tok()
    nj = _analyze(jax_native, tok, FLAG_BATCH, None)
    npt = _analyze(native, tok, FLAG_BATCH, None)
    assert npt.n_rows - npt.split_rows == 1  # the run and the words share it
    ids_j, bounds_j, need_j = nj.stitch(_device_rows(tok, npt),
                                        dedup.ID_SHIFT)
    rows = _device_rows(tok, npt, mark=True)
    assert rows[-1, -1] == 0 and (rows[-1, :N] < 0).any()
    ids_p, bounds_p, need_p = npt.stitch(rows, dedup.ID_SHIFT)
    # unmarked, the row sends every document of it; marked, the run's alone
    assert need_j.tolist() == [True] * len(FLAG_BATCH)
    assert need_p.tolist() == [True] + [False] * len(WORD_DOCS) + [True]
    assert npt.status.tolist()[-1] == 2
    assert not (need_p & ~need_j).any()
    assert (npt.flagged_rows, npt.fallback_units) == (1, 1)
    want = _native_ids(tok, FLAG_BATCH)
    for i in np.flatnonzero(~need_p):
        assert ids_p[bounds_p[i]:bounds_p[i + 1]].tolist() == want[i]


def test_corpus_flat_with_marked_rows_matches_the_native_runtime():
    tok = _tok()
    docs = _docs() + FLAG_BATCH
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=32, counters=c)
    assert [ids[bounds[i]:bounds[i + 1]].tolist()
            for i in range(len(docs))] == _native_ids(tok, docs)
    assert c.flagged_rows >= 1 and c.fallback_units >= 1
    # the word documents of the run's row took no fallback: the fallback
    # holds the run's document, the documents past the window and those
    # of other flagged units
    fb = metrics.Counters()
    tok.encode_corpus_flat(FLAG_BATCH, counters=fb)
    assert (fb.fallback_docs, fb.flagged_rows, fb.fallback_units) == (2, 1, 1)


def test_cache_serves_a_marked_rows_other_units():
    """K2 marks the run of "-" past the depth-16 walk and not its region-B
    row: the long words beside it are resolved on the device, stored in the
    cache and served from it in the next batch, which packs no row; the
    run's unit stays resolved-fallback for the call."""
    tok = _tok()
    runner = tok._unit_runner()
    words = WORD_DOCS[:2]
    cache = native.UnitCache()
    ids1, b1, need1, _s = runner.collect_docs(
        runner.dispatch_docs([RUN_DOC] + words, 0, cache=cache))
    assert need1.tolist() == [True, False, False]
    state = runner.dispatch_docs(words[::-1] + [RUN_DOC], 0, cache=cache)
    assert state[0].n_local == 0 and state[0].n_rows == 0
    ids2, b2, need2, _s = runner.collect_docs(state)
    assert need2.tolist() == [False, False, True]
    want = _native_ids(tok, words)
    for i, j in ((0, 1), (1, 0)):
        assert ids2[b2[i]:b2[i + 1]].tolist() == want[j]
        assert ids1[b1[j + 1]:b1[j + 2]].tolist() == want[j]
