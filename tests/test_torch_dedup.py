"""The port's NumPy unit path (blingfire_tpu_torch/runtime/dedup.py:
split_units, _dedup_rows, pack_units, pack_out, and the unit path's
pack_out_compact, UnitRunner.dispatch /
collect / encode) against the JAX package's, and SpTokenizer at a window of
2,048 symbols, where a chunk-safe model takes that path, against JAX's same
calls and the native runtime.  Integers compare exactly (tolerance 0)."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import bpe as jax_bpe
from blingfire_tpu.runtime import dedup as jax_dedup
from blingfire_tpu.runtime import host as jax_host
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime import dedup, metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer

N = 128
KINDS = ["gpt2", "xlnet"]


@functools.lru_cache(maxsize=None)
def _blob(kind: str) -> bytes:
    if kind == "gpt2":
        return testing.gpt2_shaped_model_bytes(2000, n_long=40)
    return testing.xlnet_shaped_model_bytes(4000, n_cjk=100)


def _docs() -> list[bytes]:
    """tests/corpus.py, the Zipfian corpus, and units past UNIT_MAX."""
    zipf = testing.zipf_corpus(40_000)[len(testing.EDGE_CASES):][:60]
    return ([d.encode("utf-8") for d in full_corpus(n_random=40)] + zipf
            + [b"see " + bytes([c]) * k + b" end"
               for c in testing.LONG_CHARS[:3] for k in (20, 70)])


@functools.lru_cache(maxsize=None)
def _pair(kind: str, n_doc: int = N):
    tok = SpTokenizer(load_bytes(_blob(kind)), max_doc_symbols=n_doc,
                      device="cpu")
    jtok = jax_host.SpTokenizer(jax_load_bytes(_blob(kind)),
                                max_doc_symbols=n_doc)
    return tok, jtok


@functools.lru_cache(maxsize=None)
def _prepped(kind: str):
    tok, _jtok = _pair(kind)
    x, spm, lengths, status = tok._prep_batch(_docs(), with_spm=True)
    assert (status == 0).sum() > 60
    return x, spm, lengths


@pytest.mark.parametrize("kind", KINDS)
def test_split_dedup_pack_match_jax(kind):
    """UnitBatch, the dedup's (u_idx, inv) and the packed rows, lane for
    lane, on a prepped batch at N = 128."""
    x, spm, lengths = _prepped(kind)
    ub, jub = dedup.split_units(x, spm, lengths), jax_dedup.split_units(
        x, spm, lengths)
    for f in ("u_x", "u_len", "u_spm0", "inst_unit", "inst_doc", "classic"):
        np.testing.assert_array_equal(getattr(ub, f), getattr(jub, f), f)
    assert ub.classic.any() and len(ub.u_len) < len(ub.inst_unit)
    i_x = ub.u_x[ub.inst_unit]
    i_len = ub.u_len[ub.inst_unit]
    for a, b in zip(dedup._dedup_rows(i_x, i_len),
                    jax_dedup._dedup_rows(i_x, i_len)):
        np.testing.assert_array_equal(a, b)
    for width in (N, 1024):
        for a, b in zip(dedup.pack_units(ub, width),
                        jax_dedup.pack_units(jub, width)):
            np.testing.assert_array_equal(a, b)


def test_plain_pack_out_matches_jax():
    rng = np.random.default_rng(7)
    B, W = 37, 130
    ids = rng.integers(-5, 1 << 20, (B, W), dtype=np.int32)
    st = rng.integers(0, W, (B, W), dtype=np.int32)
    cnt = rng.integers(0, W + 1, B, dtype=np.int32)
    fb = rng.random(B) < 0.3
    got = dedup.pack_out(*(torch.from_numpy(a) for a in (ids, st, cnt, fb)))
    want = jax_dedup._helpers()[1](ids, st, cnt, fb)
    assert got.dtype == torch.int32 and got.shape == (B, 2 * W + 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = torch.full((B, 2 * W + 2), -7, dtype=torch.int32)
    dedup.pack_out(*(torch.from_numpy(a) for a in (ids, st, cnt, fb)),
                   out=out)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("B", [0, 1, 3])
@pytest.mark.parametrize("width", [1, 2, 7, 128])
def test_plain_pack_out_compact_matches_jax(width, B):
    """K4's plain version against JAX's pack_out_compact (dedup.py:217-226)
    at odd and even widths: lanes (id + 1) | (start << 21) with negative
    starts and starts up to 1,023, whose shift reaches bit 31."""
    rng = np.random.default_rng(width * 10 + B)
    ids = rng.integers(-5, 1 << 20, (B, width), dtype=np.int32)
    st = rng.integers(-3, 1024, (B, width), dtype=np.int32)
    if B:
        st[0, 0] = 1023
        st[-1, -1] = -1
    cnt = rng.integers(0, width + 1, B, dtype=np.int32)
    fb = rng.random(B) < 0.5
    args = [torch.from_numpy(a) for a in (ids, st, cnt, fb)]
    got = dedup.pack_out_compact(*args)
    want = np.asarray(jax_dedup._helpers()[2](ids, st, cnt, fb))
    assert got.dtype == torch.int32 and got.shape == (B, width + 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if B:
        assert (want[:, :width] < 0).any(), "no lane with bit 31 set"
    out = torch.full((B, width + 2), -7, dtype=torch.int32)
    assert dedup.pack_out_compact(*args, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def _fresh(fn):
    """A new function object calling ``fn``: jax.jit keeps its traces per
    function object, so a jit of ``fn`` itself would reuse the other
    branch's trace."""
    @functools.wraps(fn)
    def call(*args, **kw):
        return fn(*args, **kw)
    return call


def _jax_encode(monkeypatch, kind: str, gather: str):
    """JAX's UnitRunner.encode on one BPE branch: the branch is read when a
    program is traced, so each branch gets fresh jits of the walk and the
    resolve (bpe_segment looks them up at call time)."""
    monkeypatch.setenv("BTL_GATHER", gather)
    monkeypatch.setattr(jax_bpe, "bpe_walk", jax.jit(
        _fresh(jax_bpe._walk_impl), static_argnames=("lw", "bounded")))
    monkeypatch.setattr(jax_bpe, "bpe_resolve", jax.jit(
        _fresh(jax_bpe._resolve_impl), static_argnames=("a_max",)))
    _tok, jtok = _pair(kind)
    return jtok._unit_runner().encode(*_prepped(kind), 0)


@pytest.mark.parametrize("kind,gather", [("gpt2", "0"), ("gpt2", "1"),
                                         ("xlnet", "0")],
                         ids=["gpt2-scatter", "gpt2-gather", "xlnet"])
def test_unit_runner_encode_matches_jax(monkeypatch, kind, gather):
    """UnitRunner.encode (the NumPy path) against JAX's at n_doc = 128: on
    the scatter branch (the CPU default) every out list and need flag; on
    the gather branch (BTL_GATHER=1, which alone raises k2_overflow) every
    document neither side marks, and the marks of the scatter branch where
    the gather branch flags nothing more."""
    tok, _jtok = _pair(kind)
    out, need = tok._unit_runner().encode(*_prepped(kind), 0)
    jout, jneed = _jax_encode(monkeypatch, kind, gather)
    assert need.any() and not need.all()
    if gather == "0":
        np.testing.assert_array_equal(need, jneed)
        assert out == jout
    else:
        assert (need <= jneed).all()
        both = ~need & ~jneed
        assert both.sum() > 60
        assert [o for o, k in zip(out, both) if k] == \
            [o for o, k in zip(jout, both) if k]


@functools.lru_cache(maxsize=None)
def _jax_wide(kind: str):
    """JAX's encode_corpus and encode_batch of ``wide_window_docs`` at a window
    of 2,048 symbols (its rows 2,048 wide: seconds a call on the CPU)."""
    _tok, jtok = _pair(kind, 2048)
    docs = testing.wide_window_docs()
    # one batch of every document: encode_batch's shapes, so JAX compiles once
    return (jtok.encode_corpus(docs, batch_docs=len(docs)),
            jtok.encode_batch(docs))


@pytest.mark.parametrize("kind", KINDS)
def test_wide_window_takes_the_numpy_unit_path(kind):
    """max_doc_symbols=2048 is past the compact lanes, so a chunk-safe
    model takes the NumPy unit path (units_np_batches), the documents it
    marks the classic rows and documents past the window chunk rows:
    encode_corpus_flat, encode_corpus and encode_batch equal JAX's same
    calls and the native runtime's TextToIds."""
    tok, _jtok = _pair(kind, 2048)
    runner = tok._unit_runner()
    assert tok._chunk_safe and not runner.compact_ok
    docs = testing.wide_window_docs()
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=16, counters=c)
    flat = [ids[bounds[i]:bounds[i + 1]].tolist() for i in range(len(docs))]
    assert c.units_np_batches == c.batches > 1
    assert c.chunked_docs > 0 and c.oracle_docs == 0 and c.cache_units == 0
    want_corpus, want_batch = _jax_wide(kind)
    assert flat == want_corpus
    assert tok.encode_corpus(docs, batch_docs=16) == want_corpus
    assert tok.encode_batch(docs) == want_batch == want_corpus
    assert flat == [tok._fallback_ids(d, 0) for d in docs]
    # documents the unit path marks: a unit past UNIT_MAX
    x, spm, lengths, _status = tok._prep_batch(docs, with_spm=True)
    _out, need = runner.encode(x, spm, lengths, 0)
    assert need.sum() >= 2
