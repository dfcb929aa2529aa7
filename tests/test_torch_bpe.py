"""The port's plain walk and resolve (blingfire_tpu_torch/ops/bpe.py) against
the JAX package's bpe_walk and _resolve_impl, on packed unit rows from the
native unit analysis, in all three row regions.  Integers compare exactly.

The resolve is held to both JAX branches: the scatter branch (BTL_GATHER=0,
the CPU default) lane for lane and flag for flag, the gather branch
(BTL_GATHER=1, the TPU formulation) on every row neither side flags.  The
branch is read when the function is traced, so each branch gets a fresh
jax.jit of _resolve_impl traced under its own setting."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import bpe as jax_bpe
from blingfire_tpu.ops.tables import build_comb_table as jax_comb
from blingfire_tpu.ops.tables import build_trie_table as jax_trie
from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.formats.consts import SP_DELIMITER, TokAlgo
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import bpe
from blingfire_tpu_torch.runtime.host import SpTokenizer

N = 128
REGIONS = [(0, 8, True), (1, 16, True), (2, 16, False)]


@functools.lru_cache(maxsize=2)
def _setup(algo: TokAlgo):
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40, tok_algo=algo)
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    jm = jax_load_bytes(blob).seg
    comb = jax_comb(jm.aut)
    jt = jax_bpe.make_device_tables(
        comb, jm.i2info_ids, jm.i2info_scores, max_len=tok.max_token_len,
        with_merges=algo == TokAlgo.BPE_OPT_WITH_MERGES, fast=True,
        id_offset=jm.id_offset,
        trie=jax_trie(comb, jm.i2info_ids, jm.i2info_scores),
    )
    spm_iw = int(tok._sym2iw[SP_DELIMITER])
    # plus punctuation runs longer than the depth-16 walk (region B's
    # unbounded walk must see live states at its cap)
    docs = [d.encode("utf-8") for d in full_corpus()] + [
        b"see " + bytes([c]) * k + b" end" for c in testing.LONG_CHARS[:4]
        for k in (17, 19, 30)]
    nu = native.units_analyze(docs, N, tok._sym2iw, spm_iw, True, False, None)
    R = nu.n_rows
    bounds = [0, nu.split_rows1, nu.split_rows, R]
    regions = [(nu.px[bounds[i]:bounds[i + 1]].copy(),
                nu.plen[bounds[i]:bounds[i + 1]].copy()) for i in range(3)]
    nu.close()
    return tok, jt, spm_iw, regions


def _region(algo, i):
    tok, jt, spm_iw, regions = _setup(algo)
    x, ln = regions[i]
    assert len(x) > 0, "corpus must fill every row region"
    return tok, jt, spm_iw, x, ln


def _jax_walk(jt, x, ln, spm_iw, lw, bounded):
    m_pack, m_rank, so = jax_bpe.bpe_walk(
        jt, jax.numpy.asarray(x), jax.numpy.asarray(x == spm_iw),
        jax.numpy.asarray(ln), lw=lw, bounded=bounded)
    return m_pack, m_rank, so


@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_plain_walk_matches_jax(region, lw, bounded):
    tok, jt, spm_iw, x, ln = _region(TokAlgo.BPE_OPT, region)
    m_pack, _m_rank, so = _jax_walk(jt, x, ln, spm_iw, lw, bounded)
    p_pack, p_so = bpe.bpe_walk(tok.tables, torch.from_numpy(x),
                                torch.from_numpy(ln), spm_iw, lw=lw,
                                bounded=bounded)
    np.testing.assert_array_equal(p_pack.numpy(), np.asarray(m_pack))
    np.testing.assert_array_equal(p_so.numpy(), np.asarray(so))
    if not bounded:
        assert p_so.any(), "unbounded region should see live states at its cap"


@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_plain_walk_notes_the_trie_entries_it_reads(region, lw, bounded):
    """kernels.Reads, which chip_smoke's byte bound of K1 counts: the walk is
    unchanged, every match comes from a live step, and a trie entry read
    twice counts once."""
    tok, _jt, spm_iw, x, ln = _region(TokAlgo.BPE_OPT, region)
    LW = bpe._walk_depth(tok.tables, lw)
    ovf = tok.tables.max_len > LW and not bounded
    args = (tok.tables, torch.from_numpy(x), torch.from_numpy(ln), spm_iw, LW,
            ovf)
    r = kernels.Reads()
    got, want = bpe._walk_plain(*args, reads=r), bpe._walk_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_match = int((got[0] >= 0).sum())
    assert 0 < n_match <= r.steps and 0 < r.entries("trie_next") < r.steps
    assert r.table_bytes() == 4 * r.entries("trie_next")


def _jax_resolve(monkeypatch, gather: str, jt, m_pack, m_rank, so, x, ln,
                 spm_iw, a_max):
    monkeypatch.setenv("BTL_GATHER", gather)
    fn = jax.jit(jax_bpe._resolve_impl, static_argnames=("a_max",))
    out = fn(jt, m_pack, m_rank, so, jax.numpy.asarray(x == spm_iw),
             jax.numpy.asarray(ln), jax.numpy.int32(0), a_max=a_max)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("algo", [TokAlgo.BPE_OPT, TokAlgo.BPE_OPT_WITH_MERGES],
                         ids=["bpe_opt", "merges_priority"])
@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_plain_resolve_matches_both_jax_branches(monkeypatch, algo, region,
                                                 lw, bounded):
    tok, jt, spm_iw, x, ln = _region(algo, region)
    if algo == TokAlgo.BPE_OPT_WITH_MERGES:
        assert tok.tables.prio2id is not None
    m_pack, m_rank, so = _jax_walk(jt, x, ln, spm_iw, lw, bounded)
    port = bpe.bpe_resolve(
        tok.tables, torch.from_numpy(np.array(m_pack)),
        torch.from_numpy(np.array(so)), torch.from_numpy(x),
        torch.from_numpy(ln), spm_iw, 0, tok.a_max)
    port = [t.numpy() for t in port]
    scatter = _jax_resolve(monkeypatch, "0", jt, m_pack, m_rank, so, x, ln,
                           spm_iw, tok.a_max)
    gather = _jax_resolve(monkeypatch, "1", jt, m_pack, m_rank, so, x, ln,
                          spm_iw, tok.a_max)
    # scatter branch: every lane, count and flag
    for name, a, b in zip(("ids", "starts", "ends", "counts", "fallback"),
                          port, scatter):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # gather branch: rows neither side flags
    ok = ~port[4] & ~gather[4]
    assert ok.sum() > 0
    for name, a, b in zip(("ids", "starts", "ends", "counts"), port, gather):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)


def test_segment_is_walk_then_resolve():
    tok, _jt, spm_iw, x, ln = _region(TokAlgo.BPE_OPT, 1)
    xt, lt = torch.from_numpy(x), torch.from_numpy(ln)
    seg = bpe.bpe_segment(tok.tables, xt, lt, spm_iw, 0, tok.a_max, lw=16,
                          bounded=True)
    m, so = bpe.bpe_walk(tok.tables, xt, lt, spm_iw, lw=16, bounded=True)
    res = bpe.bpe_resolve(tok.tables, m, so, xt, lt, spm_iw, 0, tok.a_max)
    for a, b in zip(seg, res):
        assert torch.equal(a, b)


def test_unported_modes_raise():
    tok, _jt, spm_iw, x, ln = _region(TokAlgo.BPE_OPT, 0)
    xt, lt = torch.from_numpy(x), torch.from_numpy(ln)
    import dataclasses

    comb_only = dataclasses.replace(tok.tables, trie_next=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bpe.bpe_walk(comb_only, xt, lt, spm_iw, lw=8)
    rank_mode = dataclasses.replace(tok.tables, with_merges=True, prio2id=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bpe.bpe_walk(rank_mode, xt, lt, spm_iw, lw=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tok.encode_corpus([b"a b"])
    # -1 means "no symbol" in x_iw, so it cannot name ▁
    with pytest.raises(ValueError, match="spm_iw"):
        bpe.bpe_walk(tok.tables, xt, lt, -1, lw=8)
