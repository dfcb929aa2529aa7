"""The port's unigram-LM pieces (blingfire_tpu_torch/ops/{dfloat,unigram}.py)
against the JAX package's, on small xlnet-shaped models with the charmap.
Every comparison is exact: integers at tolerance 0, df64 pairs bit for bit.

A table mode is forced the same way in both packages, by monkeypatching
their module constants: ``_DENSE_MAX_ENTRIES = 0`` gives the wide mode, and
``_WIDE_OWNER_SENTINEL = 0`` as well gives the comb mode.

The JAX comb and wide walks clamp a slot ``base[s] + c`` into the slot
array, so from the state that owns slot 0 a symbol below its base takes
slot 0's transition; the port takes none (ROADMAP.md section C).  A row is
held to JAX only where JAX's clamp does not false-hit; these models' roots
hold every symbol, so no row here does (tests/test_torch_lexer.py holds a
model whose root does not)."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import dfloat as jax_dfloat
from blingfire_tpu.ops import tables as jax_tables
from blingfire_tpu.ops import unigram as jax_unigram
from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.formats.consts import SP_DELIMITER
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import dfloat, unigram
from blingfire_tpu_torch.ops.tables import build_comb_table
from blingfire_tpu_torch.runtime.host import SpTokenizer

N = 128
MODES = ["dense", "wide", "comb"]
REGIONS = [(0, 8, True), (1, 16, True), (2, 16, False)]
ARRAYS = ("base", "owner", "nxt", "ow", "final", "ids_tab", "scores_tab",
          "dense", "wide_a", "wide_b")
SCALARS = ("n_slots", "max_len", "id_offset", "n_iws")


def _force_mode(monkeypatch, mode: str) -> None:
    for mod in (jax_unigram, unigram):
        if mode in ("wide", "comb"):
            monkeypatch.setattr(mod, "_DENSE_MAX_ENTRIES", 0)
        if mode == "comb":
            monkeypatch.setattr(mod, "_WIDE_OWNER_SENTINEL", 0)


def _both_tables(blob: bytes, max_len: int):
    """(JAX tables, port tables on the CPU) of one model image."""
    jm = jax_load_bytes(blob, use_cache=False).seg
    jt = jax_unigram.make_device_tables(
        jax_tables.build_comb_table(jm.aut), jm.i2info_ids, jm.i2info_scores,
        max_len=max_len, id_offset=jm.id_offset)
    pm = load_bytes(blob, use_cache=False).seg
    pt = unigram.make_device_tables(
        build_comb_table(pm.aut), pm.i2info_ids, pm.i2info_scores,
        max_len=max_len, id_offset=pm.id_offset, device="cpu")
    return jt, pt


@functools.lru_cache(maxsize=1)
def _model():
    """A small xlnet-shaped model, its tokenizer and packed unit rows of
    tests/corpus.py in the three regions."""
    blob = testing.xlnet_shaped_model_bytes(4000, n_cjk=100)
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    spm_iw = int(tok._sym2iw[SP_DELIMITER])
    docs = [d.encode("utf-8") for d in full_corpus()]
    nu = native.units_analyze(docs, N, tok._sym2iw, spm_iw, False, False,
                              tok.seg.charmap)
    b = [0, nu.split_rows1, nu.split_rows, nu.n_rows]
    regions = [(nu.px[b[i]:b[i + 1]].copy(), nu.plen[b[i]:b[i + 1]].copy())
               for i in range(3)]
    nu.close()
    return blob, tok, regions


@pytest.mark.parametrize("mode", MODES)
def test_device_tables_match_jax(monkeypatch, mode):
    blob, tok, _r = _model()
    _force_mode(monkeypatch, mode)
    jt, pt = _both_tables(blob, tok.max_token_len)
    assert pt.mode == MODES.index(mode)
    for name in ARRAYS:
        a, b = getattr(jt, name), getattr(pt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for name in SCALARS:
        assert getattr(pt, name) == getattr(jt, name), name


def test_default_thresholds_give_dense():
    _blob, tok, _r = _model()
    assert tok.tables.mode == unigram.MODE_DENSE
    assert tok.tables.dense.numel() == tok.comb.n_states * tok.comb.n_iws


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


def test_df64_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    n = 4000
    hi = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)).astype(np.float32)
    lo = (hi * rng.standard_normal(n) * 2.0 ** -26).astype(np.float32)
    f = (-rng.exponential(8.0, n)).astype(np.float32)
    special = np.float32([np.finfo(np.float32).min, -1e5, 0.0, -0.0, 1.0, -3.5])
    hi[: len(special)] = special
    f[len(special): 2 * len(special)] = special
    lo[2 * len(special): 3 * len(special)] = special[2:4].repeat(3)
    # near-ties: float32 sums tie, df64 sums do not
    hi[-4:] = 1.0
    lo[-4:] = 0.0
    f[-4:] = np.float32([2.0 ** -24, 0.0, -(2.0 ** -25), 2.0 ** -23])
    for fn in ("two_sum", "df_add"):
        args = (hi, f) if fn == "two_sum" else (hi, lo, f)
        want = getattr(jax_dfloat, fn)(*map(jnp.asarray, args))
        got = getattr(dfloat, fn)(*map(torch.from_numpy, args))
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    s_hi, s_lo = dfloat.df_add(*map(torch.from_numpy, (hi, lo, f)))
    assert s_hi[-4] == s_hi[-3] and s_lo[-4] != s_lo[-3]
    perm = rng.permutation(n)
    cmp = (s_hi, s_lo, s_hi[perm], s_lo[perm])
    want = jax_dfloat.df_lt(*(jnp.asarray(t.numpy()) for t in cmp))
    got = dfloat.df_lt(*cmp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(dfloat.df_lt(s_hi[-3], s_lo[-3], s_hi[-4], s_lo[-4]))


def _false_hit_rows(pt, x, ln, lw) -> np.ndarray:
    """bool (B,): rows where JAX's comb or wide walk takes a transition
    through a slot below 0, replayed on the port's walk (both agree up to
    it).  The dense table has no clamp."""
    x, ln = torch.as_tensor(x), torch.as_tensor(ln)
    B, N = x.shape
    hit = torch.zeros(B, dtype=torch.bool)
    if pt.dense is not None:
        return hit.numpy()
    s0 = int(pt.owner[0])
    b0 = int(pt.base[s0])
    L = unigram.walk_depth(pt, lw)
    xp = torch.cat([x, torch.full((B, L + 1), -1, dtype=torch.int32)], 1)
    pos = torch.arange(N)
    state = torch.where((pos < ln[:, None]) & (x >= 0), 0, -1).to(torch.int32)
    for d in range(L):
        c = xp[:, d : d + N]
        hit |= ((state == s0) & (c >= 0) & (b0 + c < 0)).any(1)
        state = unigram.walk_step(pt, state, c)[0].to(torch.int32)
    return hit.numpy()


def _jax_segment(jt, x, ln, lw):
    out = jax_unigram.unigram_segment(jt, jnp.asarray(x), jnp.asarray(ln),
                                      jnp.int32(0), lw=lw)
    return [np.asarray(o) for o in out]


def _assert_same(port, want):
    for name, a, b in zip(("ids", "starts", "ends", "counts"), port, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("region,lw,bounded", REGIONS)
@pytest.mark.parametrize("mode", MODES)
def test_segment_matches_jax(monkeypatch, mode, region, lw, bounded):
    blob, tok, regions = _model()
    x, ln = regions[region]
    assert len(x) > 0, "corpus must fill every row region"
    _force_mode(monkeypatch, mode)
    jt, pt = _both_tables(blob, tok.max_token_len)
    lw_eff = lw if bounded else None
    assert not _false_hit_rows(pt, x, ln, lw_eff).any()
    port = unigram.unigram_segment(pt, torch.from_numpy(x),
                                   torch.from_numpy(ln), 0, lw=lw_eff)
    _assert_same(port, _jax_segment(jt, x, ln, lw_eff))
    assert (port[3] > 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_segment_hand_made_rows_match_jax(monkeypatch, mode):
    """testing.unigram_edge_rows: unknown symbols (-1) and merged unknown
    runs, an empty row, a length past the row, rows where every candidate
    at some end is -FLT_MAX, and symbols past the length that the walk
    still reads."""
    blob, x, ln = testing.unigram_edge_rows()
    _force_mode(monkeypatch, mode)
    jt, pt = _both_tables(blob, 3)
    for lw in (None, 2):
        assert not _false_hit_rows(pt, x, ln, lw).any()
        port = unigram.unigram_segment(pt, torch.from_numpy(x),
                                       torch.from_numpy(ln), 7, lw=lw)
        out = jax_unigram.unigram_segment(jt, jnp.asarray(x), jnp.asarray(ln),
                                          jnp.int32(7), lw=lw)
        _assert_same(port, [np.asarray(o) for o in out])
    starts = port[1].numpy()
    assert starts.min() < 0, "an all -FLT_MAX end should give a negative start"


def test_segment_is_walk_then_viterbi():
    _blob, tok, regions = _model()
    x, ln = (torch.from_numpy(v) for v in regions[1])
    seg = unigram.unigram_segment(tok.tables, x, ln, 0, lw=16)
    m_key, m_score = unigram.unigram_walk(tok.tables, x, ln, lw=16)
    L = min(16, tok.tables.max_len)
    assert m_key.shape == (len(x), N, L) and m_score.dtype == torch.float32
    for s, v in zip(seg, unigram.unigram_viterbi(tok.tables, m_key, m_score,
                                                 ln, 0)):
        assert torch.equal(s, v)


@pytest.mark.parametrize("mode", MODES)
def test_plain_walk_notes_the_entries_it_reads(monkeypatch, mode):
    """kernels.Reads, which chip_smoke's byte bound of K5 counts, in every
    table mode: the walk is unchanged, every mode takes the dense walk's
    live steps and reads its score entries, and an entry counts once."""
    blob, tok, regions = _model()
    x, ln = (torch.from_numpy(v) for v in regions[1])
    L = unigram.walk_depth(tok.tables, 16)
    rd = kernels.Reads()
    unigram._walk_plain(tok.tables, x, ln, L, reads=rd)
    _force_mode(monkeypatch, mode)
    _jt, pt = _both_tables(blob, tok.max_token_len)
    r = kernels.Reads()
    for g, w in zip(unigram._walk_plain(pt, x, ln, L, reads=r),
                    unigram._walk_plain(pt, x, ln, L)):
        assert torch.equal(g, w)
    assert r.steps == rd.steps > 0
    assert r.entries("scores_tab") == rd.entries("scores_tab") > 0
    walked = {"dense": "dense", "wide": "wide_a", "comb": "owner"}[mode]
    assert 0 < r.entries(walked) <= r.steps
