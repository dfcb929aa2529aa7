"""The plain versions behind K5 unigram_walk's depth chunks and K7/K8's one
launch and visited chain, held to the JAX package on the CPU (tolerance 0):

(a) ``unigram_segment`` at the walk depths on each side of K5's 32-depth
    chunks (testing.DEEP_DEPTHS) on testing.unigram_deep_rows, a seeded
    model whose pieces run to 70 symbols: against JAX in the dense mode at
    every depth; the wide and comb walks against the dense walk at every
    depth, and their segments against JAX at depth 1 (JAX's compile time
    grows with the depth, and each mode compiles apart);
(b) the WordPiece sub-token pass in one call over the packed rows of both
    unit-length classes, each at its own walk depth, as the hybrid launches
    it, against JAX's passes run once a class;
(c) the emit, the yardstick of K7's and K8's visited chain, against JAX's
    ``_wp_emit`` on seeded rows whose skip targets reach any forward
    position.
"""

from __future__ import annotations

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import lexer as jax_lexer
from blingfire_tpu.ops import tables as jax_tables
from blingfire_tpu.ops import unigram as jax_unigram
from blingfire_tpu.runtime.wp_hybrid import WordPieceHybrid as JaxHybrid
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import lexer, unigram
from blingfire_tpu_torch.ops.tables import build_comb_table
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

MODES = ["dense", "wide", "comb"]
DEEP_WIDTH = 66  # past 64 symbols; narrow, for JAX's compile time


def _force_mode(monkeypatch, mode: str) -> None:
    for mod in (jax_unigram, unigram):
        if mode in ("wide", "comb"):
            monkeypatch.setattr(mod, "_DENSE_MAX_ENTRIES", 0)
        if mode == "comb":
            monkeypatch.setattr(mod, "_WIDE_OWNER_SENTINEL", 0)


@functools.lru_cache(maxsize=1)
def _deep():
    return testing.unigram_deep_rows(DEEP_WIDTH)


def _port_tables(blob):
    pm = load_bytes(blob, use_cache=False).seg
    return unigram.make_device_tables(
        build_comb_table(pm.aut), pm.i2info_ids, pm.i2info_scores,
        max_len=testing.DEEP_MAX_LEN, id_offset=pm.id_offset, device="cpu")


def _jax_tables(blob):
    jm = jax_load_bytes(blob, use_cache=False).seg
    return jax_unigram.make_device_tables(
        jax_tables.build_comb_table(jm.aut), jm.i2info_ids,
        jm.i2info_scores, max_len=testing.DEEP_MAX_LEN,
        id_offset=jm.id_offset)


def _port_segment(pt, x, ln, lw):
    return [t.numpy() for t in unigram.unigram_segment(
        pt, torch.from_numpy(x), torch.from_numpy(ln), 0, lw=lw)]


def _jax_segment(jt, x, ln, lw):
    return [np.asarray(o) for o in jax_unigram.unigram_segment(
        jt, jnp.asarray(x), jnp.asarray(ln), jnp.int32(0), lw=lw)]


def _assert_same(got, want):
    for name, a, b in zip(("ids", "starts", "ends", "counts"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_deep_rows_walk_past_a_chunk():
    """The rows reach every depth of DEEP_DEPTHS, so each chunk boundary
    of K5 is crossed by a live walk."""
    blob, x, ln = _deep()
    pt = _port_tables(blob)
    assert pt.max_len == testing.DEEP_MAX_LEN >= 64
    m_key, _s = unigram.unigram_walk(pt, torch.from_numpy(x),
                                     torch.from_numpy(ln))
    depths = set((m_key >= 0).nonzero()[:, 2].tolist())
    assert {d - 1 for d in testing.DEEP_DEPTHS} <= depths


@pytest.mark.parametrize("lw", testing.DEEP_DEPTHS)
def test_deep_segment_matches_jax(lw):
    blob, x, ln = _deep()
    got = _port_segment(_port_tables(blob), x, ln, lw)
    _assert_same(got, _jax_segment(_jax_tables(blob), x, ln, lw))
    assert got[3].sum() > 0


@pytest.mark.parametrize("mode", ["wide", "comb"])
def test_deep_segment_in_every_mode(monkeypatch, mode):
    blob, x, ln = _deep()
    dense = _port_tables(blob)
    _force_mode(monkeypatch, mode)
    pt = _port_tables(blob)
    assert pt.mode == MODES.index(mode)
    for lw in testing.DEEP_DEPTHS:
        for a, b in zip(unigram._walk_plain(pt, torch.from_numpy(x),
                                            torch.from_numpy(ln), lw),
                        unigram._walk_plain(dense, torch.from_numpy(x),
                                            torch.from_numpy(ln), lw)):
            assert torch.equal(a, b), lw
    _assert_same(_port_segment(pt, x, ln, 1),
                 _jax_segment(_jax_tables(blob), x, ln, 1))


# ------------------------------------------------------------------ (b)


@functools.lru_cache(maxsize=1)
def _wp_blob() -> bytes:
    return testing.bert_shaped_model_bytes(2000)


@functools.lru_cache(maxsize=1)
def _jax_hybrid() -> JaxHybrid:
    return JaxHybrid(jax_load_bytes(_wp_blob(), use_cache=False))


@functools.lru_cache(maxsize=None)
def _port_hybrid(comb: bool) -> WordPieceHybrid:
    """The port's hybrid on the CPU; comb=True declines the dense table."""
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1 if comb else saved
    try:
        return WordPieceHybrid(load_bytes(_wp_blob(), use_cache=False),
                               device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved


@functools.lru_cache(maxsize=1)
def _wp_docs() -> list[bytes]:
    docs = [d.encode("utf-8") for d in full_corpus()]
    return docs + testing.zipf_corpus(150_000)[len(testing.EDGE_CASES):][:240]


def _jax_class(jh, comb: bool, x, init, lw):
    args = (jnp.asarray(x), jnp.asarray(init), jnp.int32(jh._l_iw),
            jnp.int32(jh._r_iw), lw)
    if comb:
        return np.asarray(jax_lexer.wp_subword_pass(jh.tables, *args))
    dnext, ow_perm, _p, n_f, _n = jh._dense
    return np.asarray(jax_lexer.wp_subword_pass_dense(
        jh.tables, dnext, ow_perm, *args, n_f, jh._n_iws))


@pytest.mark.parametrize("comb,depths", [(False, (18, 42)), (True, (18, 42)),
                                         (False, (42, 1))],
                         ids=["dense", "comb", "dense_short_tail"])
def test_one_launch_pass_matches_jax_by_class(comb, depths):
    """WordPieceHybrid._passes over a batch's packed rows, one call with
    both classes at their walk depths, against JAX's pass run once a class
    on the same rows: at the dispatch's depths (lw 18 and 42), and with the
    second class cut to 1 step, where the depth changes its lanes."""
    h, jh = _port_hybrid(comb), _jax_hybrid()
    nh, u_syms, u_soff, u_fn = h._analyze(_wp_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    assert [lw for _lo, _hi, lw in class_rows] == [18, 42]
    assert all(hi > lo for lo, hi, _lw in class_rows)
    class_rows = [(lo, hi, lw) for (lo, hi, _lw), lw in zip(class_rows,
                                                             depths)]
    out = torch.full((len(px), px.shape[1] + 2), -7, dtype=torch.int32)
    h._passes(torch.from_numpy(px), torch.from_numpy(pinit), class_rows, out)
    want = [_jax_class(jh, comb, px[lo:hi], pinit[lo:hi], lw)
            for lo, hi, lw in class_rows]
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want))
    assert want[0][:, px.shape[1]].sum() > 0
    if depths[1] < depths[0]:
        lo, hi, _lw = class_rows[1]
        assert not np.array_equal(want[1], _jax_class(
            jh, comb, px[lo:hi], pinit[lo:hi], depths[0]))


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("M", [5, 33, 128])
def test_emit_matches_jax(M):
    """The port's emit (visited_chain) against JAX's _wp_emit (its
    lax.scan) on seeded rows: each start's deepest final and action drawn
    so that its skip target is any forward position; action p tags 1 + p,
    so the emitted lanes name the starts the chain visits."""
    rng = np.random.default_rng(100 + M)
    B, l_iw, r_iw = 24, 1, 2
    x = rng.integers(0, 8, (B, M)).astype(np.int32)
    x[rng.random((B, M)) < 0.1] = -1
    pos = np.arange(M)
    fin_pos = (pos[None, :] + rng.integers(0, 12, (B, M))).astype(np.int32)
    fin_pos[rng.random((B, M)) < 0.3] = -1
    fin_ow = np.where(fin_pos >= 0, pos[None, :], -1).astype(np.int32)
    right = rng.integers(0, 3, M).astype(np.int32)
    tag = (pos + 1).astype(np.int32)
    fn = np.where(rng.random(M) < 0.3, 7, -1).astype(np.int32)
    pt = types.SimpleNamespace(act_right=torch.from_numpy(right),
                               act_tag=torch.from_numpy(tag),
                               act_fn=torch.from_numpy(fn))
    jt = types.SimpleNamespace(act_right=jnp.asarray(right),
                               act_tag=jnp.asarray(tag),
                               act_fn=jnp.asarray(fn))
    got = lexer._emit_plain(pt, torch.from_numpy(x), torch.from_numpy(fin_pos),
                            torch.from_numpy(fin_ow), l_iw, r_iw).numpy()
    jx = jnp.asarray(x)
    want = np.asarray(jax_lexer._wp_emit(
        jt, jx, jnp.asarray(fin_pos), jnp.asarray(fin_ow), jx == l_iw,
        (jx >= 0) & (jx != r_iw), jnp.arange(M, dtype=jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert 0 < want[:, M].sum() < B * M
