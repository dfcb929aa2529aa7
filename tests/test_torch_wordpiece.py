"""The port's WordPiece hybrid (blingfire_tpu_torch/runtime/wp_hybrid.py,
ops/lexer.py, the native runtime copy) against the JAX package on a
2,000-entry bert-shaped model (testing.bert_shaped_model_bytes), on the CPU:

(a) lexer device tables, make_dense_sub and the pack-safety check;
(b) the plain sub-token passes (dense and comb) lane for lane on the rows
    of the port's own packing, at both walk depths, on hand-made edge rows,
    at the lane fields' limits and with the token-length gate live;
(c) the native runtime copy's analysis, units, stitch and TextToIds;
(d) encode_corpus_flat ids, bounds and fallback count, against JAX's
    WordPieceHybrid and the scalar oracle, with [UNK] = 100.

The JAX comb walk clamps a slot ``base[s] + c`` into the slot array, so
from the state that owns slot 0 a symbol below its base takes slot 0's
transition; the port takes none (ROADMAP.md section C).  So the comb pass
is held to JAX lane for lane on every row where JAX's clamp does not
false-hit, and on the others its walk is held to the automaton's own
transitions (runtime/oracle.py::TransitionIndex).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu import native as jax_native
from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import lexer as jax_lexer
from blingfire_tpu.runtime.wp_hybrid import WordPieceHybrid as JaxHybrid
from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.compiler.lexbin import compile_lex_model
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import lexer
from blingfire_tpu_torch.runtime import metrics, wp_hybrid
from blingfire_tpu_torch.runtime.lexer import LexerOracleApi
from blingfire_tpu_torch.runtime.oracle import TransitionIndex
from blingfire_tpu_torch.runtime.wp_hybrid import LW_CLASSES, WordPieceHybrid

N_VOCAB = 2000
UNK = testing.BERT_UNK
TABLE_FIELDS = ("base", "owner", "nxt", "final", "moore_ow", "act_right",
                "act_tag", "act_fn")


@functools.lru_cache(maxsize=1)
def _blob() -> bytes:
    return testing.bert_shaped_model_bytes(N_VOCAB)


@functools.lru_cache(maxsize=None)
def _port(comb: bool = False) -> WordPieceHybrid:
    """The port's hybrid on the CPU; comb=True declines the dense table."""
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1 if comb else saved
    try:
        return WordPieceHybrid(load_bytes(_blob(), use_cache=False),
                               device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved


@functools.lru_cache(maxsize=1)
def _jax() -> JaxHybrid:
    return JaxHybrid(jax_load_bytes(_blob(), use_cache=False))


@functools.lru_cache(maxsize=1)
def _docs() -> list[bytes]:
    docs = [d.encode("utf-8") for d in full_corpus()]
    zipf = testing.zipf_corpus(150_000)[len(testing.EDGE_CASES):]
    return docs + zipf[:240]


@functools.lru_cache(maxsize=None)
def _packed(comb: bool = False):
    """(px, pinit, class_rows) of the port's packing of the corpus."""
    h = _port(comb)
    nh, u_syms, u_soff, u_fn = h._analyze(_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    return px, pinit, class_rows


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_dense(jt, x, init, lw):
    h = _jax()
    dnext, ow_perm, _p, n_f, _n = h._dense
    return np.asarray(jax_lexer.wp_subword_pass_dense(
        jt, dnext, ow_perm, jnp.asarray(x), jnp.asarray(init),
        jnp.int32(h._l_iw), jnp.int32(h._r_iw), lw, n_f, h._n_iws))


def _port_dense(pt, x, init, lw):
    h = _port()
    dnext, ow_perm, _p, n_f, _n = h._dense
    return lexer.wp_subword_pass_dense(
        pt, dnext, ow_perm, torch.from_numpy(x), torch.from_numpy(init),
        h._l_iw, h._r_iw, lw, n_f, h._n_iws).numpy()


def _jax_comb(jt, x, init, lw):
    h = _jax()
    return np.asarray(jax_lexer.wp_subword_pass(
        jt, jnp.asarray(x), jnp.asarray(init), jnp.int32(h._l_iw),
        jnp.int32(h._r_iw), lw))


def _port_comb(pt, x, init, lw):
    h = _port(comb=True)
    return lexer.wp_subword_pass(
        pt, torch.from_numpy(x), torch.from_numpy(init), h._l_iw, h._r_iw,
        lw).numpy()


def _comb_false_hits(pt, x, init, lw) -> np.ndarray:
    """bool (B,): rows where JAX's comb walk takes a transition through a
    slot below 0, replayed on the port's walk (both agree up to it)."""
    h = _port(comb=True)
    s0 = int(pt.owner[0])
    b0 = int(pt.base[s0])
    x, init = torch.from_numpy(x), torch.from_numpy(init)
    B, M = x.shape
    xp = torch.cat([x, torch.full((B, lw + 1), -1, dtype=torch.int32)], 1)
    state = torch.where((x >= 0) & (x != h._r_iw), init, -1)
    hit = torch.zeros(B, dtype=torch.bool)
    for d in range(lw):
        c = xp[:, d : d + M]
        gated = (d >= pt.max_token_length) & (c != h._r_iw)
        hit |= ((state == s0) & (c >= 0) & (b0 + c < 0) & ~gated).any(1)
        state = torch.where(gated, -1, lexer.comb_lookup(pt, state, c)[0])
    return hit.numpy()


def _transition_walk(pt, x, init, lw):
    """(fin_pos, fin_ow) of the comb walk by the automaton's own
    transitions (TransitionIndex; an explicitly DEAD one ends the walk)."""
    h = _port(comb=True)
    trans = TransitionIndex(h.wbd.aut)
    final, moore = h.wbd.aut.final, h.wbd.aut.moore_ow
    B, M = x.shape
    fin_pos = np.full((B, M), -1, np.int32)
    fin_ow = np.full((B, M), -1, np.int32)
    for b in range(B):
        for p in range(M):
            s = int(init[b, p]) if x[b, p] >= 0 and x[b, p] != h._r_iw else -1
            for d in range(lw):
                c = int(x[b, p + d]) if p + d < M else -1
                if s < 0 or c < 0:
                    break
                s = max(trans.step(s, c)[0], -1)
                if d >= pt.max_token_length and c != h._r_iw:
                    s = -1
                if s >= 0 and final[s]:
                    fin_pos[b, p], fin_ow[b, p] = p + d, moore[s]
    return fin_pos, fin_ow


def _hold_comb(pt, jt, x, init, lw) -> np.ndarray:
    """The port's comb pass: equal to JAX's on every row where JAX's clamp
    does not false-hit; on the others its walk equals the automaton's.
    Returns the port's lanes and asserts which rows false-hit."""
    got = _port_comb(pt, x, init, lw)
    fh = _comb_false_hits(pt, x, init, lw)
    np.testing.assert_array_equal(got[~fh], _jax_comb(jt, x, init, lw)[~fh])
    if fh.any():
        r = np.flatnonzero(fh)
        walk = lexer._walk_comb_plain(pt, torch.from_numpy(x[r]),
                                      torch.from_numpy(init[r]),
                                      _port(comb=True)._r_iw, lw)
        for a, b in zip(walk, _transition_walk(pt, x[r], init[r], lw)):
            np.testing.assert_array_equal(a.numpy(), b)
    return got, fh


def _edge(comb: bool):
    h = _port(comb)
    x, fn = testing.wp_edge_rows(h._l_iw, h._r_iw, h._map_raw)
    init = np.where(fn >= 0, h._fn2ini[np.clip(fn, 0, len(h._fn2ini) - 1)],
                    -1).astype(np.int32)
    return x, init


# ------------------------------------------------------------------ (a)


def test_lexer_tables_match_jax():
    p, j = _port(), _jax()
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(p.tables, f)),
                                      np.asarray(getattr(j.tables, f)), f)
    assert p.tables.any_iw == int(j.tables.any_iw)
    assert p.tables.n_slots == j.tables.n_slots
    assert p.tables.max_token_length == j.tables.max_token_length == 300
    assert (p._l_iw, p._r_iw, p._n_iws) == (j._l_iw, j._r_iw, j._n_iws)


def test_make_dense_sub_matches_jax():
    p, j = _port(), _jax()
    assert p._dense is not None and j._dense is not None
    for a, b in zip(p._dense[:2], j._dense[:2]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(p._dense[2], j._dense[2])
    assert p._dense[3:] == j._dense[3:]
    n_f, n_reach = p._dense[3:]
    assert 0 < n_f < n_reach and p._dense[0].numel() == n_reach * p._n_iws


def test_pack_safety_matches_jax():
    assert _port().available() and _jax().available()
    # a sub-function with an IW_ANY rule is not pack-safe: both packages
    # say so, and the port refuses to run it
    grammar = (testing.BERT_GRAMMAR + "\n_function FnTokWord\n"
               " < ^ [a]+ > --> WORD_ID_100\n < . > --> WORD_ID_101\n_end\n")
    tags = dict(testing.BERT_TAGSET, WORD_ID_100=100, WORD_ID_101=101)
    blob = compile_lex_model(grammar, tags)
    p = WordPieceHybrid(load_bytes(blob, use_cache=False), device="cpu")
    assert not p.available()
    assert not JaxHybrid(jax_load_bytes(blob, use_cache=False)).available()
    with pytest.raises(NotImplementedError, match="WordPieceTpu"):
        p.encode_corpus_flat([b"a b"])


def test_declined_dense_table_takes_the_comb_pass():
    h = _port(comb=True)
    assert h._dense is None and h.available()
    np.testing.assert_array_equal(h._fn2ini[1:][h._fn2ini[1:] >= 0],
                                  [s for s in h.engine.fn2ini[1:] if s >= 0])


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
def test_dense_pass_matches_jax_on_dispatch_rows(cls):
    px, pinit, class_rows = _packed()
    lo, hi, lw = class_rows[cls]
    assert lw == LW_CLASSES[cls] + 2 and hi - lo > 0
    x, init = px[lo:hi], pinit[lo:hi]
    got = _port_dense(_port().tables, x, init, lw)
    want = _jax_dense(_jax().tables, x, init, lw)
    np.testing.assert_array_equal(got, want)
    assert got[:, 128].sum() > 0


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
def test_comb_pass_matches_jax_on_dispatch_rows(cls):
    px, pinit, class_rows = _packed(comb=True)
    lo, hi, lw = class_rows[cls]
    x, init = px[lo:hi], pinit[lo:hi]
    got, fh = _hold_comb(_port(comb=True).tables, _jax().tables, x, init, lw)
    assert not fh.any()
    # the comb and the dense walk find the same matches
    dpx, dpinit, _c = _packed()
    np.testing.assert_array_equal(
        got, _port_dense(_port().tables, dpx[lo:hi], dpinit[lo:hi], lw))


@pytest.mark.parametrize("lw", [18, 42])
@pytest.mark.parametrize("mode", ["dense", "comb"])
def test_passes_match_jax_on_edge_rows(mode, lw):
    x, init = _edge(mode == "comb")
    if mode == "dense":
        got = _port_dense(_port().tables, x, init, lw)
        np.testing.assert_array_equal(
            got, _jax_dense(_jax().tables, x, init, lw))
    else:
        # the seeded random rows reach the FnTokWord state, which owns
        # slot 0, with dense symbol 0 (IW_ANY's id)
        got, fh = _hold_comb(_port(comb=True).tables, _jax().tables, x,
                             init, lw)
        assert fh.any()
        # the dense walk has no clamp: both walks find the same matches
        np.testing.assert_array_equal(
            got, _port_dense(_port().tables, *_edge(False), lw))
    # the row of four 30-symbol units, R anchor in column 127, is covered
    # up to its last character (column 126, content coordinate 125)
    to = (got[2, : got[2, 128]] >> 24) & 0x7F
    assert got[2, 128] > 0 and to.max() == 125
    assert (got[1] == 0).all()  # all -1: nothing emitted


def _limit_tables(jt, pt):
    """Every action nested at the largest tag: lanes fill all their bits."""
    tag = (1 << 17) - 2
    n = pt.act_tag.numel()
    jt = dataclasses.replace(jt, act_tag=jnp.full(n, tag, jnp.int32),
                             act_fn=jnp.full(n, 7, jnp.int32))
    pt = dataclasses.replace(pt, act_tag=torch.full((n,), tag, dtype=torch.int32),
                             act_fn=torch.full((n,), 7, dtype=torch.int32))
    return jt, pt


def test_lane_packing_at_field_limits():
    jt, pt = _limit_tables(_jax().tables, _port().tables)
    x, init = _edge(False)
    got = _port_dense(pt, x, init, 42)
    np.testing.assert_array_equal(got, _jax_dense(jt, x, init, 42))
    lanes = got[2, : got[2, 128]]
    assert (lanes < 0).all()  # bit 31: nested
    assert ((lanes & 0x1FFFF) == (1 << 17) - 1).all()
    assert ((lanes >> 24) & 0x7F).max() == 125
    assert ((lanes >> 17) & 0x7F).max() >= 96


@pytest.mark.parametrize("mode", ["dense", "comb"])
def test_token_length_gate_matches_jax(mode):
    jt = dataclasses.replace(_jax().tables, max_token_length=3)
    if mode == "dense":
        px, pinit, class_rows = _packed()
        pt = dataclasses.replace(_port().tables, max_token_length=3)
        run_p, run_j = _port_dense, _jax_dense
    else:
        px, pinit, class_rows = _packed(comb=True)
        pt = dataclasses.replace(_port(comb=True).tables, max_token_length=3)
        run_p, run_j = _port_comb, _jax_comb
    lo, hi, lw = class_rows[0]
    x, init = px[lo:hi], pinit[lo:hi]
    got = run_p(pt, x, init, lw)
    if mode == "dense":
        np.testing.assert_array_equal(got, run_j(jt, x, init, lw))
    else:
        assert not _hold_comb(pt, jt, x, init, lw)[1].any()
    # the gate cuts long matches short: the lanes differ from the ungated
    assert (got != run_p(_port(mode == "comb").tables, x, init, lw)).any()


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
def test_plain_passes_note_the_entries_they_read(cls):
    """kernels.Reads, which chip_smoke's byte bounds count: the dense and
    the comb walk take the same live steps and reach the same actions, and
    each table entry counts once."""
    (px, pinit, rows), (cx, cinit, _c) = _packed(), _packed(comb=True)
    lo, hi, lw = rows[cls]
    d, c = _port(), _port(comb=True)
    dnext, ow_perm, _p, n_f, _n = d._dense
    rd, rc = kernels.Reads(), kernels.Reads()
    got = lexer._pass_dense_plain(
        d.tables, dnext, ow_perm, torch.from_numpy(px[lo:hi]),
        torch.from_numpy(pinit[lo:hi]), d._l_iw, d._r_iw, lw, n_f, d._n_iws,
        reads=rd)
    np.testing.assert_array_equal(
        got, _port_dense(d.tables, px[lo:hi], pinit[lo:hi], lw))
    lexer._pass_comb_plain(c.tables, torch.from_numpy(cx[lo:hi]),
                           torch.from_numpy(cinit[lo:hi]), c._l_iw, c._r_iw,
                           lw, reads=rc)
    assert rd.steps == rc.steps > 0
    for name in ("act_right", "act_tag", "act_fn"):
        assert rd.entries(name) == rc.entries(name) > 0
    assert rd.entries("ow_perm") <= n_f and rd.entries("dnext") <= rd.steps
    assert rc.entries("nxt") <= rc.entries("owner") <= rd.steps
    assert rd.table_bytes() == 4 * sum(rd.entries(k) for k in (
        "dnext", "ow_perm", "act_right", "act_tag", "act_fn"))
    assert rc.entries("final") > 0 and rc.table_bytes() < 4 * 8 * rd.steps


# ------------------------------------------------------------------ (c)


def _analyze(rt, nh, docs, cache):
    B = len(docs)
    off = np.zeros(B + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=off[1:])
    counts = np.zeros(5, np.int64)
    h = rt.BtlWpAnalyzeC(cache, ctypes.c_void_p(nh), ctypes.c_char_p(b"".join(docs)),
                         off.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(B),
                         ctypes.c_int(wp_hybrid.MAX_UNIT),
                         counts.ctypes.data_as(ctypes.c_void_p))
    assert h
    U, S = int(counts[0]), int(counts[1])
    syms, soff, fn = (np.zeros(max(S, 1), np.int32), np.zeros(U + 1, np.int32),
                      np.zeros(max(U, 1), np.int32))
    rt.BtlWpUnits(ctypes.c_void_p(h), syms.ctypes.data_as(ctypes.c_void_p),
                  soff.ctypes.data_as(ctypes.c_void_p),
                  fn.ctypes.data_as(ctypes.c_void_p))
    return h, counts, syms[:S], soff, fn[:U]


def _stitch(rt, h, rows, u_row, u_off, docs):
    B = len(docs)
    cap = sum(map(len, docs)) + B + 16
    ids = np.zeros(cap, np.int32)
    bounds = np.zeros(B + 1, np.int64)
    need = np.zeros(B, np.uint8)
    t = rt.BtlWpStitch(
        ctypes.c_void_p(h), rows.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(rows)), ctypes.c_int(rows.shape[1]),
        u_row.ctypes.data_as(ctypes.c_void_p),
        u_off.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(UNK),
        ids.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
        bounds.ctypes.data_as(ctypes.c_void_p),
        need.ctypes.data_as(ctypes.c_void_p))
    rt.BtlWpFree(ctypes.c_void_p(h))
    assert t >= 0
    return ids[:t], bounds, need


def test_native_runtime_matches_jax_library():
    p, j = _port(), _jax()
    rts = (p._rt, j._rt)
    assert rts[0] is not rts[1]
    handles = (p._nh, j._nh)
    caches = (rts[0].BtlWpCacheNew(), rts[1].BtlWpCacheNew())
    docs = _docs()
    n_fb = 0
    for batch in (docs[: len(docs) // 2], docs[len(docs) // 3 :]):
        got = [_analyze(rt, nh, batch, c)
               for rt, nh, c in zip(rts, handles, caches)]
        for a, b in zip(got[0][1:], got[1][1:]):
            np.testing.assert_array_equal(a, b)
        h0, _c, syms, soff, fn = got[0]
        px, pinit, class_rows, u_row, u_off = p._pack(syms, soff, fn)
        rows = np.zeros((len(px), 130), np.int32)
        for lo, hi, lw in class_rows:
            rows[lo:hi] = _port_dense(p.tables, px[lo:hi], pinit[lo:hi], lw)
        out = [_stitch(rt, g[0], rows, u_row, u_off, batch)
               for rt, g in zip(rts, got)]
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        n_fb += int(out[0][2].sum())
    assert n_fb > 0
    stats = []
    for rt, c in zip(rts, caches):
        s = np.zeros(4, np.int64)
        rt.BtlWpCacheStats(ctypes.c_void_p(c), s.ctypes.data_as(ctypes.c_void_p))
        rt.BtlWpCacheFree(ctypes.c_void_p(c))
        stats.append(s)
    np.testing.assert_array_equal(*stats)
    buf = np.zeros((2, 1 << 14), np.int32)
    for d in docs:
        n = [rt.TextToIds(ctypes.c_void_p(nh), ctypes.c_char_p(d),
                          ctypes.c_int(len(d)),
                          b.ctypes.data_as(ctypes.c_void_p),
                          ctypes.c_int(b.size), ctypes.c_int(UNK))
             for rt, nh, b in zip(rts, handles, buf)]
        assert n[0] == n[1] and (buf[0, : n[0]] == buf[1, : n[1]]).all(), d


def test_native_runtime_default_models_match_jax_library():
    """The compiled-in default wbd/sbd (the copied models_data) behave as
    the JAX package's library does."""
    rts = (native.get_runtime(), jax_native.get_runtime())
    out = ctypes.create_string_buffer(1 << 14)
    for d in [s.encode("utf-8") for s in full_corpus()[:80]]:
        res = []
        for rt in rts:
            for fn in (rt.TextToWords, rt.TextToSentences):
                n = fn(ctypes.c_char_p(d), ctypes.c_int(len(d)), out,
                       ctypes.c_int(len(out)))
                res.append(out.raw[: max(n, 0)])
        assert res[:2] == res[2:], d


def test_native_runtime_builds_under_build_dir():
    path = native.runtime_lib_path()
    assert native.get_runtime() is native.get_runtime()
    assert "build" in path.split("/") and path.endswith(".so")


# ------------------------------------------------------------------ (d)


@pytest.mark.parametrize("comb", [False, True], ids=["dense", "comb"])
def test_encode_corpus_flat_matches_jax_and_oracle(comb):
    docs = _docs()
    c = metrics.Counters()
    ids, bounds = _port(comb).encode_corpus_flat(docs, unk_id=UNK,
                                                 batch_docs=150, counters=c)
    jids, jbounds = _jax().encode_corpus_flat(docs, unk_id=UNK, batch_docs=150)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(bounds, jbounds)
    assert c.batches >= 2 and c.dispatched_rows > 0 and c.fallback_docs > 0
    assert c.tokens_out == len(ids) and (ids == UNK).any()
    oracle = LexerOracleApi(_port().model)
    for i, d in enumerate(docs):
        assert ids[bounds[i] : bounds[i + 1]].tolist() == oracle.text_to_ids(
            d, unk_id=UNK), (i, d[:40])


def test_text_to_ids_batch_and_empty_corpus():
    h = _port()
    docs = [b"hello world", b"", "naïve café".encode(), b"a\xffb"]
    got = h.text_to_ids_batch(docs, unk_id=UNK)
    oracle = LexerOracleApi(h.model)
    assert got == [oracle.text_to_ids(d, unk_id=UNK) for d in docs]
    # the public dispatch/collect pair gives the same flat result
    ids, bounds, n_fb = h.collect(h.dispatch(docs), UNK, docs)
    assert n_fb == 0 and [ids[bounds[i] : bounds[i + 1]].tolist()
                          for i in range(len(docs))] == got
    ids, bounds = h.encode_corpus_flat([])
    assert len(ids) == 0 and bounds.tolist() == [0]
