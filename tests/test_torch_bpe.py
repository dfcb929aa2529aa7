"""The port's plain walk and resolve (blingfire_tpu_torch/ops/bpe.py) against
the JAX package's bpe_walk and _resolve_impl, on packed unit rows from the
native unit analysis, in all three row regions, and on the classic doc rows
of a model that is not chunk-safe; in the trie and comb table modes and in
the plain, merge-priority and rank modes.  Integers compare exactly.

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
from blingfire_tpu.runtime.host import SpTokenizer as JaxSpTokenizer
from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.compiler.dict import (DictModelSpec, VocabEntry,
                                               compile_dict_model)
from blingfire_tpu_torch.formats.consts import SP_DELIMITER, TokAlgo
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import bpe
from blingfire_tpu_torch.ops.tables import build_comb_table, build_trie_table
from blingfire_tpu_torch.runtime.host import SpTokenizer, _max_token_len

N = 128
REGIONS = [(0, 8, True), (1, 16, True), (2, 16, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain claim is a loop of small torch ops; beside the suite's
    other workers, intra-op threads only contend for the cores (a 0.4 s
    claim test took 53 s with them).  tests/test_torch_resolve.py imports
    this fixture too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    nu = native.units_analyze(_docs(), N, tok._sym2iw, spm_iw, True, False,
                              None)
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


def _tables_pair(blob: bytes, comb_mode: bool):
    """The port's and the JAX package's BPE tables of one model, in trie or
    comb mode (comb: as if the trie were over its budget)."""
    pm = load_bytes(blob).seg
    jm = jax_load_bytes(blob).seg
    max_len = _max_token_len(pm.aut)
    pc, jc = build_comb_table(pm.aut), jax_comb(jm.aut)
    kw = dict(max_len=max_len, fast=True,
              with_merges=pm.tok_algo == TokAlgo.BPE_OPT_WITH_MERGES)
    pt = bpe.make_device_tables(
        pc, pm.i2info_ids, pm.i2info_scores, id_offset=pm.id_offset,
        trie=None if comb_mode else build_trie_table(pc, pm.i2info_ids,
                                                     pm.i2info_scores),
        device="cpu", **kw)
    jt = jax_bpe.make_device_tables(
        jc, jm.i2info_ids, jm.i2info_scores, id_offset=jm.id_offset,
        trie=None if comb_mode else jax_trie(jc, jm.i2info_ids,
                                             jm.i2info_scores), **kw)
    return pt, jt, pc


def _clamp_false_hits(comb, x, ln, LW):
    """bool per row: JAX's comb walk, which clamps the probe base[s] + c into
    the table (bpe.py:307), takes a transition there that the guarded walk
    does not (ROADMAP.md section C item 1).  A replay of both walks."""
    B, N = x.shape
    base, owner, nxt = (np.asarray(a) for a in (comb.base, comb.owner, comb.nxt))
    xp = np.concatenate([x, np.full((B, LW + 1), -1, np.int32)], axis=1)
    valid = np.arange(N)[None, :] < ln[:, None]
    state = np.where(valid & (x >= 0), 0, -1)
    diff = np.zeros((B, N), bool)
    for d in range(LW):
        c = xp[:, d : d + N]
        live = (state >= 0) & (c >= 0)
        raw = base[np.maximum(state, 0)] + np.maximum(c, 0)
        sl = np.clip(raw, 0, comb.n_slots - 1)
        own = live & (owner[sl] == state)
        hit = own & (raw >= 0) & (raw < comb.n_slots)
        diff |= own & ~hit
        state = np.where(hit, nxt[sl], -1)
    return diff.any(axis=1)


RANK_MODELS = {"units": 0, "classic": 40}  # kind -> ▁w1▁w2 pair pieces


@functools.lru_cache(maxsize=None)
def _rank_setup(kind: str, comb_mode: bool):
    """A SentencePiece-BPE-shaped merges model (rank mode) at 2,000 entries:
    chunk-safe (no pair pieces) with its rows in the three unit regions, or
    not chunk-safe with the classic doc rows of the corpus."""
    blob = testing.spm_bpe_shaped_model_bytes(2000, n_cjk=20,
                                              n_pairs=RANK_MODELS[kind])
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    pt, jt, comb = _tables_pair(blob, comb_mode)
    assert bpe.rank_mode(pt) and (pt.trie_next is None) == comb_mode
    docs = _docs()
    if kind == "units":
        assert tok._chunk_safe
        nu = native.units_analyze(docs, N, tok._sym2iw, tok._spm_iw, False,
                                  False, tok.seg.charmap)
        b = [0, nu.split_rows1, nu.split_rows, nu.n_rows]
        rows = [(nu.px[b[i]:b[i + 1]].copy(), nu.plen[b[i]:b[i + 1]].copy(),
                 lw, bounded) for i, lw, bounded in REGIONS]
        nu.close()
    else:
        assert not tok._chunk_safe
        x, ln, _status = tok._prep_batch(docs)
        keep = ln > 0
        rows = [(x[keep], ln[keep], None, False)]
    return tok, pt, jt, comb, rows


def _docs():
    # plus punctuation runs longer than the depth-16 walk (region B's
    # unbounded walk must see live states at its cap)
    return [d.encode("utf-8") for d in full_corpus()] + [
        b"see " + bytes([c]) * k + b" end" for c in testing.LONG_CHARS[:4]
        for k in (17, 19, 30)]


@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_plain_walk_matches_jax(region, lw, bounded):
    tok, jt, spm_iw, x, ln = _region(TokAlgo.BPE_OPT, region)
    m_pack, _m_rank, so = _jax_walk(jt, x, ln, spm_iw, lw, bounded)
    p_pack, p_rank, p_so = bpe.bpe_walk(tok.tables, torch.from_numpy(x),
                                        torch.from_numpy(ln), spm_iw, lw=lw,
                                        bounded=bounded)
    assert p_rank is None  # no ranks outside rank mode
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
    assert got[1] is None and want[1] is None
    for g, w in zip(got[::2], want[::2]):
        assert torch.equal(g, w)
    n_match = int((got[0] >= 0).sum())
    assert 0 < n_match <= r.steps and 0 < r.entries("trie_next") < r.steps
    assert r.table_bytes() == 4 * r.entries("trie_next")


def _jax_resolve(monkeypatch, gather: str, jt, m_pack, m_rank, so, x, ln,
                 spm_iw, a_max):
    monkeypatch.setenv("BTL_GATHER", gather)
    # a new function object a branch: jax.jit keeps its traces per function
    # object, so a jit of _resolve_impl itself would reuse the other branch's
    fn = jax.jit(functools.wraps(jax_bpe._resolve_impl)(
        lambda *a, **k: jax_bpe._resolve_impl(*a, **k)),
        static_argnames=("a_max",))
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
        tok.tables, torch.from_numpy(np.array(m_pack)), None,
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
    m, mr, so = bpe.bpe_walk(tok.tables, xt, lt, spm_iw, lw=16, bounded=True)
    res = bpe.bpe_resolve(tok.tables, m, mr, so, xt, lt, spm_iw, 0, tok.a_max)
    for a, b in zip(seg, res):
        assert torch.equal(a, b)


def test_comb_and_rank_modes_walk_and_resolve():
    """The modes that raised before PR 6 run: the comb walk and the rank
    mode give the trie-mode ids of the same model; -1 still cannot name ▁."""
    tok, pt, _jt, _c, rows = _rank_setup("classic", True)
    x, ln, _lw, _b = rows[0]
    xt, lt = torch.from_numpy(x), torch.from_numpy(ln)
    comb_ids = bpe.bpe_segment(pt, xt, lt, tok._spm_iw, 0, tok.a_max)
    trie_ids = bpe.bpe_segment(tok.tables, xt, lt, tok._spm_iw, 0, tok.a_max)
    assert tok.tables.trie_next is not None and bpe.rank_mode(tok.tables)
    for a, b in zip(comb_ids, trie_ids):
        assert torch.equal(a, b)
    # -1 means "no symbol" in x_iw, so it cannot name ▁
    with pytest.raises(ValueError, match="spm_iw"):
        bpe.bpe_walk(tok.tables, xt, lt, -1, lw=8)
    with pytest.raises(ValueError, match="unk_id"):
        bpe.bpe_segment(tok.tables, xt, lt, tok._spm_iw, 1 << 20, tok.a_max)


def _rows(kind):
    return [(kind, i) for i in range(len(REGIONS) if kind == "units" else 1)]


@pytest.mark.parametrize("comb_mode", [False, True], ids=["trie", "comb"])
@pytest.mark.parametrize("kind,row", _rows("units") + _rows("classic"))
def test_rank_mode_walk_matches_jax(kind, row, comb_mode):
    """m_pack and slot_overflow lane for lane, m_rank wherever a match ends
    (JAX writes a rank at every lane), on rows where JAX's comb clamp takes
    no transition that the automaton lacks; the seeded model's root has
    base 0, so there are none."""
    tok, pt, jt, comb, rows = _rank_setup(kind, comb_mode)
    x, ln, lw, bounded = rows[row]
    m_pack, m_rank, so = _jax_walk(jt, x, ln, tok._spm_iw, lw, bounded)
    p_pack, p_rank, p_so = bpe.bpe_walk(pt, torch.from_numpy(x),
                                        torch.from_numpy(ln), tok._spm_iw,
                                        lw=lw, bounded=bounded)
    LW = bpe._walk_depth(pt, lw)
    assert not (comb_mode and _clamp_false_hits(comb, x, ln, LW).any())
    m_pack, m_rank = np.asarray(m_pack), np.asarray(m_rank)
    np.testing.assert_array_equal(p_pack.numpy(), m_pack)
    np.testing.assert_array_equal(p_so.numpy(), np.asarray(so))
    hit = m_pack >= 0
    assert hit.any() and (p_rank.numpy()[~hit] == 0).all()
    np.testing.assert_array_equal(p_rank.numpy()[hit], m_rank[hit])


def _ref_order(r: np.ndarray) -> np.ndarray:
    """The reference's arc order by rank alone: descending float compare,
    -0.0 == +0.0, stable (float64 sort of the negated ranks)."""
    return np.argsort(-r.astype(np.float64), kind="stable")


def test_float_desc_key_orders_as_the_reference():
    tiny = np.float32(np.finfo(np.float32).tiny)
    sub = np.float32(1e-45)  # the least subnormal
    fmax = np.finfo(np.float32).max
    sweep = np.array([0.0, -0.0, 1.0, -1.0, sub, -sub, tiny, -tiny, fmax,
                      -fmax, np.inf, -np.inf, -2.0, -0.5, 3.5, -1e-30, 1e30,
                      -4.0, -3.0, -5.0], np.float32)
    rng = np.random.default_rng(4)
    r = np.concatenate([sweep, rng.normal(0, 10, 200).astype(np.float32),
                        -np.abs(rng.normal(0, 10, 200)).astype(np.float32)])
    key = bpe.float_desc_key(torch.from_numpy(r)).numpy()
    assert key.dtype == np.int32
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(r[order], r[_ref_order(r)])
    # -0.0 and +0.0 tie; +0.0 comes before every negative rank
    k0, kn0 = key[0], key[1]
    assert k0 == kn0 and (key[r < 0] > k0).all() and (key[r > 0] < k0).all()
    # JAX's key agrees where every rank is negative (-0.0 included)
    neg = r[np.signbit(r)]
    jkey = np.asarray(jax_bpe._float_desc_key(jax.numpy.asarray(neg)))
    assert (np.sign(np.subtract.outer(jkey.astype(np.int64), jkey))
            == np.sign(np.subtract.outer(
                bpe.float_desc_key(torch.from_numpy(neg)).numpy().astype(np.int64),
                bpe.float_desc_key(torch.from_numpy(neg)).numpy()))).all()
    # and puts +0.0 after every negative rank, which the reference does not
    jk = np.asarray(jax_bpe._float_desc_key(jax.numpy.asarray(
        np.array([0.0, -1.0], np.float32))))
    assert jk[0] > jk[1]


RANK_FAULT_DOCS = [b"aqq b", b"b aqqq", b"baqqb", b"aq b", b"ab a"]


def test_rank_fault_model_follows_the_reference():
    """testing.rank_fault_model_bytes: unknown q runs that a real piece ends
    inside.  The port equals the scalar oracle and the native TextToIds on
    both paths; JAX's rank key claims the unknown arc last and differs."""
    blob = testing.rank_fault_model_bytes()
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    assert bpe.rank_mode(tok.tables) and tok._chunk_safe
    want = [tok._oracle.text_to_ids(d) for d in RANK_FAULT_DOCS]
    assert want[:3] == [[7, 0, 3, 5], [3, 5, 7, 0], [3, 5, 4, 0, 5]]
    assert [tok._fallback_ids(d, 0) for d in RANK_FAULT_DOCS] == want
    assert tok.encode_batch(RANK_FAULT_DOCS, dedup=False) == want
    assert tok.encode_batch(RANK_FAULT_DOCS) == want
    jtok = JaxSpTokenizer(jax_load_bytes(blob), max_doc_symbols=N)
    got = jtok.encode_batch(RANK_FAULT_DOCS, dedup=False)
    assert got[:3] == [[3, 6, 3, 5], [3, 5, 3, 6], [3, 5, 6, 5]]
    assert got[3:] == want[3:]


def _slot0_bpe_blob() -> bytes:
    """A merges model whose lowest symbol a never starts a piece, and no ▁:
    the comb root owns slot 0 with base -1, so JAX's clamped probe of a lone
    a takes the root's b transition."""
    a, b, c, d = 0x61, 0x62, 0x63, 0x64
    vocab = [(b,), (c,), (d,), (b, a), (c, a), (d, a, b)]
    return compile_dict_model(DictModelSpec(
        entries=[VocabEntry(ch, 3 + i, -float(i)) for i, ch in enumerate(vocab)],
        tok_algo=TokAlgo.BPE_OPT_WITH_MERGES, id_offset=0,
        use_byte_encoding=False))


def test_guarded_comb_walk_where_jax_clamps():
    """On rows where JAX's comb clamp false-hits (found by replaying its
    walk), the port's ids equal the oracle and the native runtime and JAX's
    walk differs; on the other rows the port equals JAX lane for lane.  The
    model's alphabet lacks ▁, so the rows' ▁ weight is one no symbol has."""
    blob = _slot0_bpe_blob()
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    pt, jt, comb = _tables_pair(blob, True)
    s0, probes = testing.slot0_probes(comb)
    assert s0 == 0 and probes == [0]
    assert SP_DELIMITER >= len(tok._sym2iw) or tok._sym2iw[SP_DELIMITER] < 0
    docs = [b"a", b"ab", b"ba", b"cab", b"dab a", b"bb cc", b"a a b", b"dd"]
    x, ln, _status = tok._prep_batch(docs)
    LW = bpe._walk_depth(pt, None)
    bad = _clamp_false_hits(comb, x, ln, LW)
    assert bad.any() and not bad.all()
    m_pack, m_rank, so = _jax_walk(jt, x, ln, tok._spm_iw, None, False)
    p_pack, p_rank, p_so = bpe.bpe_walk(pt, torch.from_numpy(x),
                                        torch.from_numpy(ln), tok._spm_iw)
    m_pack = np.asarray(m_pack)
    np.testing.assert_array_equal(p_pack.numpy()[:, ~bad], m_pack[:, ~bad])
    assert (p_pack.numpy()[:, bad] != m_pack[:, bad]).any()
    ids = [t.numpy() for t in bpe.bpe_resolve(
        pt, p_pack, p_rank, p_so, torch.from_numpy(x), torch.from_numpy(ln),
        tok._spm_iw, 0, tok.a_max)]
    for i, d in enumerate(docs):
        got = ids[0][i, : ids[3][i]].tolist()
        assert got == tok._oracle.text_to_ids(d) == tok._fallback_ids(d, 0)
    assert tok.encode_batch(docs) == [tok._oracle.text_to_ids(d) for d in docs]
