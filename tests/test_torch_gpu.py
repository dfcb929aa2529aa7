"""The port's kernels against their plain versions on the card: the four of
the byte-BPE path, K1 and K2 in the comb and rank modes of the classic
doc-row path (and that path against the CPU), K5 unigram_walk and K6 unigram_viterbi in every row
region and table mode, K6 also on testing.unigram_lane_edge_rows (every
lane-group shape, L past a warp) and on random arcs at the widths where
its launcher widens a group, K4 pack_out_compact at widths 1 to 1,024
(aligned or not), the WordPiece pass (K7 dense, K8 comb, K3 on the
dense sub-grammar; K7 and K8 also in one launch over both length classes;
K8 on main-wc's batch, on the small multilingual-bert-shaped fixture, from
states with a negative base, on the unknown symbol and with a short
token-length gate),
K5 at the depths around its 32-depth chunks (testing.unigram_deep_rows),
and K9 lexer_pass of the pattern lexer on the shipped
wbd and sbd models (also at 4,098 and 16,386 lanes), and K10 hyph_segment on syllab-shaped W2H models (also
packed: every tile shape, every bucket in one launch); K5,
K8 and K10 also on a lookup below slot 0, where the JAX package's clamp
takes a transition that the automaton does not have; K11 pack_out (at
widths 1 to 1,024, aligned or not) and K12 shard_stats (also at row
counts around a warp and past a wave's spans), K2 on the seeded
edge rows of testing.resolve_edge_rows in its three modes, K2's marking mode
there and on region B's unit rows, and the routes
of a window of 2,048 symbols on the card against the CPU.

Marked ``gpu``: each test decides in its body whether a CUDA device is
present and skips there without one (the collected set never depends on the
machine).  On the card: ``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.compiler.dict import (DictModelSpec, VocabEntry,
                                               compile_dict_model)
from blingfire_tpu_torch.formats.consts import TokAlgo
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import bpe, hyph, lexer, unigram
from blingfire_tpu_torch.ops.tables import build_comb_table
from blingfire_tpu_torch.parallel import mesh
from blingfire_tpu_torch.runtime import dedup, host, metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer
from blingfire_tpu_torch.runtime.hyph import HyphTpu
from blingfire_tpu_torch.runtime.lexer_host import (LexerTpu, WordsTpu,
                                                    decode_utf8)
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

pytestmark = pytest.mark.gpu
REGIONS = [(0, 8, True), (1, 16, True), (2, 16, False)]
MODES = ["dense", "wide", "comb"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")


@functools.lru_cache(maxsize=1)
def _setup():
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cuda")
    runner = tok._unit_runner()
    docs = [d.encode("utf-8") for d in full_corpus()] + [
        b"see " + bytes([c]) * k for c in testing.LONG_CHARS[:4]
        for k in (17, 30)]
    nu = native.units_analyze(docs, 128, tok._sym2iw, runner.spm_iw, True,
                              False, None)
    b = [0, nu.split_rows1, nu.split_rows, nu.n_rows]
    x = torch.from_numpy(nu.px[: nu.n_rows].copy()).cuda()
    ln = torch.from_numpy(nu.plen[: nu.n_rows].copy()).cuda()
    regions = [(x[b[i]:b[i + 1]], ln[b[i]:b[i + 1]]) for i in range(3)]
    return tok, runner.spm_iw, regions


def test_scatter_trie_kernel_matches_plain():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    size = 1 << 20
    idx = torch.randperm(size, generator=g)[:5000].cuda()
    vals = torch.randint(0, 1 << 20, (5000,), generator=g, dtype=torch.int32).cuda()
    n = kernels.launches["scatter_trie"]
    got = bpe.scatter_trie(idx, vals, size)
    assert kernels.launches["scatter_trie"] == n + 1
    assert torch.equal(got, bpe._scatter_trie_plain(idx, vals, size))


@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_walk_resolve_pack_kernels_match_plain(region, lw, bounded):
    _need_cuda()
    tok, spm_iw, regions = _setup()
    x, ln = regions[region]
    t = tok.tables
    LW = bpe._walk_depth(t, lw)
    m, mr, so = bpe.bpe_walk(t, x, ln, spm_iw, lw=lw, bounded=bounded)
    pm, pmr, pso = bpe._walk_plain(t, x, ln, spm_iw, LW,
                                   t.max_len > LW and not bounded)
    assert mr is None and pmr is None
    assert torch.equal(m, pm) and torch.equal(so, pso)
    res = bpe.bpe_resolve(t, m, None, so, x, ln, spm_iw, 0, tok.a_max)
    pres = bpe._resolve_plain(t, m, None, so, x, ln, spm_iw, 0, tok.a_max)
    for a, b in zip(res, pres):
        assert torch.equal(a, b)
    ids, st, _en, counts, fb = res
    out = dedup.pack_out_compact(ids, st, counts, fb)
    assert torch.equal(out, dedup._pack_out_compact_plain(ids, st, counts, fb))


@pytest.mark.parametrize("rank", [False, True], ids=["trie", "trie_rank"])
def test_bpe_walk_outputs_have_the_plain_layout(rank):
    """K1's outputs on the card have the shape, dtype and contiguity of
    the plain version's and equal it, in trie and trie + rank modes."""
    _need_cuda()
    if rank:
        tok = _spm_tok(False, "cuda", n_pairs=0)
        spm = tok._spm_iw
        x, ln, _status = tok._prep_batch(_spm_docs()[:64])
        x, ln = torch.from_numpy(x).cuda(), torch.from_numpy(ln).cuda()
    else:
        tok, spm, regions = _setup()
        x, ln = regions[1]
    t = tok.tables
    LW = bpe._walk_depth(t, None)
    got = bpe.bpe_walk(t, x, ln, spm)
    want = bpe._walk_plain(t, x, ln, spm, LW, t.max_len > LW)
    assert (got[1] is None) == (not rank)
    for g, w in zip(got, want):
        if g is None:
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape) and g.is_contiguous()
        assert torch.equal(g, w)


def test_encode_corpus_flat_on_the_card_matches_cpu():
    _need_cuda()
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    docs = [d.encode("utf-8") for d in full_corpus()]
    gpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128)
    cpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cpu")
    kernels.reset_launches()
    ids, bounds = gpu.encode_corpus_flat(docs, batch_docs=64)
    assert all(kernels.launches[k] > 0 for k in ("bpe_walk", "bpe_resolve",
                                                 "pack_out_compact"))
    cids, cbounds = cpu.encode_corpus_flat(docs, batch_docs=64)
    assert (ids == cids).all() and (bounds == cbounds).all()


def _force_mode(monkeypatch, mode: str) -> None:
    if mode in ("wide", "comb"):
        monkeypatch.setattr(unigram, "_DENSE_MAX_ENTRIES", 0)
    if mode == "comb":
        monkeypatch.setattr(unigram, "_WIDE_OWNER_SENTINEL", 0)


def _uni_tables(blob: bytes, max_len: int):
    seg = load_bytes(blob, use_cache=False).seg
    return unigram.make_device_tables(
        build_comb_table(seg.aut), seg.i2info_ids, seg.i2info_scores,
        max_len=max_len, id_offset=seg.id_offset, device="cuda")


def _uni_docs():
    return [d.encode("utf-8") for d in full_corpus()]


@functools.lru_cache(maxsize=1)
def _uni_setup():
    blob = testing.xlnet_shaped_model_bytes(4000, n_cjk=100)
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cuda")
    nu = native.units_analyze(_uni_docs(), 128, tok._sym2iw,
                              tok._unit_runner().spm_iw, False, False,
                              tok.seg.charmap)
    b = [0, nu.split_rows1, nu.split_rows, nu.n_rows]
    x = torch.from_numpy(nu.px[: nu.n_rows].copy()).cuda()
    ln = torch.from_numpy(nu.plen[: nu.n_rows].copy()).cuda()
    regions = [(x[b[i]:b[i + 1]], ln[b[i]:b[i + 1]]) for i in range(3)]
    return blob, tok, regions


def _uni_kernels_match_plain(t, x, ln, lw, unk_id):
    L = unigram.walk_depth(t, lw)
    n = kernels.launches["unigram_walk"], kernels.launches["unigram_viterbi"]
    mk, ms = unigram.unigram_walk(t, x, ln, lw=lw)
    pk, ps = unigram._walk_plain(t, x, ln, L)
    assert torch.equal(mk, pk) and torch.equal(ms, ps)
    res = unigram.unigram_viterbi(t, mk, ms, ln, unk_id)
    pres = unigram._viterbi_plain(t, mk, ms, ln, unk_id)
    assert (kernels.launches["unigram_walk"], kernels.launches["unigram_viterbi"]) \
        == (n[0] + 1, n[1] + 1)
    for a, b in zip(res, pres):
        assert torch.equal(a, b)
    return res


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_unigram_kernels_match_plain(monkeypatch, region, lw, bounded, mode):
    _need_cuda()
    blob, tok, regions = _uni_setup()
    _force_mode(monkeypatch, mode)
    t = _uni_tables(blob, tok.max_token_len)
    assert t.mode == MODES.index(mode)
    x, ln = regions[region]
    res = _uni_kernels_match_plain(t, x, ln, lw if bounded else None, 0)
    assert (res[3] > 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_unigram_kernels_on_edge_rows(monkeypatch, mode):
    _need_cuda()
    blob, x, ln = testing.unigram_edge_rows()
    _force_mode(monkeypatch, mode)
    t = _uni_tables(blob, 3)
    for lw in (None, 2):
        _uni_kernels_match_plain(t, torch.from_numpy(x).cuda(),
                                 torch.from_numpy(ln).cuda(), lw, 7)


@pytest.mark.parametrize("mode", MODES)
def test_unigram_kernels_on_lane_edge_rows(monkeypatch, mode):
    """K5 and K6 on testing.unigram_lane_edge_rows: L from 1 to 40 (the
    strided kernel past 32), widths 1, 31, 65 and 200 (16-byte and 4-byte
    arc copies), lengths 0, below N, N and past N, ties between depths."""
    _need_cuda()
    blob, rows = testing.unigram_lane_edge_rows()
    _force_mode(monkeypatch, mode)
    t = _uni_tables(blob, testing.LANE_MAX_LEN)
    for N, lw in testing.LANE_EDGE_CASES:
        x, ln = rows[N]
        _uni_kernels_match_plain(t, torch.from_numpy(x).cuda(),
                                 torch.from_numpy(ln).cuda(), lw, 7)


@pytest.mark.parametrize("B,N,L", [(300, 1024, 15), (300, 1024, 8),
                                   (70, 8000, 1), (40, 8000, 3),
                                   (9, 3000, 34)])
def test_unigram_viterbi_kernel_on_random_arcs(B, N, L):
    """K6 against its plain version on seeded random arcs (about one start
    in five without a match, scores that rarely tie): the main path's
    1,024-wide rows, rows wide enough that the launcher widens the group
    (L = 1 and 3 at N = 8,000), and the strided kernel at L = 34."""
    _need_cuda()
    blob, _rows = testing.unigram_lane_edge_rows()
    t = _uni_tables(blob, testing.LANE_MAX_LEN)
    nkeys = t.ids_tab.numel()
    rng = np.random.default_rng(B * N + L)
    key = rng.integers(0, nkeys, (B, N, L)).astype(np.int32)
    key[rng.random((B, N, L)) < 0.3] = -1
    key[rng.random((B, N)) < 0.2] = -1
    score = np.where(key >= 0, -rng.random((B, N, L)) * 20,
                     np.finfo(np.float32).min).astype(np.float32)
    ln = rng.integers(0, N + 3, B).astype(np.int32)
    ln[:3] = (N, 0, N + 1)
    mk, ms, lnd = (torch.from_numpy(a).cuda() for a in (key, score, ln))
    n = kernels.launches["unigram_viterbi"]
    got = unigram.unigram_viterbi(t, mk, ms, lnd, 5)
    assert kernels.launches["unigram_viterbi"] == n + 1
    want = unigram._viterbi_plain(t, mk, ms, lnd, 5)
    for name, a, b in zip(("ids", "starts", "ends", "counts"), got, want):
        assert torch.equal(a, b), name


def test_unigram_encode_corpus_flat_on_the_card_matches_cpu():
    _need_cuda()
    blob, _tok, _r = _uni_setup()
    gpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128)
    cpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cpu")
    kernels.reset_launches()
    ids, bounds = gpu.encode_corpus_flat(_uni_docs(), batch_docs=64)
    assert all(kernels.launches[k] > 0 for k in kernels.PATHS["unigram"])
    cids, cbounds = cpu.encode_corpus_flat(_uni_docs(), batch_docs=64)
    assert (ids == cids).all() and (bounds == cbounds).all()


def _wp_docs():
    return [d.encode("utf-8") for d in full_corpus()] + \
        testing.zipf_corpus(100_000)[len(testing.EDGE_CASES):][:200]


@functools.lru_cache(maxsize=None)
def _wp(comb: bool, device: str) -> WordPieceHybrid:
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1 if comb else saved
    try:
        blob = testing.bert_shaped_model_bytes(2000)
        return WordPieceHybrid(load_bytes(blob), device=device)
    finally:
        lexer.DENSE_MAX_ENTRIES = saved


def _wp_kernel_matches_plain(h, x, init, lw):
    """One launch of the hybrid's kernel against its plain version, both on
    the card."""
    name = "wp_subword_comb" if h._dense is None else "wp_subword_dense"
    xd, idv = torch.from_numpy(x).cuda(), torch.from_numpy(init).cuda()
    n = kernels.launches[name]
    got = h._device_pass(xd, idv, lw)
    assert kernels.launches[name] == n + 1
    if h._dense is None:
        want = lexer._pass_comb_plain(h.tables, xd, idv, h._l_iw, h._r_iw, lw)
    else:
        dnext, ow_perm, _p, n_f, _n = h._dense
        want = lexer._pass_dense_plain(h.tables, dnext, ow_perm, xd, idv,
                                       h._l_iw, h._r_iw, lw, n_f, h._n_iws)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
@pytest.mark.parametrize("comb", [False, True], ids=["dense", "comb"])
def test_wp_kernels_match_plain(comb, cls):
    _need_cuda()
    h = _wp(comb, "cuda")
    nh, u_syms, u_soff, u_fn = h._analyze(_wp_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    lo, hi, lw = class_rows[cls]
    got = _wp_kernel_matches_plain(h, px[lo:hi], pinit[lo:hi], lw)
    assert int(got[:, 128].sum()) > 0


@pytest.mark.parametrize("comb", [False, True], ids=["dense", "comb"])
def test_wp_kernels_on_edge_rows(comb):
    _need_cuda()
    h = _wp(comb, "cuda")
    x, fn = testing.wp_edge_rows(h._l_iw, h._r_iw, h._map_raw)
    init = np.where(fn >= 0, h._fn2ini[np.clip(fn, 0, len(h._fn2ini) - 1)],
                    -1).astype(np.int32)
    for lw in (18, 42):
        _wp_kernel_matches_plain(h, x, init, lw)


def test_scatter_trie_on_the_dense_sub_grammar():
    _need_cuda()
    h = _wp(False, "cpu")
    idx, vals, _ow, _perm, _nf, n_reach = lexer.dense_sub_edges(
        h.comb, h.wbd.aut.moore_ow, h._inis)
    size = n_reach * h._n_iws
    ti, tv = torch.from_numpy(idx).cuda(), torch.from_numpy(vals).cuda()
    got = bpe.scatter_trie(ti, tv, size)
    assert torch.equal(got, bpe._scatter_trie_plain(ti, tv, size))
    assert torch.equal(got.cpu(), h._dense[0])


def test_wordpiece_encode_corpus_flat_on_the_card_matches_cpu():
    _need_cuda()
    blob = testing.bert_shaped_model_bytes(2000)
    kernels.reset_launches()
    gpu = WordPieceHybrid(load_bytes(blob))
    ids, bounds = gpu.encode_corpus_flat(_wp_docs(), unk_id=100,
                                         batch_docs=64)
    assert kernels.launches["scatter_trie"] > 0
    assert kernels.launches["wp_subword_dense"] > 0
    cids, cbounds = _wp(False, "cpu").encode_corpus_flat(
        _wp_docs(), unk_id=100, batch_docs=64)
    assert (ids == cids).all() and (bounds == cbounds).all()


def _k9_matches_plain(tables, x, init, ext_len):
    """One K9 launch against its plain version, both on the card."""
    n = kernels.launches["lexer_pass"]
    got = lexer.lexer_pass_packed(tables, x, init, ext_len)
    assert kernels.launches["lexer_pass"] == n + 1
    want = lexer.pack5(*lexer._lexer_pass_plain(tables, x, init, ext_len))
    assert torch.equal(got, want)
    return got


@functools.lru_cache(maxsize=None)
def _lex(name: str, device: str) -> LexerTpu:
    return LexerTpu(load_bytes(testing.shipped_lexer_bytes(name)),
                    device=device)


def _lex_docs():
    return [d.encode("utf-8") for d in full_corpus()] + \
        testing.zipf_corpus(60_000)[len(testing.EDGE_CASES):]


@pytest.mark.parametrize("name", ["wbd", "sbd"])
def test_lexer_pass_kernel_matches_plain_at_every_level(name):
    """The rows of every launch of a WordsTpu call, every level and bucket
    width."""
    _need_cuda()
    lex = _lex(name, "cuda")
    decs = [decode_utf8(d) for d in _lex_docs()]
    trace = []
    lex._flat_cache.clear()
    lex.process_docs([np.where(d[0] == 0, 0x20, d[0]) for d in decs
                       if d is not None and len(d[0])], trace=trace)
    assert {t[0] for t in trace} >= {0, 1}
    assert len({t[1] for t in trace}) >= 3
    for _level, _bucket, x, init, elen, _raws in trace:
        _k9_matches_plain(lex.tables, *(torch.from_numpy(a).cuda()
                                        for a in (x, init, elen)))


@pytest.mark.parametrize("name", ["wbd", "sbd"])
def test_lexer_pass_kernel_on_edge_rows(name):
    """Hand-made rows (testing.lexer_edge_rows), also with the token-length
    gate live (max_token_length 3)."""
    _need_cuda()
    lex = _lex(name, "cuda")
    x, init, elen, _raws = testing.lexer_edge_rows(lex)
    args = [torch.from_numpy(a).cuda() for a in (x, init, elen)]
    _k9_matches_plain(lex.tables, *args)
    gated = dataclasses.replace(lex.tables, max_token_length=3)
    _k9_matches_plain(gated, *args)


@pytest.mark.parametrize("width", [4096, lexer.MAX_LEXER_ROW - 2])
@pytest.mark.parametrize("name", ["wbd", "sbd"])
def test_lexer_pass_kernel_on_wide_rows(name, width):
    """K9 at 4,098 and 16,386 lanes on wbd's and sbd's tables:
    testing.lexer_wide_rows (one row matches nowhere, so its FromPos chain
    visits every start) and testing.lexer_edge_rows widened to the
    bucket."""
    _need_cuda()
    lex = _lex(name, "cuda")
    x, init, elen, _raws = testing.lexer_wide_rows(
        lex, width, testing.zipf_corpus(400_000))
    got = _k9_matches_plain(lex.tables, *(torch.from_numpy(a).cuda()
                                          for a in (x, init, elen)))
    assert int(got[len(x) - 2, : width + 2].sum()) == 0
    assert int(got[0, : width + 2].sum()) > 0
    x, init, elen, _raws = testing.lexer_edge_rows(lex, width)
    _k9_matches_plain(lex.tables, *(torch.from_numpy(a).cuda()
                                    for a in (x, init, elen)))


def test_words_and_sentences_on_the_card_match_cpu():
    _need_cuda()
    docs = _lex_docs()
    for name, meth in (("wbd", "text_to_words_batch"),
                       ("sbd", "text_to_sentences_batch")):
        kernels.reset_launches()
        gpu = WordsTpu(load_bytes(testing.shipped_lexer_bytes(name)))
        got = getattr(gpu, meth)(docs)
        assert kernels.launches["lexer_pass"] > 0
        cpu = WordsTpu(load_bytes(testing.shipped_lexer_bytes(name)),
                       device="cpu")
        assert got == getattr(cpu, meth)(docs)


def test_wp_comb_kernel_takes_no_transition_below_slot_0():
    """K8 on lanes of the bert-shaped comb table driven to the state that
    owns slot 0, then given a symbol below that state's base
    (testing.slot0_walks)."""
    _need_cuda()
    h = _wp(True, "cuda")
    ini = int(h._fn2ini[testing.BERT_FN])
    walks, at = testing.slot0_walks(h.comb, ini)
    assert walks
    lw = max(map(len, walks)) + 1
    x = np.full((len(walks), 128), -1, np.int32)
    init = np.full((len(walks), 128), -1, np.int32)
    for r, w in enumerate(walks):
        x[r, : len(w)] = w
        init[r, 0] = ini
    got = _wp_kernel_matches_plain(h, x, init, lw)
    x[:, at] = -1  # no transition: as if the lane met padding
    assert torch.equal(got, _wp_kernel_matches_plain(h, x, init, lw))


@pytest.mark.parametrize("mode", ["wide", "comb"])
def test_unigram_walk_kernel_takes_no_transition_below_slot_0(monkeypatch,
                                                              mode):
    """K5 on testing.unigram_slot0_model_bytes, whose root owns slot 0 with
    base -1: a lone ``a`` at a start has no transition."""
    _need_cuda()
    _force_mode(monkeypatch, mode)
    t = _uni_tables(testing.unigram_slot0_model_bytes(), 3)
    assert t.mode == MODES.index(mode)
    x = torch.tensor([[0, 1, 0, 2], [1, 0, 0, 3]], dtype=torch.int32).cuda()
    ln = torch.tensor([4, 4], dtype=torch.int32).cuda()
    res = _uni_kernels_match_plain(t, x, ln, None, 0)
    mk, _ms = unigram.unigram_walk(t, x, ln)
    assert (mk[0, 0] == -1).all() and (mk[1, 1] == -1).all()
    assert res[3].min() > 0


@functools.lru_cache(maxsize=None)
def _hyph(kind: str, device: str) -> HyphTpu:
    blob = (testing.syllab_shaped_model_bytes(3000) if kind == "small"
            else testing.hyph_slot0_model_bytes())
    return HyphTpu(load_bytes(blob, use_cache=False), device=device)


def _hyph_words():
    docs = [d.encode("utf-8") for d in full_corpus()]
    return testing.corpus_words(docs) + testing.hyph_edge_words()


def _k10_matches_plain(tables, x, wl):
    """One K10 launch against its plain version, both on the card."""
    n = kernels.launches["hyph_segment"]
    got = hyph.hyph_segment(tables, x, wl)
    assert kernels.launches["hyph_segment"] == n + 1
    assert torch.equal(got, hyph._hyph_segment_plain(tables, x, wl))
    return got


@pytest.mark.parametrize("kind", ["small", "slot0"])
def test_hyph_segment_kernel_matches_plain_on_every_launch(kind):
    """The rows of every launch (every bucket width) of a process_batch
    call over the corpus words and the edge words; the slot-0 model's
    apostrophe words die at the apostrophe, as the scalar engine's do."""
    _need_cuda()
    h = _hyph(kind, "cuda")
    trace = []
    h.process_batch(_hyph_words(), trace=trace)
    assert len({t[0] for t in trace}) >= 4
    for _bucket, x, wl, _words in trace:
        _k10_matches_plain(h.tables, torch.from_numpy(x).cuda(),
                           torch.from_numpy(wl).cuda())


@pytest.mark.parametrize("min_pat_len,no_hyph_len", [(2, 0), (3, 2)])
def test_hyph_segment_kernel_on_random_rows(min_pat_len, no_hyph_len):
    """Seeded rows of random symbols, the unmapped sentinel, anchors and
    padding anywhere, and lengths that disagree with the row."""
    _need_cuda()
    h = _hyph("small", "cuda")
    t = dataclasses.replace(h.tables, min_pat_len=min_pat_len,
                            no_hyph_len=no_hyph_len)
    rng = np.random.default_rng(5)
    for B, W in ((64, 24), (7, 300)):
        x = rng.integers(-1, h._n_iws + 1, (B, W + 2)).astype(np.int32)
        x[:, 0] = h._l_iw
        wl = rng.integers(0, W + 1, B).astype(np.int32)
        x[np.arange(B), wl + 1] = h._r_iw
        wl[:3] = [0, W + 3, 1]
        _k10_matches_plain(t, torch.from_numpy(x).cuda(),
                           torch.from_numpy(wl).cuda())


def test_hyph_tpu_on_the_card_matches_cpu():
    _need_cuda()
    words = _hyph_words()
    kernels.reset_launches()
    got = _hyph("small", "cuda").process_batch(words)
    assert kernels.launches["hyph_segment"] > 0
    assert got == _hyph("small", "cpu").process_batch(words)
    assert got[words.index([ord(c) for c in "'ab"])] == [-1, -1, -1]


def _random_rows(h: HyphTpu, rng, B: int, M: int):
    """Seeded rows of random symbols, the unmapped sentinel, anchors and
    padding anywhere, and word lengths that disagree with the row."""
    W = M - 2
    x = rng.integers(-1, h._n_iws + 1, (B, M)).astype(np.int32)
    x[:, 0] = h._l_iw
    wl = rng.integers(0, W + 1, B).astype(np.int32)
    x[np.arange(B), np.minimum(wl + 1, M - 1)] = h._r_iw
    wl[: min(B, 3)] = [0, W + 3, 1][: min(B, 3)]
    return x, wl


def _k10_packed_matches_plain(tables, segs):
    """One packed K10 launch over ``segs`` [(x, wl)] against the plain
    version a segment, both on the card."""
    buf, pk = hyph.pack_rows(segs)
    n = kernels.launches["hyph_segment"]
    out = hyph.hyph_segment_packed(tables, torch.from_numpy(buf).cuda(), pk)
    assert kernels.launches["hyph_segment"] == n + (pk.n_tiles > 0)
    for (x, wl), ops in zip(segs, pk.split(out)):
        assert torch.equal(ops, hyph._hyph_segment_plain(
            tables, torch.from_numpy(x).cuda(), torch.from_numpy(wl).cuda()))


@pytest.mark.parametrize("min_pat_len,no_hyph_len", [(2, 0), (3, 2)])
@pytest.mark.parametrize("M", [2, 3, 18, 34, 66, 130, 302])
def test_hyph_packed_kernel_at_every_tile_shape(M, min_pat_len, no_hyph_len):
    """Random rows at every tile shape (T = max(1, 256 // M) rows a block),
    B not a multiple of T: one segment packed, the same rows through the
    one-segment entry, and the rows split over two segments of a launch."""
    _need_cuda()
    h = _hyph("small", "cuda")
    t = dataclasses.replace(h.tables, min_pat_len=min_pat_len,
                            no_hyph_len=no_hyph_len)
    rng = np.random.default_rng(M)
    B = 3 * hyph.tile_rows(M) + 1
    x, wl = _random_rows(h, rng, B, M)
    _k10_packed_matches_plain(t, [(x, wl)])
    _k10_matches_plain(t, torch.from_numpy(x).cuda(),
                       torch.from_numpy(wl).cuda())
    _k10_packed_matches_plain(t, [(x[:5], wl[:5]), (x[5:], wl[5:])])


@pytest.mark.parametrize("kind", ["small", "slot0"])
def test_hyph_packed_kernel_over_every_bucket_in_one_launch(kind):
    """The segments of a process_batch call (every bucket) in one launch
    with an empty segment among them, and process_batch's own single
    launch against the CPU's."""
    _need_cuda()
    h = _hyph(kind, "cuda")
    words = _hyph_words()
    trace = []
    kernels.reset_launches()
    got = h.process_batch(words, trace=trace)
    assert kernels.launches["hyph_segment"] == 1
    assert got == _hyph(kind, "cpu").process_batch(words)
    segs = [(x, wl) for _b, x, wl, _w in trace]
    assert len(segs) >= 4
    segs.insert(2, (np.zeros((0, 66), np.int32), np.zeros(0, np.int32)))
    _k10_packed_matches_plain(h.tables, segs)


# ------------------------------------------- the classic doc rows (PR 6)


@functools.lru_cache(maxsize=None)
def _spm_tok(comb: bool, device: str, n_pairs: int = 40) -> SpTokenizer:
    """The SentencePiece-BPE-shaped merges model (rank mode) at 2,000
    entries; ``comb`` declines its trie."""
    blob = testing.spm_bpe_shaped_model_bytes(2000, n_cjk=20, n_pairs=n_pairs)
    saved = host.build_trie_table_cached
    if comb:
        host.build_trie_table_cached = lambda *a: None
    try:
        return SpTokenizer(load_bytes(blob), max_doc_symbols=1024, device=device)
    finally:
        host.build_trie_table_cached = saved


def _spm_docs():
    return [d.encode("utf-8") for d in full_corpus()] + \
        testing.zipf_corpus(200_000)[len(testing.EDGE_CASES):]


def _k1_k2_match_plain(tok, x, ln, lw=None, bounded=False, unk_id=0):
    """One K1 and one K2 launch against their plain versions, all on the
    card; the tables' mode decides the kernels' modes."""
    t = tok.tables
    LW = bpe._walk_depth(t, lw)
    n = kernels.launches["bpe_walk"], kernels.launches["bpe_resolve"]
    m, mr, so = bpe.bpe_walk(t, x, ln, tok._spm_iw, lw=lw, bounded=bounded)
    pm, pmr, pso = bpe._walk_plain(t, x, ln, tok._spm_iw, LW,
                                   t.max_len > LW and not bounded)
    assert torch.equal(m, pm) and torch.equal(so, pso)
    assert (mr is None) == (not bpe.rank_mode(t))
    assert mr is None or torch.equal(mr, pmr)
    res = bpe.bpe_resolve(t, m, mr, so, x, ln, tok._spm_iw, unk_id, tok.a_max)
    pres = bpe._resolve_plain(t, m, mr, so, x, ln, tok._spm_iw, unk_id,
                              tok.a_max)
    assert (kernels.launches["bpe_walk"], kernels.launches["bpe_resolve"]) \
        == (n[0] + 1, n[1] + 1)
    for a, b in zip(res, pres):
        assert torch.equal(a, b)
    return res


@pytest.mark.parametrize("comb", [False, True], ids=["trie_rank", "comb_rank"])
def test_bpe_kernels_in_rank_mode_on_classic_rows(comb):
    """K1 and K2 on the classic rows (width 1024, a_max 4096) of a model
    that is not chunk-safe, and on the rows of the rank-fault model."""
    _need_cuda()
    tok = _spm_tok(comb, "cuda")
    assert bpe.rank_mode(tok.tables) and (tok.tables.trie_next is None) == comb
    x, ln, _status = tok._prep_batch(_spm_docs())
    keep = ln > 0
    xd, ld = torch.from_numpy(x[keep]).cuda(), torch.from_numpy(ln[keep]).cuda()
    res = _k1_k2_match_plain(tok, xd, ld)
    assert int(res[3].sum()) > 0
    _k1_k2_match_plain(tok, xd[:, :256].contiguous(), ld.clamp(max=256))
    ft = SpTokenizer(load_bytes(testing.rank_fault_model_bytes()),
                     max_doc_symbols=16, device="cuda")
    fx, fl, _status = ft._prep_batch([b"aqq b", b"b aqqq", b"baqqb", b"aq b"])
    _k1_k2_match_plain(ft, torch.from_numpy(fx).cuda(),
                       torch.from_numpy(fl).cuda(), unk_id=7)


@pytest.mark.parametrize("comb", [False, True], ids=["trie_rank", "comb_rank"])
@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_bpe_kernels_in_rank_mode_on_unit_regions(comb, region, lw, bounded):
    _need_cuda()
    tok = _spm_tok(comb, "cuda", n_pairs=0)
    assert tok._chunk_safe
    nu = native.units_analyze(_spm_docs(), 128, tok._sym2iw, tok._spm_iw,
                              False, False, tok.seg.charmap)
    b = [0, nu.split_rows1, nu.split_rows, nu.n_rows]
    x = torch.from_numpy(nu.px[b[region]:b[region + 1]].copy()).cuda()
    ln = torch.from_numpy(nu.plen[b[region]:b[region + 1]].copy()).cuda()
    nu.close()
    _k1_k2_match_plain(tok, x, ln, lw=lw, bounded=bounded)


def test_bpe_comb_walk_kernel_takes_no_transition_below_slot_0():
    """K1 in comb mode on a model whose root owns slot 0 with base -1: a
    lone ``a`` at a start has no transition (JAX's clamp takes b's)."""
    _need_cuda()
    a, b, c, d = 0x61, 0x62, 0x63, 0x64
    vocab = [(b,), (c,), (d,), (b, a), (c, a), (d, a, b)]
    blob = compile_dict_model(DictModelSpec(
        entries=[VocabEntry(ch, 3 + i, -float(i)) for i, ch in enumerate(vocab)],
        tok_algo=TokAlgo.BPE_OPT_WITH_MERGES, id_offset=0,
        use_byte_encoding=False))
    host.build_trie_table_cached, saved = (lambda *a: None,
                                           host.build_trie_table_cached)
    try:
        tok = SpTokenizer(load_bytes(blob), max_doc_symbols=16, device="cuda")
    finally:
        host.build_trie_table_cached = saved
    assert testing.slot0_probes(tok.comb) == (0, [0])
    docs = [b"a", b"ab", b"ba", b"cab", b"dab a"]
    x, ln, _status = tok._prep_batch(docs)
    res = _k1_k2_match_plain(tok, torch.from_numpy(x).cuda(),
                             torch.from_numpy(ln).cuda())
    got = [res[0][i, : res[3][i]].tolist() for i in range(len(docs))]
    assert got == [tok._oracle.text_to_ids(d) for d in docs]


@pytest.mark.parametrize("comb", [False, True], ids=["trie_rank", "comb_rank"])
def test_classic_path_on_the_card_matches_cpu(comb):
    _need_cuda()
    docs = _spm_docs()
    kernels.reset_launches()
    c = metrics.Counters()
    ids, bounds = _spm_tok(comb, "cuda").encode_corpus_flat(docs, counters=c)
    assert kernels.launches["bpe_walk"] > 0 and kernels.launches["bpe_resolve"] > 0
    assert c.oracle_docs == 0 and c.chunked_docs > 0
    cids, cbounds = _spm_tok(comb, "cpu").encode_corpus_flat(docs)
    assert (ids == cids).all() and (bounds == cbounds).all()


def test_encode_batch_without_dedup_on_the_card_matches_cpu():
    _need_cuda()
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    docs = _spm_docs()
    gpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128)
    cpu = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cpu")
    got = gpu.encode_batch(docs, dedup=False)
    assert got == cpu.encode_batch(docs, dedup=False) == gpu.encode_batch(docs)


# ------------------------------ the NumPy unit path, data-parallel stats


@pytest.mark.parametrize("width", [128, 1024])
def test_pack_out_kernel_matches_plain(width):
    """K11 against its plain version on random rows, whole and into a slice
    of a larger output."""
    _need_cuda()
    rng = np.random.default_rng(width)
    B = 700
    ids = torch.from_numpy(rng.integers(-5, 1 << 20, (B, width),
                                        dtype=np.int32)).cuda()
    st = torch.from_numpy(rng.integers(0, width, (B, width),
                                       dtype=np.int32)).cuda()
    cnt = torch.from_numpy(rng.integers(0, width + 1, B, dtype=np.int32)).cuda()
    fb = torch.from_numpy(rng.random(B) < 0.3).cuda()
    n = kernels.launches["pack_out"]
    got = dedup.pack_out(ids, st, cnt, fb)
    assert kernels.launches["pack_out"] == n + 1
    want = dedup._pack_out_plain(ids, st, cnt, fb)
    assert torch.equal(got, want)
    big = torch.full((B + 9, 2 * width + 2), -7, dtype=torch.int32,
                     device="cuda")
    dedup.pack_out(ids[:B - 3], st[:B - 3], cnt[:B - 3], fb[:B - 3],
                   out=big[5 : B + 2])
    assert torch.equal(big[5 : B + 2], want[:B - 3])
    assert (big[:5] == -7).all() and (big[B + 2 :] == -7).all()


@pytest.mark.parametrize("B", [1, 304])
@pytest.mark.parametrize("width", [1, 2, 127, 128, 1024])
def test_pack_out_kernel_at_every_width(width, B):
    """K11's pair path (N even) and value path (N odd, or a plane that is
    not 8-byte aligned) against the plain version."""
    _need_cuda()
    rng = np.random.default_rng(width * 1000 + B)
    ids = torch.from_numpy(rng.integers(-5, 1 << 20, (B, width),
                                        dtype=np.int32)).cuda()
    st = torch.from_numpy(rng.integers(0, width, (B, width),
                                       dtype=np.int32)).cuda()
    cnt = torch.from_numpy(rng.integers(0, width + 1, B, dtype=np.int32)).cuda()
    fb = torch.from_numpy(rng.random(B) < 0.3).cuda()
    want = dedup._pack_out_plain(ids, st, cnt, fb)
    n = kernels.launches["pack_out"]
    assert torch.equal(dedup.pack_out(ids, st, cnt, fb), want)
    odd = torch.empty(B * width + 1, dtype=torch.int32, device="cuda")
    odd = odd[1:].view(B, width)  # 4 bytes past an 8-byte boundary
    odd.copy_(ids)
    assert torch.equal(dedup.pack_out(odd, st, cnt, fb), want)
    assert kernels.launches["pack_out"] == n + 2


@pytest.mark.parametrize("B", [1, 304])
@pytest.mark.parametrize("width", [1, 2, 127, 128, 1024])
def test_pack_out_compact_kernel_at_every_width(width, B):
    """K4's pair path (N even) and value path (N odd, or a plane that is
    not 8-byte aligned) against the plain version, allocating and into a
    slice of a larger output; starts from -3 to 1,023 (bit 31)."""
    _need_cuda()
    rng = np.random.default_rng(width * 1000 + B + 7)
    ids = torch.from_numpy(rng.integers(-5, 1 << 20, (B, width),
                                        dtype=np.int32)).cuda()
    st = torch.from_numpy(rng.integers(-3, 1024, (B, width),
                                       dtype=np.int32)).cuda()
    cnt = torch.from_numpy(rng.integers(0, width + 1, B, dtype=np.int32)).cuda()
    fb = torch.from_numpy(rng.random(B) < 0.3).cuda()
    want = dedup._pack_out_compact_plain(ids, st, cnt, fb)
    n = kernels.launches["pack_out_compact"]
    assert torch.equal(dedup.pack_out_compact(ids, st, cnt, fb), want)
    big = torch.full((B + 4, width + 2), -7, dtype=torch.int32,
                     device="cuda")
    dedup.pack_out_compact(ids, st, cnt, fb, out=big[2 : B + 2])
    assert torch.equal(big[2 : B + 2], want)
    assert (big[:2] == -7).all() and (big[B + 2 :] == -7).all()
    odd = torch.empty(B * width + 1, dtype=torch.int32, device="cuda")
    odd = odd[1:].view(B, width)  # 4 bytes past an 8-byte boundary
    odd.copy_(ids)
    assert torch.equal(dedup.pack_out_compact(odd, st, cnt, fb), want)
    assert kernels.launches["pack_out_compact"] == n + 3


def test_k2_and_k11_raise_on_tensors_they_do_not_take():
    """No fallback on the card: a wrong dtype, a plane on another device or
    a row past K2's limits raises, and nothing launches."""
    _need_cuda()
    ids = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    cnt = torch.zeros(4, dtype=torch.int32, device="cuda")
    fb = torch.zeros(4, dtype=torch.bool, device="cuda")
    n = kernels.launches["pack_out"]
    with pytest.raises(ValueError, match="starts"):
        dedup.pack_out(ids, ids.long(), cnt, fb)
    with pytest.raises(ValueError, match="counts"):
        dedup.pack_out(ids, ids, cnt.cpu(), fb)
    with pytest.raises(ValueError, match="out"):
        dedup.pack_out(ids, ids, cnt, fb, out=torch.empty(
            (4, 17), dtype=torch.int32, device="cuda"))
    assert kernels.launches["pack_out"] == n
    t, spm = _k2_tables("plain")
    N = bpe.RESOLVE_MAX_N * 2
    m = torch.full((2, 1, N), -1, dtype=torch.int32, device="cuda")
    x = torch.zeros((1, N), dtype=torch.int32, device="cuda")
    ln = torch.full((1,), N, dtype=torch.int32, device="cuda")
    so = torch.zeros((1, N), dtype=torch.bool, device="cuda")
    n = kernels.launches["bpe_resolve"]
    with pytest.raises(ValueError, match="N<="):
        bpe.bpe_resolve(t, m, None, so, x, ln, spm, 0, 64)
    with pytest.raises(ValueError, match="a_max<="):
        bpe.bpe_resolve(t, m[:, :, :8].contiguous(), None, so[:, :8], x[:, :8],
                        ln.clamp(max=8), spm, 0, bpe.RESOLVE_MAX_ARCS + 1)
    assert kernels.launches["bpe_resolve"] == n


def _k2_tables(mode: str):
    """(tables, spm_iw) on the card in K2's plain, merge-priority and rank
    modes."""
    if mode == "rank":
        tok = _spm_tok(False, "cuda", n_pairs=0)
        return tok.tables, tok._spm_iw
    algo = TokAlgo.BPE_OPT if mode == "plain" else TokAlgo.BPE_OPT_WITH_MERGES
    tok = SpTokenizer(load_bytes(testing.gpt2_shaped_model_bytes(
        2000, n_long=40, tok_algo=algo)), max_doc_symbols=128, device="cuda")
    return tok.tables, tok._unit_runner().spm_iw


@pytest.mark.parametrize("mode", ["plain", "priority", "rank"])
def test_resolve_kernel_on_edge_rows(mode):
    """K2 on testing.resolve_edge_rows: a one-segment row at a_max 4,096,
    a flagged row whose a_max cut splits its segment, unknown runs at a
    row's end, lengths below N, widths 1,024, 200 and 37."""
    _need_cuda()
    t, spm = _k2_tables(mode)
    assert bpe.rank_mode(t) == (mode == "rank")
    assert (t.prio2id is not None) == (mode == "priority")
    for case in testing.resolve_edge_rows(spm):
        m, so, x, ln = (torch.from_numpy(case[k]).cuda() for k in (
            "m_pack", "slot_overflow", "x", "lengths"))
        mr = torch.from_numpy(case["m_rank"]).cuda() if mode == "rank" \
            else None
        n = kernels.launches["bpe_resolve"]
        got = bpe.bpe_resolve(t, m, mr, so, x, ln, spm, 3, case["a_max"])
        assert kernels.launches["bpe_resolve"] == n + 1
        want = bpe._resolve_plain(t, m, mr, so, x, ln, spm, 3, case["a_max"])
        for name, a, b in zip(("ids", "starts", "ends", "counts",
                               "fallback"), got, want):
            assert torch.equal(a, b), (case["name"], name)


@pytest.mark.parametrize("mode", ["plain", "priority", "rank"])
def test_resolve_kernel_marks_on_edge_rows(mode):
    """K2's marking mode on testing.resolve_edge_rows (overflowed starts
    covered by tokens, and some a_max cut leaves uncovered) against its
    plain version."""
    _need_cuda()
    t, spm = _k2_tables(mode)
    for case in testing.resolve_edge_rows(spm):
        m, so, x, ln = (torch.from_numpy(case[k]).cuda() for k in (
            "m_pack", "slot_overflow", "x", "lengths"))
        mr = torch.from_numpy(case["m_rank"]).cuda() if mode == "rank" \
            else None
        got = bpe.bpe_resolve(t, m, mr, so, x, ln, spm, 3, case["a_max"],
                              mark=True)
        want = bpe._resolve_plain(t, m, mr, so, x, ln, spm, 3, case["a_max"],
                                  mark=True)
        for name, a, b in zip(("ids", "starts", "ends", "counts",
                               "fallback"), got, want):
            assert torch.equal(a, b), (case["name"], name)


@pytest.mark.parametrize("budget", ["model", "tight"])
def test_resolve_kernel_marks_on_region_b_rows(budget):
    """K2's marking mode on the unit rows' region B (runs of one long
    character past the depth-16 cap beside other units) against its plain
    version, at the model's arc budget and at one that half the rows pass,
    then K4 on the marked output."""
    _need_cuda()
    tok, spm_iw, regions = _setup()
    x, ln = regions[2]
    t = tok.tables
    m, mr, so = bpe.bpe_walk(t, x, ln, spm_iw, lw=16, bounded=False)
    assert so.any()
    a_max = tok.a_max
    if budget == "tight":
        survive, run_start, _re, _an, _v = bpe._filter_plain(t, m, x, ln,
                                                             spm_iw)
        a_max = int((survive.sum(dim=(0, 2)) + run_start.sum(dim=1))
                    .median())
    got = bpe.bpe_resolve(t, m, mr, so, x, ln, spm_iw, 0, a_max, mark=True)
    want = bpe._resolve_plain(t, m, mr, so, x, ln, spm_iw, 0, a_max,
                              mark=True)
    for name, a, b in zip(("ids", "starts", "ends", "counts", "fallback"),
                          got, want):
        assert torch.equal(a, b), name
    ids, st, _en, counts, fb = got
    assert ((st & bpe.MARK_BIT) != 0).any()
    out = dedup.pack_out_compact(ids, st, counts, fb)
    assert torch.equal(out, dedup._pack_out_compact_plain(ids, st, counts, fb))


@pytest.mark.parametrize("layout", ["rows", "wordpiece_slab"])
def test_shard_stats_kernel_matches_plain(layout):
    """K12 against its plain version: ids near 2^20 and negative lanes at
    positions up to 1,023 (the sums wrap), two launches into one buffer,
    and the WordPiece slab's strided ids and count column."""
    _need_cuda()
    rng = np.random.default_rng(5)
    R, W = 3001, 1024
    ids = rng.integers((1 << 20) - 4096, 1 << 20, (R, W), dtype=np.int32)
    ids[::7, ::5] = rng.integers(-(1 << 31), -1, ids[::7, ::5].shape,
                                 dtype=np.int32)
    counts = rng.integers(0, W + 1, R, dtype=np.int32)
    if layout == "rows":
        t_ids = torch.from_numpy(ids).cuda()
        t_counts = torch.from_numpy(counts).cuda()
    else:
        slab = torch.zeros((R, W + 2), dtype=torch.int32, device="cuda")
        slab[:, :W] = torch.from_numpy(ids).cuda()
        slab[:, W] = torch.from_numpy(counts).cuda()
        t_ids, t_counts = slab[:, :-2], slab[:, -2]
    acc = torch.zeros(2, dtype=torch.int64, device="cuda")
    n = kernels.launches["shard_stats"]
    mesh.shard_stats(t_ids[:1000], t_counts[:1000], acc)
    mesh.shard_stats(t_ids[1000:], t_counts[1000:], acc)
    mesh.shard_stats(t_ids[:0], t_counts[:0], acc)
    assert kernels.launches["shard_stats"] == n + 2
    want = mesh._shard_stats_plain(t_ids, t_counts)
    assert mesh.finish_stats(acc) == mesh.finish_stats(want)


@pytest.mark.parametrize("R", [1, 31, 32, 33, 9997])
def test_shard_stats_kernel_over_row_counts(R):
    """K12 at row counts around a warp and past one wave's spans, counts of
    -5, W + 3 and 0 among them, many blocks and launches into one acc, and
    the WordPiece slab's strided ids and count column."""
    _need_cuda()
    rng = np.random.default_rng(R)
    W = 128
    slab = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1,
                                         (R, W + 2), dtype=np.int32)).cuda()
    counts = rng.integers(0, W + 1, R, dtype=np.int32)
    counts[::4] = 0
    counts[: min(R, 3)] = [-5, W + 3, W][: min(R, 3)]
    slab[:, W] = torch.from_numpy(counts).cuda()
    for ids, cnt in ((slab[:, :W].contiguous(), slab[:, W].contiguous()),
                     (slab[:, :-2], slab[:, -2])):
        want = mesh.finish_stats(mesh._shard_stats_plain(ids, cnt))
        acc = torch.zeros(2, dtype=torch.int64, device="cuda")
        mesh.shard_stats(ids, cnt, acc)
        assert mesh.finish_stats(acc) == want
        acc.zero_()
        half = R // 2
        mesh.shard_stats(ids[:half], cnt[:half], acc)
        mesh.shard_stats(ids[half:], cnt[half:], acc)
        mesh.shard_stats(ids, cnt, acc)
        total, chk = mesh.finish_stats(acc)
        t2, c2 = mesh.finish_stats(2 * mesh._shard_stats_plain(ids, cnt))
        assert (total, chk) == (t2, c2)


@pytest.mark.parametrize("kind", ["gpt2", "spm", "xlnet"])
def test_wide_window_on_the_card_matches_cpu(kind):
    """max_doc_symbols=2048 on the card: the NumPy unit path (K11) for the
    chunk-safe models, the classic rows for the spm-BPE-shaped one; no K2
    launch passes its limits (the wrapper raises), and the ids equal the
    CPU's."""
    _need_cuda()
    blob = {"gpt2": lambda: testing.gpt2_shaped_model_bytes(2000, n_long=40),
            "spm": lambda: testing.spm_bpe_shaped_model_bytes(
                2000, n_cjk=20, n_pairs=40),
            "xlnet": lambda: testing.xlnet_shaped_model_bytes(
                4000, n_cjk=100)}[kind]()
    docs = testing.wide_window_docs()
    kernels.reset_launches()
    gpu = SpTokenizer(load_bytes(blob), max_doc_symbols=2048)
    c = metrics.Counters()
    ids, bounds = gpu.encode_corpus_flat(docs, batch_docs=16, counters=c)
    assert (kernels.launches["pack_out"] > 0) == (kind != "spm")
    assert c.units_np_batches == (c.batches if kind != "spm" else 0)
    cpu = SpTokenizer(load_bytes(blob), max_doc_symbols=2048, device="cpu")
    cids, cbounds = cpu.encode_corpus_flat(docs, batch_docs=16)
    assert (ids == cids).all() and (bounds == cbounds).all()
    assert gpu.encode_batch(docs) == cpu.encode_batch(docs)


@pytest.mark.parametrize("width", [128, 130])
@pytest.mark.parametrize("mode", MODES)
def test_unigram_walk_kernel_at_chunk_depths(monkeypatch, mode, width):
    """K5 on testing.unigram_deep_rows at the depths on each side of its
    32-depth chunks and at the model's max_len (70): a row width of whole
    16-byte spans (128) and one that is not (130, also a ragged second
    tile of starts)."""
    _need_cuda()
    blob, x, ln = testing.unigram_deep_rows(width)
    _force_mode(monkeypatch, mode)
    t = _uni_tables(blob, testing.DEEP_MAX_LEN)
    assert t.mode == MODES.index(mode)
    x, ln = torch.from_numpy(x).cuda(), torch.from_numpy(ln).cuda()
    for lw in testing.DEEP_DEPTHS + (None,):
        n = kernels.launches["unigram_walk"]
        got = unigram.unigram_walk(t, x, ln, lw=lw)
        assert kernels.launches["unigram_walk"] == n + 1
        want = unigram._walk_plain(t, x, ln, unigram.walk_depth(t, lw))
        for a, b in zip(got, want):
            assert torch.equal(a, b), lw


@pytest.mark.parametrize("depths", [(18, 42), (42, 1)],
                         ids=["dispatch", "short_tail"])
@pytest.mark.parametrize("comb", [False, True], ids=["dense", "comb"])
def test_wp_one_launch_matches_plain_by_class(comb, depths):
    """K7 (K8) in one launch over the packed rows of both length classes,
    each at its walk depth, against the plain pass run once a class: at the
    dispatch's depths, and with the second class cut to one step."""
    _need_cuda()
    h = _wp(comb, "cuda")
    nh, u_syms, u_soff, u_fn = h._analyze(_wp_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    class_rows = [(lo, hi, lw) for (lo, hi, _lw), lw in zip(class_rows,
                                                             depths)]
    xd, idv = torch.from_numpy(px).cuda(), torch.from_numpy(pinit).cuda()
    name = "wp_subword_comb" if comb else "wp_subword_dense"
    out = torch.full((len(px), px.shape[1] + 2), -7, dtype=torch.int32,
                     device="cuda")
    n = kernels.launches[name]
    h._passes(xd, idv, class_rows, out)
    assert kernels.launches[name] == n + 1
    want = []
    for lo, hi, lw in class_rows:
        x, init = xd[lo:hi], idv[lo:hi]
        if comb:
            want.append(lexer._pass_comb_plain(h.tables, x, init, h._l_iw,
                                               h._r_iw, lw))
        else:
            dnext, ow_perm, _p, n_f, _n = h._dense
            want.append(lexer._pass_dense_plain(
                h.tables, dnext, ow_perm, x, init, h._l_iw, h._r_iw, lw, n_f,
                h._n_iws))
    assert torch.equal(out, torch.cat(want))


@pytest.mark.parametrize("kind,want", [
    ("gpt2", ("bpe_walk", "bpe_resolve", "pack_out_compact")),
    ("xlnet", ("unigram_walk", "unigram_viterbi", "pack_out_compact")),
    ("bert", ("scatter_trie", "wp_subword_dense"))])
def test_api_text_to_ids_batch_on_the_card(kind, want, tmp_path):
    """api.load_model(path).text_to_ids_batch with the default device runs
    the path's kernels on the card and gives the CPU's ids; building the
    handle and a single-string call launch nothing."""
    _need_cuda()
    from blingfire_tpu_torch import api

    blob = {"gpt2": lambda: testing.gpt2_shaped_model_bytes(2000, n_long=40),
            "xlnet": lambda: testing.xlnet_shaped_model_bytes(4000,
                                                              n_cjk=100),
            "bert": lambda: testing.bert_shaped_model_bytes(2000)}[kind]()
    p = tmp_path / f"{kind}.bin"
    p.write_bytes(blob)
    unk = testing.BERT_UNK if kind == "bert" else 0
    docs = [d.encode("utf-8") for d in full_corpus()]
    kernels.reset_launches()
    h = api.load_model(str(p))
    one = h.text_to_ids(docs[0], unk_id=unk)
    assert sum(kernels.launches.values()) == 0
    got = h.text_to_ids_batch(docs, unk_id=unk)
    assert all(kernels.launches[k] > 0 for k in want), dict(kernels.launches)
    cpu = api.load_model(str(p), device="cpu").text_to_ids_batch(docs,
                                                                 unk_id=unk)
    assert got == cpu and got[0] == one


# K8 reads chained slot records (ops/lexer.py::comb_chain, tables.chain):
# one 16-byte load a step.  Each case below launches it once and holds it to the plain
# five-gather walk, _pass_comb_plain, on the card.


def _k8_matches_plain(h, x, init, lw, tables=None, class_rows=None):
    """K8 in one launch (both classes when class_rows is given) against the
    plain comb pass a class."""
    t = h.tables if tables is None else tables
    xd, idv = torch.as_tensor(x).cuda(), torch.as_tensor(init).cuda()
    class_rows = class_rows or [(0, len(xd), lw)]
    (lo0, hi0, lw0), *rest = class_rows
    n = kernels.launches["wp_subword_comb"]
    got = lexer.wp_subword_pass(t, xd, idv, h._l_iw, h._r_iw, lw0,
                                tail=(hi0, rest[0][2]) if rest else None)
    assert kernels.launches["wp_subword_comb"] == n + 1
    want = torch.cat([lexer._pass_comb_plain(t, xd[lo:hi], idv[lo:hi],
                                             h._l_iw, h._r_iw, d)
                      for lo, hi, d in class_rows])
    assert torch.equal(got, want)
    return got


@functools.lru_cache(maxsize=None)
def _k8_hybrid(kind: str) -> WordPieceHybrid:
    """The comb pass's hybrid on the card: the bert-shaped model at full
    size with the dense table declined by force (main-wc), or the small
    multilingual-bert-shaped fixture likewise."""
    blob = (testing.bert_shaped_model_bytes() if kind == "main-wc"
            else testing.mbert_shaped_model_bytes(6000))
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1
    try:
        return WordPieceHybrid(load_bytes(blob), device="cuda")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved


@pytest.mark.parametrize("kind", ["main-wc", "mbert"])
def test_wp_comb_kernel_on_both_classes_in_one_launch(kind):
    """main-wc's batch (the first 4 MiB of the 32 MiB corpus) and the mbert
    fixture's rows of documents with its own ideographs."""
    _need_cuda()
    from blingfire_tpu_torch import measure

    h = _k8_hybrid(kind)
    if kind == "main-wc":
        docs = measure.corpus_prefix(testing.zipf_corpus(
            measure.CORPUS_BYTES), measure.CMP_BYTES)
    else:
        rng = np.random.default_rng(3)
        cjk = [c for c in testing.mbert_alphabet() if 0x4E00 <= c < 0xA000]
        docs = _wp_docs() + [" ".join("".join(map(chr, rng.choice(cjk, 5)))
                                      for _ in range(40)).encode()
                             for _ in range(50)]
    nh, u_syms, u_soff, u_fn = h._analyze(docs)
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    assert len(class_rows) == 2 and class_rows[1][1] > class_rows[1][0]
    got = _k8_matches_plain(h, px, pinit, None, class_rows=class_rows)
    assert int(got[:, 128].sum()) > 0


@pytest.mark.parametrize("kind", ["main-wc", "mbert"])
def test_wp_comb_kernel_from_states_with_a_negative_base(kind):
    """Lanes started at states whose base is negative, on symbols below
    and above -base, and on the unknown symbol (n_iws), at both depths."""
    _need_cuda()
    h = _k8_hybrid(kind)
    base = np.asarray(h.comb.base)
    neg = np.flatnonzero(base < 0)
    assert len(neg)
    rng = np.random.default_rng(11)
    B, M = 64, 128
    starts = rng.choice(neg, (B, M))
    x = rng.integers(0, h._n_iws + 1, (B, M)).astype(np.int32)
    low = (-base[starts]).clip(1, None)
    below = rng.random((B, M)) < 0.3
    x = np.where(below, rng.integers(0, low), x).astype(np.int32)
    x[:, ::7] = h._n_iws  # the unknown symbol
    x[:, 5::11] = h._r_iw
    x[:, 3::13] = -1
    init = np.where(x >= 0, starts, -1).astype(np.int32)
    for lw in (18, 42):
        _k8_matches_plain(h, x, init, lw)


def test_wp_comb_kernel_on_edge_rows_and_a_short_token_gate():
    """The mbert fixture's edge rows (testing.wp_edge_rows), and its packed
    rows with max_token_length cut to 3."""
    _need_cuda()
    h = _k8_hybrid("mbert")
    x, fn = testing.wp_edge_rows(h._l_iw, h._r_iw, h._map_raw)
    init = np.where(fn >= 0, h._fn2ini[np.clip(fn, 0, len(h._fn2ini) - 1)],
                    -1).astype(np.int32)
    for lw in (18, 42):
        _k8_matches_plain(h, x, init, lw)
    nh, u_syms, u_soff, u_fn = h._analyze(_wp_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    short = dataclasses.replace(h.tables, max_token_length=3)
    got = _k8_matches_plain(h, px, pinit, None, tables=short,
                            class_rows=class_rows)
    assert not torch.equal(got, _k8_matches_plain(h, px, pinit, None,
                                                  class_rows=class_rows))


def test_wp_comb_kernel_builds_its_records_at_the_first_launch():
    """tables.chain: built on the card by the first comb launch, kept for
    the next, and equal to the records built on the CPU."""
    _need_cuda()
    blob = testing.mbert_shaped_model_bytes(6000)
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1
    try:
        h = WordPieceHybrid(load_bytes(blob), device="cuda")
        cpu = WordPieceHybrid(load_bytes(blob), device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved
    assert "chain" not in vars(h.tables)
    x = torch.full((1, 128), -1, dtype=torch.int32, device="cuda")
    lexer.wp_subword_pass(h.tables, x, x, h._l_iw, h._r_iw, 18)
    chain = vars(h.tables)["chain"]
    assert chain.is_cuda and chain.shape == (h.tables.n_slots, 4)
    lexer.wp_subword_pass(h.tables, x, x, h._l_iw, h._r_iw, 18)
    assert h.tables.chain is chain
    assert torch.equal(chain.cpu(), cpu.tables.chain)


def test_mbert_encode_corpus_flat_on_the_card_matches_cpu():
    _need_cuda()
    blob = testing.mbert_shaped_model_bytes(6000)
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1
    try:
        kernels.reset_launches()
        gpu = WordPieceHybrid(load_bytes(blob))
        cpu = WordPieceHybrid(load_bytes(blob), device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved
    ids, bounds = gpu.encode_corpus_flat(_wp_docs(), unk_id=100,
                                         batch_docs=64)
    assert kernels.launches["wp_subword_comb"] > 0
    assert kernels.launches["wp_subword_dense"] == 0
    cids, cbounds = cpu.encode_corpus_flat(_wp_docs(), unk_id=100,
                                           batch_docs=64)
    assert (ids == cids).all() and (bounds == cbounds).all()
