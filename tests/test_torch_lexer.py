"""The port's pattern lexer (blingfire_tpu_torch/ops/lexer.py::lexer_pass,
runtime/lexer_host.py) against the JAX package on the shipped wbd and sbd
models, on the CPU; and the guard of the port's comb lookups below slot 0
(the plain K8 comb walk, the plain unigram comb and wide steps).

The JAX package clamps a comb slot ``base[s] + c`` into the slot array, so
from the state that owns slot 0 a symbol below that state's base takes slot
0's transition, which the automaton does not have (ROADMAP.md section C).
The port takes none.  So a row is held to JAX lane for lane unless a replay
of its walk finds such a false hit; a row with one is held to the scalar
engine's matches (the JAX package's LexerEngine) instead.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import lexer as jax_lexer
from blingfire_tpu.ops import tables as jax_tables
from blingfire_tpu.ops import unigram as jax_unigram
from blingfire_tpu.runtime import lexer_host as jax_host
from blingfire_tpu.runtime.lexer import LexerOracleApi as JaxOracle
from blingfire_tpu_torch import native, testing
from blingfire_tpu_torch.formats.consts import Iw
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import lexer, unigram
from blingfire_tpu_torch.ops.tables import build_comb_table
from blingfire_tpu_torch.runtime import lexer_host, metrics
from blingfire_tpu_torch.runtime.lexer_host import (WordPieceTpu, WordsTpu,
                                                    decode_utf8)
from blingfire_tpu_torch.runtime.oracle import TransitionIndex
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

MODELS = ["wbd", "sbd"]
METHOD = {"wbd": "text_to_words_batch", "sbd": "text_to_sentences_batch"}
TABLE_FIELDS = ("base", "owner", "nxt", "final", "moore_ow", "act_right",
                "act_tag", "act_fn")
DOC_107 = full_corpus(n_random=60)[107]
UNK = testing.BERT_UNK


@functools.lru_cache(maxsize=None)
def _port(name: str) -> WordsTpu:
    return WordsTpu(load_bytes(testing.shipped_lexer_bytes(name),
                               use_cache=False), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    return jax_host.WordsTpu(jax_load_bytes(testing.shipped_lexer_bytes(name),
                                            use_cache=False))


@functools.lru_cache(maxsize=None)
def _oracle(name: str) -> JaxOracle:
    return JaxOracle(jax_load_bytes(testing.shipped_lexer_bytes(name),
                                    use_cache=False))


def _oracle_out(name: str, doc):
    o = _oracle(name)
    return (o.text_to_words if name == "wbd" else o.text_to_sentences)(doc)


@functools.lru_cache(maxsize=1)
def _docs() -> list[bytes]:
    """full_corpus and a seeded 128 KB Zipfian corpus."""
    zipf = testing.zipf_corpus(128 << 10)[len(testing.EDGE_CASES):]
    return [d.encode("utf-8") for d in full_corpus()] + zipf


def _trace(name: str, docs) -> list:
    """(level, bucket, x, init, ext_len, raws) of every launch of the port's
    orchestration over docs, walked with an empty memo."""
    cps = [decode_utf8(d.encode("utf-8") if isinstance(d, str) else d)
           for d in docs]
    return _trace_cps(_port(name).lex, [np.where(c[0] == 0, 0x20, c[0])
                                       for c in cps
                                       if c is not None and len(c[0])])


def _trace_cps(lex, cps) -> list:
    trace: list = []
    lex._flat_cache.clear()
    lex.process_docs(cps, trace=trace)
    lex._flat_cache.clear()
    return trace


def _diverges(lex, docs, nul_space: bool = True) -> bool:
    """Whether JAX's walk takes a transition the port's does not in a row
    of the documents, decoded as WordsTpu (``nul_space``: NUL read as a
    space) or WordPieceTpu decodes them."""
    cps = [decode_utf8(d) for d in docs]
    rows = _trace_cps(lex, [np.where(c[0] == 0, 0x20, c[0]) if nul_space
                            else c[0] for c in cps
                            if c is not None and len(c[0])])
    return any(np.any(_jax_divergence(lex.tables, *t[2:5])) for t in rows)


def _jax_lookup(t, st, c):
    """JAX's comb lookup (lexer.py:113-117): the slot clamped into the
    array.  Returns (next, whether the slot was below 0)."""
    n_states = t.base.numel()
    raw = t.base[st.clamp(0, n_states - 1).long()].long() \
        + c.clamp(min=0).long()
    slot = raw.clamp(0, t.n_slots - 1)
    hit = (t.owner[slot] == st) & (st >= 0) & (c >= 0)
    return torch.where(hit, t.nxt[slot], -1), raw < 0


def _jax_divergence(t, x, init, ext_len):
    """(below, dead, anchor), bool (B,) each: rows where JAX's lexer_pass
    takes a transition that the port's does not, through a slot below 0
    (from the state that owns slot 0) or by the IW_ANY lookup after an
    explicitly DEAD transition; and rows whose L-anchor start reaches a
    final state on the anchor alone, a match for JAX only.  The port's
    walk is replayed with JAX's step beside it: up to the first difference
    both walks agree, so the replay sees it."""
    x, init, ext_len = (torch.as_tensor(np.asarray(a)) for a in
                        (x, init, ext_len))
    B, M = x.shape
    steps = t.max_token_length + 1
    xp = torch.cat([x, torch.full((B, steps + 1), -1, dtype=torch.int32)], 1)
    pos = torch.arange(M, dtype=torch.int32)
    r_pos = (ext_len - 1)[:, None]
    state = torch.where(pos < r_pos, init[:, None], -1).to(torch.int32)
    any_c = torch.full((B, M), t.any_iw, dtype=torch.int32)
    below = torch.zeros(B, dtype=torch.bool)
    dead = torch.zeros(B, dtype=torch.bool)
    anchor = torch.zeros(B, dtype=torch.bool)
    for d in range(steps):
        if not bool((state >= 0).any()):
            break
        c = xp[:, d : d + M]
        allowed = (d < t.max_token_length) | (pos + d == r_pos)
        st = torch.where(allowed, state, -1)
        ns, hit = lexer.comb_lookup(t, st, c)
        need = ~hit & (c >= 0) & (st >= 0)
        ns = torch.where(need, lexer.comb_lookup(
            t, torch.where(need, st, -1), any_c)[0], ns)
        j_ns, j_low = _jax_lookup(t, st, c)
        j_any, j_any_low = _jax_lookup(t, st, any_c)
        use_any = (j_ns == -1) & (c >= 0)
        differ = (torch.where(use_any, j_any, j_ns) != ns) & (st >= 0)
        low = differ & torch.where(use_any, j_any_low, j_low)
        below |= low.any(1)
        dead |= (differ & ~low).any(1)
        if d == 0:
            anchor = (ns[:, 0] >= 0) & t.final[ns[:, 0].clamp(min=0).long()]
        state = ns
    return below.numpy(), dead.numpy(), anchor.numpy()


def _scalar_matches(eng, raw, init: int, max_tok: int) -> dict:
    """One level of the scalar FromPos loop (runtime/lexer.py
    LexerEngine._process_int without its function calls) with tokens of at
    most ``max_tok`` characters: {ext start: (tag, from2, to2, fn)} of the
    starts it visits that match."""
    out = {}
    n = len(raw)
    from_pos = -1
    while from_pos < n:
        state, final_state, final_pos, j = init, -1, -1, from_pos
        bound = min(from_pos + max_tok, n)
        if j == -1:
            state = eng.dest(init, Iw.L_ANCHOR)
            if state == -1:
                state = eng.dest(init, Iw.ANY)
                if state == -1:
                    from_pos += 1
                    continue
            j += 1
        while j < bound:
            dst = eng.dest_any(state, max(int(raw[j]), int(Iw.EPSILON)))
            if dst == -1:
                break
            if eng.final[dst]:
                final_state, final_pos = dst, j
            state = dst
            j += 1
        if j == n:
            dst = eng.dest(state, Iw.R_ANCHOR)
            if dst == -1:
                dst = eng.dest(state, Iw.ANY)
            if dst >= 0 and eng.final[dst]:
                final_state, final_pos = dst, j
        if final_pos != -1:
            act = [int(v) for v in eng.acts[int(eng.moore_ow[final_state])]]
            right, tag = act[1], act[2]
            fns = act[3 if tag == 0 else 4:]
            from2 = min(max(from_pos, 0), n - 1)
            to2 = min(max(final_pos - right, 0), n - 1)
            out[from_pos + 1] = (tag, from2, to2, fns[0] if fns else -1)
            if final_pos - right > from_pos:
                from_pos = final_pos - right
        from_pos += 1
    return out


def _hold_rows(name, x, init, ext_len, raws, gate: int | None = None):
    """The port's plain lexer_pass against JAX lexer_pass on rows: lane for
    lane on every row where JAX takes no transition the port does not, and
    each other row against the scalar engine.  ``gate`` lowers
    max_token_length on both sides.  Returns (the port's planes, the rows
    of JAX's false hits below slot 0, those of its IW_ANY after DEAD)."""
    pt, jt = _port(name).lex.tables, _jax(name).lex.tables
    if gate is not None:
        pt = dataclasses.replace(pt, max_token_length=gate)
        jt = dataclasses.replace(jt, max_token_length=gate)
    got = [g.numpy() for g in lexer.lexer_pass(pt, x, init, ext_len)]
    want = [np.asarray(w) for w in jax_lexer.lexer_pass(
        jt, jnp.asarray(x), jnp.asarray(init), jnp.asarray(ext_len))]
    below, dead, anchor = _jax_divergence(pt, x, init, ext_len)
    assert not anchor.any()  # no such final in wbd or sbd
    fh = below | dead
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g[~fh], w[~fh])
    eng = _oracle(name).engine
    for r in np.flatnonzero(fh):
        assert raws[r] is not None
        vis = np.flatnonzero(got[0][r])
        assert {int(q): tuple(int(p[r, q]) for p in got[1:]) for q in vis} \
            == _scalar_matches(eng, raws[r], int(init[r]), pt.max_token_length)
    return got, below, dead


# ----------------------------------------------------------------- tables


@pytest.mark.parametrize("name", MODELS)
def test_tables_match_jax(name):
    p, j = _port(name).lex, _jax(name).lex
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(p.tables, f).numpy(),
                                      np.asarray(getattr(j.tables, f)), f)
    assert p.tables.any_iw == int(j.tables.any_iw)
    assert p.tables.n_slots == j.tables.n_slots
    assert p.tables.max_token_length == j.tables.max_token_length == 300
    assert (p._lanchor, p._ranchor, p._n_iws, p.max_depth) == (
        j._lanchor, j._ranchor, j._n_iws, j.max_depth)
    assert list(p._fn2ini) == list(j.engine.fn2ini)
    # the state placed first owns slot 0 with a negative base: the clamp of
    # the JAX walks lands there (ROADMAP.md section C)
    s, probes = testing.slot0_probes(p.comb)
    assert (s, probes) == ({"wbd": 7, "sbd": 66}[name], [0, 1])


# ------------------------------------------------------------- lexer_pass


@pytest.mark.parametrize("name", MODELS)
def test_lexer_pass_matches_jax_at_every_level(name):
    """The rows of every launch over full_corpus(n_random=60): level 0 and
    each nested level (child spans walked from their function's initial
    state), at each bucket width they take."""
    trace = _trace(name, full_corpus(n_random=60))
    levels = {t[0] for t in trace}
    assert levels >= {0, 1}
    n_below = n_dead = 0
    for level, _bucket, x, init, elen, raws in trace:
        got, below, dead = _hold_rows(name, x, init, elen, raws)
        n_below += int(below.sum())
        n_dead += int(dead.sum())
        if level > 0:
            assert (init != 0).all() and got[0].any()
    # both models take false hits below slot 0 here: sbd at document 107,
    # where its sentence breaks; wbd in four rows, from an unmapped
    # character after state 7, where the false destination's match
    # (RightCx 1) ends where the true one does, so its planes are unchanged
    assert (n_below, n_dead) == ({"wbd": 4, "sbd": 1}[name], 0)


@pytest.mark.parametrize("name", MODELS)
def test_lexer_pass_on_edge_rows(name):
    """testing.lexer_edge_rows: an empty span (the L-anchor start only), one
    character, padding without anchors, an L anchor before padding,
    unmapped characters, document 107's end, a full row, a length past the
    row, each function's initial state, seeded rows; then the same rows
    with the token-length gate live (max_token_length 3)."""
    x, init, elen, raws = testing.lexer_edge_rows(_port(name).lex)
    got, below, dead = _hold_rows(name, x, init, elen, raws)
    # nothing from the empty span, the padding or the lone L anchor; wbd
    # makes the one character a word; sbd false-hits at document 107's end,
    # and meets a DEAD transition walking from function 111's state
    assert got[0][[0, 2, 3]].sum() == 0
    assert got[0][1].sum() == (name == "wbd")
    assert list(np.flatnonzero(below)) == ([5] if name == "sbd" else [])
    assert list(np.flatnonzero(dead)) == ([11] if name == "sbd" else [])
    gated, _b, _d = _hold_rows(name, x, init, elen, raws, gate=3)
    assert any((g != u).any() for g, u in zip(gated, got))


def test_lexer_pass_wrappers_agree():
    """lexer_pass splits lexer_pass_packed's (B, 5M) int32 into its planes;
    the packed form is pack5 of the plain version's planes."""
    lex = _port("wbd").lex
    x, init, elen, _raws = testing.lexer_edge_rows(lex)
    packed = lexer.lexer_pass_packed(lex.tables, *map(torch.from_numpy,
                                                      (x, init, elen)))
    assert packed.dtype == torch.int32 and packed.shape == (len(x),
                                                            5 * x.shape[1])
    planes = lexer.lexer_pass(lex.tables, x, init, elen)
    assert planes[0].dtype == torch.bool
    assert torch.equal(packed, lexer.pack5(*planes))
    for a, b in zip(lexer.unpack5(packed), planes):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- products


def test_document_107_is_one_sentence():
    """sbd's false hit: JAX WordsTpu breaks after ``."``; the port, the
    scalar engine and the native runtime do not."""
    want = _oracle_out("sbd", DOC_107.encode())
    assert "\n" not in want
    assert _port("sbd").text_to_sentences_batch([DOC_107]) == [want]
    assert native.text_to_words(DOC_107.encode(), sentences=True) == want
    jax_got = _jax("sbd").text_to_sentences_batch([DOC_107])[0]
    assert jax_got != want and jax_got.replace("\n", "") == want


@pytest.mark.parametrize("name", MODELS)
def test_batch_matches_oracle_and_jax(name):
    """Every document of full_corpus and of a seeded 128 KB Zipfian corpus
    equals the scalar LexerOracleApi; and JAX WordsTpu wherever JAX makes
    no false hit."""
    docs = _docs()
    c = metrics.Counters()
    port = _port(name)
    port.lex._flat_cache.clear()
    got = getattr(port, METHOD[name])(docs, counters=c)
    assert got == [_oracle_out(name, d) for d in docs]
    st = port.lex.last_stats
    assert st.device_spans > 0 and st.scalar_spans == 0 and st.memo_hits > 0
    assert {"device", "matches", "assemble"} <= set(c.stage_seconds)
    # a second call answers from the memo, with no launch
    assert getattr(port, METHOD[name])(docs[:50]) == got[:50]
    assert port.lex.last_stats.device_spans == 0
    jax_got = getattr(_jax(name), METHOD[name])(docs)
    differ = [i for i, (a, b) in enumerate(zip(got, jax_got)) if a != b]
    for i in differ:
        assert _diverges(port.lex, [docs[i]]), i
    assert len(differ) == (1 if name == "sbd" else 0)


@pytest.mark.parametrize("name", MODELS)
def test_tiny_largest_bucket_takes_the_scalar_path(monkeypatch, name):
    """The output does not depend on the bucket widths or the launch size:
    with a largest bucket of 8 most documents take the scalar engine, and a
    launch budget of one byte gives one launch a row."""
    docs = _docs()[:120] + [DOC_107.encode()]
    want = getattr(_port(name), METHOD[name])(docs)
    monkeypatch.setattr(lexer_host, "LAUNCH_BYTES", 1)
    small = WordsTpu(_port(name).lex.model, buckets=(4, 8), device="cpu")
    assert getattr(small, METHOD[name])(docs) == want
    st = small.lex.last_stats
    assert st.scalar_spans > 0 and st.device_spans > 0
    assert set(b for _lvl, b in st.rows) <= {4, 8}
    assert sum(st.launches.values()) == sum(st.rows.values())


def test_empty_and_invalid_documents():
    docs = [b"", b" ", b"\xff\xfe", "\x00a b".encode(), b"\xef\xbb\xbfhi"]
    for name in MODELS:
        got = getattr(_port(name), METHOD[name])(docs)
        assert got == getattr(_jax(name), METHOD[name])(docs)
        assert got[0] == "" and got[2] is None


# ---------------------------------------------------------------- WordPiece


@functools.lru_cache(maxsize=1)
def _bert_blob() -> bytes:
    return testing.bert_shaped_model_bytes(2000)


def test_wordpiece_tpu_matches_oracle_hybrid_and_jax():
    """WordPieceTpu equals LexerOracleApi (unk 100) and the port's hybrid
    on every document, and JAX WordPieceTpu wherever JAX takes no
    transition the port does not.  The bert-shaped grammar's initial state
    has an explicitly DEAD transition on the L anchor and an IW_ANY one to
    a final state: JAX falls back to IW_ANY there, so it emits one word too
    many at the start of nearly every document."""
    docs = [d.encode("utf-8") for d in full_corpus()] + \
        testing.zipf_corpus(60_000)[len(testing.EDGE_CASES):]
    port = WordPieceTpu(load_bytes(_bert_blob(), use_cache=False),
                        device="cpu")
    got = port.text_to_ids_batch(docs, unk_id=UNK)
    assert port.lex.last_stats.rows[(1, 64)] > 0  # the sub-token level
    jax_model = jax_load_bytes(_bert_blob(), use_cache=False)
    oracle = JaxOracle(jax_model)
    assert got == [oracle.text_to_ids(d, unk_id=UNK) for d in docs]
    hyb = WordPieceHybrid(load_bytes(_bert_blob(), use_cache=False),
                          device="cpu")
    assert got == hyb.text_to_ids_batch(docs, unk_id=UNK)
    assert any(UNK in ids for ids in got)
    jax_got = jax_host.WordPieceTpu(jax_model).text_to_ids_batch(
        docs, unk_id=UNK)
    differ = [i for i, (a, b) in enumerate(zip(got, jax_got)) if a != b]
    assert len(differ) > len(docs) // 2
    for i in differ[:: max(1, len(differ) // 25)]:
        assert _diverges(port.lex, [docs[i]], nul_space=False), i
        assert jax_got[i][1:] == got[i] or jax_got[i][2:] == got[i][1:], i


@pytest.mark.parametrize("rule", ["< . >", "< [xb] . >"])
def test_wordpiece_tpu_serves_a_model_the_hybrid_cannot_pack(rule):
    """A sub-function with an IW_ANY rule is not pack-safe: the hybrid
    points to WordPieceTpu, which serves it as the scalar engine does.
    With ``< . >`` the function's initial state reaches a final on the L
    anchor alone, a match for JAX's walk only."""
    from blingfire_tpu_torch.compiler.lexbin import compile_lex_model

    grammar = (testing.BERT_GRAMMAR + "\n_function FnTokWord\n"
               " < ^ [a]+ > --> WORD_ID_100\n"
               f" {rule} --> WORD_ID_101\n < [a-z] > --> WORD_ID_102\n"
               "_end\n")
    tags = dict(testing.BERT_TAGSET, WORD_ID_100=100, WORD_ID_101=101,
                WORD_ID_102=102)
    blob = compile_lex_model(grammar, tags)
    hyb = WordPieceHybrid(load_bytes(blob, use_cache=False), device="cpu")
    assert not hyb.available()
    with pytest.raises(NotImplementedError, match="WordPieceTpu"):
        hyb.encode_corpus_flat([b"a b"])
    docs = [b"aa b", b"xa aaa!", b"", "caf\u00e9 a".encode(), b"bz xyz",
            b"abcabx"]
    port = WordPieceTpu(load_bytes(blob, use_cache=False), device="cpu")
    got = port.text_to_ids_batch(docs, unk_id=UNK)
    jax_model = jax_load_bytes(blob, use_cache=False)
    oracle = JaxOracle(jax_model)
    assert got == [oracle.text_to_ids(d, unk_id=UNK) for d in docs]
    assert {100, 101} <= {i for ids in got for i in ids}
    jax_got = jax_host.WordPieceTpu(jax_model).text_to_ids_batch(
        docs, unk_id=UNK)
    for i, (a, b) in enumerate(zip(got, jax_got)):
        assert a == b or _diverges(port.lex, [docs[i]], nul_space=False), i


# ------------------------------------------- comb lookups below slot 0


def _jax_comb_hit(comb, s: int, c: int) -> bool:
    """JAX's clamped comb lookup (lexer.py:115, unigram.py:179)."""
    slot = int(np.clip(int(comb.base[s]) + c, 0, comb.n_slots - 1))
    return int(comb.owner[slot]) == s


def test_comb_walk_takes_no_transition_below_slot_0():
    """The plain K8 comb walk on the bert-shaped comb table: a lane driven
    to the state that owns slot 0 and given a symbol below its base dies
    there, as if it met padding; JAX takes slot 0's transition and walks on
    to a final; the automaton has no such transition."""
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1
    try:
        h = WordPieceHybrid(load_bytes(_bert_blob(), use_cache=False),
                            device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved
    assert h._dense is None
    ini = int(h._fn2ini[testing.BERT_FN])
    s, probes = testing.slot0_probes(h.comb)
    walks, at = testing.slot0_walks(h.comb, ini)
    assert walks and probes
    trans = TransitionIndex(h.wbd.aut)
    for c in probes:
        assert _jax_comb_hit(h.comb, s, c)
        assert trans.step(s, c) == (-1, -1)
        st = torch.tensor([[s]], dtype=torch.int32)
        ns, hit = lexer.comb_lookup(h.tables, st, torch.tensor([[c]]))
        assert (ns.item(), hit.item()) == (-1, False)
    lw = max(map(len, walks)) + 1
    x = np.full((len(walks), 128), -1, np.int32)
    init = np.full((len(walks), 128), -1, np.int32)
    for r, w in enumerate(walks):
        x[r, : len(w)] = w
        init[r, 0] = ini
    got = h._device_pass(torch.from_numpy(x), torch.from_numpy(init), lw)
    want = np.asarray(jax_lexer.wp_subword_pass(
        _jax_wbd_tables(_bert_blob()), jnp.asarray(x), jnp.asarray(init),
        jnp.int32(h._l_iw), jnp.int32(h._r_iw), lw))
    assert (got.numpy()[:, 128] == 0).all() and (want[:, 128] > 0).all()
    x[:, at] = -1
    assert torch.equal(got, h._device_pass(torch.from_numpy(x),
                                           torch.from_numpy(init), lw))


def _jax_wbd_tables(blob: bytes):
    m = jax_load_bytes(blob, use_cache=False)
    return jax_lexer.make_device_tables(
        jax_tables.build_comb_table(m.wbd.aut), m.wbd.aut.moore_ow,
        m.wbd.acts, m.wbd.max_token_length)


@pytest.mark.parametrize("mode", ["wide", "comb"])
def test_unigram_step_takes_no_transition_below_slot_0(monkeypatch, mode):
    """The plain unigram step on testing.unigram_slot0_model_bytes, whose
    root owns slot 0 with base -1: ``a`` (dense symbol 0) starts no piece,
    so the port finds no match at a start holding it; JAX's clamp reads it
    as the root's lowest symbol, ``b``."""
    blob = testing.unigram_slot0_model_bytes()
    for mod in (jax_unigram, unigram):
        monkeypatch.setattr(mod, "_DENSE_MAX_ENTRIES", 0)
        if mode == "comb":
            monkeypatch.setattr(mod, "_WIDE_OWNER_SENTINEL", 0)
    pm = load_bytes(blob, use_cache=False).seg
    comb = build_comb_table(pm.aut)
    pt = unigram.make_device_tables(comb, pm.i2info_ids, pm.i2info_scores,
                                    max_len=3, id_offset=pm.id_offset,
                                    device="cpu")
    jm = jax_load_bytes(blob, use_cache=False).seg
    jt = jax_unigram.make_device_tables(
        jax_tables.build_comb_table(jm.aut), jm.i2info_ids,
        jm.i2info_scores, max_len=3, id_offset=jm.id_offset)
    assert pt.mode == ("wide", "comb").index(mode) + 1
    s, probes = testing.slot0_probes(comb)
    a = int(np.flatnonzero(comb.sym2iw >= 0)[0])  # raw symbol of iw 0
    assert (s, probes, comb.sym2iw[a], chr(a)) == (0, [0], 0, "a")
    assert _jax_comb_hit(comb, s, 0)
    assert TransitionIndex(pm.aut).step(s, a) == (-1, -1)
    ns, ow, fin = unigram.walk_step(pt, torch.tensor([[s]], dtype=torch.int32),
                                    torch.tensor([[0]], dtype=torch.int32))
    assert (ns.item(), ow.item(), bool(fin)) == (-1, 0, False)
    # ``a`` in the first column starts no piece and ends none: the port
    # segments the row as it segments one with an unknown symbol there
    x = np.array([[0, 1, 0, 2], [1, 0, 0, 3]], np.int32)
    ln = np.array([4, 4], np.int32)
    got = unigram.unigram_segment(pt, torch.from_numpy(x),
                                  torch.from_numpy(ln), 0)
    jax_got = [np.asarray(o) for o in jax_unigram.unigram_segment(
        jt, jnp.asarray(x), jnp.asarray(ln), jnp.int32(0))]
    assert not np.array_equal(got[0].numpy()[0], jax_got[0][0])
    unk_x = x.copy()
    unk_x[0, 0] = -1
    want = unigram.unigram_segment(pt, torch.from_numpy(unk_x),
                                   torch.from_numpy(ln), 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
