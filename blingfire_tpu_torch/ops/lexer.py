"""The pattern lexer's device passes on the card: port of
blingfire_tpu/ops/lexer.py.

Two passes, each beside its plain PyTorch version:

* ``lexer_pass`` (K9, ``kernels/csrc/lexer_pass.cu``): the pass of the
  pattern lexer (runtime/lexer_host.py) over rows ``[L c1 .. cn R -1 ..]``,
  each with its own initial state (a grammar function).  Every start walks
  the comb table from that state, an exact lookup and then the IW_ANY
  fallback a step, keeps its deepest final, maps it to the rule's action
  (RightCx, tag, function), and the reference's sequential FromPos skip
  scan (FALexTools_t.h:229-397) marks the starts it visits.  K9 writes the
  five planes (visited, tag, from, to, fn) as one (B, 5M) int32 array, the
  concatenation ``_pack5`` of the JAX package (runtime/lexer_host.py:29-41),
  so each launch costs one device-to-host copy.
* the WordPiece sub-token pass of the hybrid (runtime/wp_hybrid.py), which
  packs unique words, each with its own L and R anchors, into rows of 128
  lanes and emits the matches left-compacted as packed lanes
  ``(tag + 1) | from << 17 | to << 24 | nested << 31`` with the count in
  column 128, the layout native ``BtlWpStitch`` reads:
  ``wp_subword_pass_dense`` (K7, ``kernels/csrc/wp_subword.cu``) walks the
  dense finals-first table of :func:`make_dense_sub`, one gather a step;
  ``wp_subword_pass`` (K8, same source) walks the comb table through its
  chained slot records (:func:`comb_chain`), one 16-byte load a step, used
  when :func:`make_dense_sub` declines the dense table, which it otherwise
  scatters on the card with K3 (``ops/bpe.py::scatter_trie``, the
  computation of ``_scatter_dense``).  Either takes the rows of both of
  the hybrid's length classes in one launch, each at its own walk depth,
  and its visited starts are those of :func:`visited_chain`.

Every comb lookup here takes no transition when ``base[s] + c`` falls
outside the slot array (:func:`comb_lookup`); the JAX package clamps it
there, and so can take a transition that the automaton does not have.  And
``lexer_pass`` takes no IW_ANY transition after an explicitly DEAD one, nor
a match of the L anchor alone, where JAX's does (ROADMAP.md section C).  A wrapper runs the plain version only for tensors
on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .bpe import scatter_trie
from .tables import CombTable

INT32_MAX = 2**31 - 1
MAX_ROW = 128  # from/to are 7-bit fields of the lane layout
DENSE_MAX_ENTRIES = 256_000_000  # make_dense_sub's cap (lexer.py:226)
PLANES = 5  # lexer_pass: visited, tag, from2, to2, fn
# K9 holds a row (9 bytes a lane) in shared memory: 227 KB on an H100
MAX_LEXER_ROW = 16384 + 2
HOST_ONLY = "this action needs the host engine (runtime/lexer.py)"


@dataclass(frozen=True)
class LexerDeviceTables:
    """Comb tables and densified actions of a [wbd] grammar on ``device``."""

    base: torch.Tensor  # int32[n_states]
    owner: torch.Tensor  # int32[slots]
    nxt: torch.Tensor  # int32[slots]
    final: torch.Tensor  # bool[n_states]
    moore_ow: torch.Tensor  # int32[n_states]
    # K9's packed records: (base, final, moore_ow, 0) a state, one 16-byte
    # load; (owner, nxt) a slot, one 8-byte load
    state_rec: torch.Tensor  # int32[n_states, 4]
    slot_rec: torch.Tensor  # int32[slots, 2]
    act_right: torch.Tensor  # int32[n_acts] RightCx
    act_tag: torch.Tensor  # int32[n_acts]
    act_fn: torch.Tensor  # int32[n_acts] (-1 = no function call)
    any_iw: int  # dense id of IW_ANY
    n_slots: int
    max_token_length: int

    @functools.cached_property
    def chain(self) -> torch.Tensor:
        """K8's chained slot records (:func:`comb_chain`), built on the
        tables' device at the first comb launch and kept: tables whose
        dense sub-grammar is kept never pay for them."""
        return comb_chain(self)


def make_device_tables(table: CombTable, moore_ow, acts: dict,
                       max_token_length: int,
                       device: str | torch.device = "cuda"
                       ) -> LexerDeviceTables:
    """Port of blingfire_tpu/ops/lexer.py::make_device_tables (lexer.py:52-90):
    device tables, actions densified by rule Ow.

    Only the single-function action shape of every reference model is
    supported on the card (LeftCx == 0, at most one function); other
    actions raise NotImplementedError, as the JAX package asserts: such a
    grammar needs the host engine (runtime/lexer.py)."""
    n_acts = max(acts.keys()) + 1 if acts else 0
    act_right = np.zeros(n_acts, np.int32)
    act_tag = np.zeros(n_acts, np.int32)
    act_fn = np.full(n_acts, -1, np.int32)
    for k, a in acts.items():
        a = np.asarray(a)
        if int(a[0]) != 0:
            raise NotImplementedError(f"{HOST_ONLY}: LeftCx != 0")
        act_right[k] = int(a[1])
        act_tag[k] = int(a[2])
        fns = []
        if len(a) > 3:
            i = 3 if int(a[2]) == 0 else 4
            # layout: (L, R, Tag [,0, FnIds...]) — the 0 delimiter is the
            # Tag slot itself when Tag==0 (FALexTools_t.h:176-190)
            if int(a[2]) != 0 and int(a[3]) != 0:
                raise ValueError(f"unexpected action layout {a.tolist()}")
            fns = [int(x) for x in a[i:]]
        if len(fns) > 1:
            raise NotImplementedError(f"{HOST_ONLY}: multi-function action")
        if fns:
            act_fn[k] = fns[0]
    any_dense = int(table.sym2iw[0]) if len(table.sym2iw) > 0 else -1
    base = np.asarray(table.base, np.int32)
    state_rec = np.zeros((len(base), 4), np.int32)
    state_rec[:, 0] = base
    state_rec[:, 1] = np.asarray(table.final, bool)
    state_rec[:, 2] = np.asarray(moore_ow, np.int32)
    slot_rec = np.stack([np.asarray(table.owner, np.int32),
                         np.asarray(table.nxt, np.int32)], axis=1)

    def dev(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    return LexerDeviceTables(
        base=dev(base),
        owner=dev(table.owner),
        nxt=dev(table.nxt),
        final=dev(table.final, torch.bool),
        moore_ow=dev(moore_ow),
        state_rec=dev(state_rec),
        slot_rec=dev(slot_rec),
        act_right=dev(act_right),
        act_tag=dev(act_tag),
        act_fn=dev(act_fn),
        any_iw=any_dense,
        n_slots=table.n_slots,
        max_token_length=max_token_length,
    )


def dense_sub_edges(table: CombTable, moore_ow, fn_inis: list[int]):
    """Host half of :func:`make_dense_sub`: the transitions reachable from
    the sub-function initial states, finals numbered first.

    Returns (idx int64, vals int32, ow_perm int32, perm int64, n_f, n_reach):
    the dense table is int32[n_reach * A] = -1 with ``[idx] = vals``."""
    base = np.asarray(table.base)
    owner = np.asarray(table.owner)
    nxt = np.asarray(table.nxt)
    final = np.asarray(table.final)
    A = table.n_iws
    S = table.n_states
    occ = np.flatnonzero(owner >= 0)
    order = np.argsort(owner[occ], kind="stable")
    so = owner[occ][order]
    slot_sorted = occ[order]
    iw_sorted = (occ - base[owner[occ]])[order]
    row = np.searchsorted(so, np.arange(S + 1))
    seen = np.zeros(S, bool)
    stack = [s for s in dict.fromkeys(fn_inis) if 0 <= s < S]
    for s in stack:
        seen[s] = True
    e_src, e_iw, e_dst = [], [], []
    while stack:
        s = stack.pop()
        for k in range(row[s], row[s + 1]):
            d = int(nxt[slot_sorted[k]])
            if d < 0:
                continue
            e_src.append(s)
            e_iw.append(int(iw_sorted[k]))
            e_dst.append(d)
            if not seen[d]:
                seen[d] = True
                stack.append(d)
    reach = np.flatnonzero(seen)
    n_reach = len(reach)
    # finals first
    fin_mask = final[reach]
    ordered = np.concatenate([reach[fin_mask], reach[~fin_mask]])
    n_f = int(fin_mask.sum())
    perm = np.full(S, -1, np.int64)
    perm[ordered] = np.arange(n_reach)
    es = perm[np.asarray(e_src, np.int64)]
    ed = perm[np.asarray(e_dst, np.int64)]
    idx = es * A + np.asarray(e_iw, np.int64)
    ow_perm = np.zeros(max(n_reach, 1), np.int32)
    ow_perm[perm[ordered]] = np.asarray(moore_ow)[ordered]
    return idx, ed.astype(np.int32), ow_perm, perm, n_f, n_reach


def make_dense_sub(table: CombTable, moore_ow, fn_inis: list[int],
                   device: str | torch.device = "cuda"):
    """Dense finals-first expansion of the sub-token grammar: port of
    blingfire_tpu/ops/lexer.py::make_dense_sub (lexer.py:184-243).

    With a dense (state, iw) -> next table whose finals are numbered first
    (a final is ``ns < n_f``) and the action Ow gathered once from the
    deepest final, the walk is one gather a step.  The reachable edges are
    found on the host and cross to the card as CSR pairs; K3 scatters them
    into the dense table there.

    Returns (dnext, ow_perm, perm, n_f, n_reach) with dnext and ow_perm on
    ``device`` and perm a NumPy array, or None when the dense table would
    pass DENSE_MAX_ENTRIES."""
    idx, vals, ow_perm, perm, n_f, n_reach = dense_sub_edges(
        table, moore_ow, fn_inis)
    size = n_reach * table.n_iws
    if size > DENSE_MAX_ENTRIES:
        return None
    device = torch.device(device)
    dnext = scatter_trie(torch.from_numpy(idx).to(device),
                         torch.from_numpy(vals).to(device), int(size))
    return dnext, torch.from_numpy(ow_perm).to(device), perm, n_f, n_reach


def comb_chain(t: LexerDeviceTables) -> torch.Tensor:
    """K8's chained slot records, int32 (n_slots, 4) on the tables' device:
    (owner, nxt, base[nxt], final[nxt]) of each slot, so that one 16-byte
    load a step gives the transition, whether it ends in a final and where
    the next step's slots start.  A slot with no transition (nxt < 0: an
    explicitly DEAD one) is (owner, -1, 0, 0), an empty slot (-1, -1, 0,
    0).  The state index is clamped as the plain walk clamps it."""
    nxt = torch.where(t.owner >= 0, t.nxt, -1)
    live = nxt >= 0
    ns = nxt.clamp(0, t.base.numel() - 1).long()
    return torch.stack([t.owner, nxt,
                        torch.where(live, t.base[ns], 0),
                        (live & t.final[ns]).to(torch.int32)],
                       1).contiguous()


# ----------------------------------------------------------- plain versions


def _pad_row(x: torch.Tensor, lw: int) -> torch.Tensor:
    B = x.shape[0]
    return torch.cat([x, torch.full((B, lw + 1), -1, dtype=torch.int32,
                                    device=x.device)], dim=1)


def _walk_dense_plain(tables: LexerDeviceTables, dnext, ow_perm, x, init,
                      r_iw: int, lw: int, n_f: int, n_a: int, reads=None):
    """(fin_pos, fin_ow) of the dense walk (lexer.py:260-291); ``reads``
    (a ``kernels.Reads``) notes the table entries it reads."""
    B, M = x.shape
    pos = torch.arange(M, dtype=torch.int32, device=x.device)
    xp = _pad_row(x, lw)
    valid = (x >= 0) & (x != r_iw)
    state = torch.where(valid, init, -1).to(torch.int32)
    fin_pos = torch.full((B, M), -1, dtype=torch.int32, device=x.device)
    fin_state = torch.full((B, M), -1, dtype=torch.int32, device=x.device)
    top = dnext.numel() - 1
    for d in range(lw):
        c = xp[:, d : d + M]
        flat = (state.clamp(min=0).long() * n_a + c.clamp(min=0).long()
                ).clamp(0, top)
        live = (state >= 0) & (c >= 0)
        ns = torch.where(live, dnext[flat], -1)
        if reads is not None:
            reads.step(live)
            reads.note("dnext", dnext, flat, live)
        if d >= tables.max_token_length:
            # letters beyond the token-length bound only via the R anchor
            ns = torch.where(c == r_iw, ns, -1)
        fin = (ns >= 0) & (ns < n_f)
        fin_pos = torch.where(fin, pos + d, fin_pos)
        fin_state = torch.where(fin, ns, fin_state)
        state = ns
    fs = fin_state.clamp(0, ow_perm.numel() - 1).long()
    fin_ow = torch.where(fin_state >= 0, ow_perm[fs], -1)
    if reads is not None:
        reads.note("ow_perm", ow_perm, fs, fin_state >= 0)
    return fin_pos, fin_ow


def comb_lookup(tables: LexerDeviceTables, state, c, reads=None):
    """One comb lookup of every lane: (next state, hit).  ``hit``: the lane
    is live, the symbol real and the state owns the slot; next is -1 where
    the lane is dead, the symbol is padding or there is no hit, and also
    where the slot holds an explicitly DEAD transition (the comb keeps its
    slot with nxt -1, ops/tables.py:153).

    The lookup hits only when ``raw = base[s] + c`` lies in [0, n_slots)
    and ``owner[raw] == s``.  The JAX package clamps raw into the slot array
    first (lexer.py:115, :389-392), which false-hits when s owns slot 0 and
    raw < 0: a transition that the automaton does not have (ROADMAP.md
    section C).  ``reads`` as in :func:`_walk_dense_plain`."""
    n_states = tables.base.numel()
    live = (state >= 0) & (c >= 0)
    s_safe = state.clamp(0, n_states - 1).long()
    raw = tables.base[s_safe].long() + c.clamp(min=0).long()
    inside = live & (raw >= 0) & (raw < tables.n_slots)
    slot = raw.clamp(0, tables.n_slots - 1)
    hit = inside & (tables.owner[slot] == state)
    if reads is not None:
        reads.note("base", tables.base, s_safe, live)
        reads.note("owner", tables.owner, slot, inside)
        reads.note("nxt", tables.nxt, slot, hit)
    return torch.where(hit, tables.nxt[slot], -1), hit


def _walk_comb_plain(tables: LexerDeviceTables, x, init, r_iw: int, lw: int,
                     reads=None):
    """(fin_pos, fin_ow) of the comb walk (lexer.py:376-401), each lookup
    guarded as in :func:`comb_lookup`; ``reads`` as in
    :func:`_walk_dense_plain`."""
    B, M = x.shape
    pos = torch.arange(M, dtype=torch.int32, device=x.device)
    xp = _pad_row(x, lw)
    valid = (x >= 0) & (x != r_iw)
    state = torch.where(valid, init, -1).to(torch.int32)
    fin_pos = torch.full((B, M), -1, dtype=torch.int32, device=x.device)
    fin_ow = torch.full((B, M), -1, dtype=torch.int32, device=x.device)
    n_states = tables.base.numel()
    for d in range(lw):
        c = xp[:, d : d + M]
        if reads is not None:
            reads.step((state >= 0) & (c >= 0))
        ns = comb_lookup(tables, state, c, reads)[0]
        if d >= tables.max_token_length:
            ns = torch.where(c == r_iw, ns, -1)
        ns_safe = ns.clamp(0, n_states - 1).long()
        fin = (ns >= 0) & tables.final[ns_safe]
        if reads is not None:
            reads.note("final", tables.final, ns_safe, ns >= 0)
            reads.note("moore_ow", tables.moore_ow, ns_safe, fin)
        fin_pos = torch.where(fin, pos + d, fin_pos)
        fin_ow = torch.where(fin, tables.moore_ow[ns_safe], fin_ow)
        state = ns
    return fin_pos, fin_ow


def _emit_lanes(tables: LexerDeviceTables, x, fin_pos, fin_ow, l_iw: int,
                r_iw: int, reads=None):
    """The action gathers of _wp_emit (lexer.py:303-319): (skip, cand,
    lane), each (B, M): every start's skip target, whether it emits when
    visited, and its packed lane."""
    B, M = x.shape
    pos = torch.arange(M, dtype=torch.int32, device=x.device)
    is_l = x == l_iw
    valid = (x >= 0) & (x != r_iw)
    # XLA clamps the action gathers at both ends (lexer.py:308-310)
    o = fin_ow.clamp(0, tables.act_right.numel() - 1).long()
    right = tables.act_right[o]
    tag = torch.where(fin_ow >= 0, tables.act_tag[o], 0)
    fn = torch.where(fin_ow >= 0, tables.act_fn[o], -1)
    if reads is not None:
        for name in ("act_right", "act_tag", "act_fn"):
            reads.note(name, getattr(tables, name), o, fin_ow >= 0)
    from_orig = torch.where(is_l, pos, pos - 1)
    fpos_orig = fin_pos - 1
    from2 = from_orig.clamp(0, M - 1)
    to2 = (fpos_orig - right).clamp(0, M - 1)
    has = fin_pos >= 0
    skip_to = torch.where(has, torch.maximum(from_orig, fpos_orig - right),
                          from_orig)
    lane = ((tag + 1) | (from2 << 17) | (to2 << 24)
            | ((fn >= 0).to(torch.int32) << 31))
    return skip_to, valid & has & ((tag != 0) | (fn >= 0)), lane


def _emit_plain(tables: LexerDeviceTables, x, fin_pos, fin_ow, l_iw: int,
                r_iw: int, reads=None):
    """The SCAN + EMIT tail, _wp_emit (lexer.py:295-350): (B, M + 2)."""
    B, M = x.shape
    pos = torch.arange(M, dtype=torch.int32, device=x.device)
    skip_to, cand, lane = _emit_lanes(tables, x, fin_pos, fin_ow, l_iw, r_iw,
                                      reads)
    # the visited scan, sequential in the JAX package (lexer.py:298-302)
    emit = cand & visited_chain(skip_to, torch.full((B,), M, dtype=torch.int32,
                                                    device=x.device))
    # left compaction: stable order by (emitted ? pos : MAX)
    key = torch.where(emit, pos, INT32_MAX)
    skey, order = torch.sort(key, dim=1, stable=True)
    svals = torch.where(skey != INT32_MAX, lane.gather(1, order), 0)
    counts = emit.sum(dim=1, dtype=torch.int32)
    return torch.cat([svals, counts[:, None],
                      torch.zeros((B, 1), dtype=torch.int32, device=x.device)],
                     dim=1)


def visited_chain(skip: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """bool (B, M): the starts the reference's sequential FromPos scan
    (FALexTools_t.h:229-397) visits below ``end`` (int (B,)), the chain
    ``nv = 0, skip[0] + 2, skip[nv] + 2, ...`` of each row.

    ``f(p) = skip[p] + 2`` moves forward (``skip[p] >= p - 1``), so the
    chain is found by pointer doubling: in round k every marked start marks
    ``J_k(p)``, and ``J_{k+1} = J_k(J_k)``, saturating at the sentinel
    lane M (every jump to ``end`` or past it).  After round k the starts
    ``f^0(0) .. f^(2^(k+1) - 1)(0)`` are marked, and a jump from a chain
    start lands on the chain, so after ``ceil(log2 M)`` rounds the marks
    are exactly the chain below ``end``; the rounds stop once every row's
    ``J_k(0)`` is the sentinel (``f^(2^k)(0)`` past ``end``: the marks
    hold the whole chain).  K9 runs the same rounds in shared memory."""
    B, M = skip.shape
    dev = skip.device
    pos = torch.arange(M + 1, device=dev)
    end = end.to(torch.int64).clamp(0, M)[:, None]
    jump = torch.cat([skip.to(torch.int64) + 2,
                      torch.full((B, 1), M, dtype=torch.int64, device=dev)],
                     dim=1)
    jump = torch.where((pos < end) & (jump < end), jump, M)
    mark = torch.zeros((B, M + 1), dtype=torch.bool, device=dev)
    mark[:, 0] = end[:, 0] > 0
    for _ in range((M - 1).bit_length()):
        mark.scatter_(1, torch.where(mark, jump, M), True)
        jump = jump.gather(1, jump)
        if bool((jump[:, 0] == M).all()):  # every chain whole: J_k(0) done
            break
    return mark[:, :M] & (pos[:M] < end)


def _lexer_scan_plain(tables: LexerDeviceTables, x, init, ext_len,
                      reads=None):
    """The walk and the action gathers of lexer.py::lexer_pass
    (lexer.py:93-176): (valid & has, skip, tag, from2, to2, fn), each
    (B, M); ``skip`` is each start's FromPos skip target, whose chain
    :func:`visited_chain` follows.

    WALK: every start before the row's R anchor walks from the row's initial
    state, at most max_token_length + 1 steps; a step is the exact lookup,
    then the IW_ANY lookup for a real symbol whose state has no slot for it
    (both guarded as in :func:`comb_lookup`); past max_token_length only the
    R anchor may be consumed (lexer.py:126-133).  An explicitly DEAD
    transition ends the walk without the IW_ANY lookup, as the reference's
    GetDest returns -2, not -1, for it (runtime/lexer.py:64-69); JAX's walk
    falls back to IW_ANY there too (lexer.py:131).  And the state the
    L-anchor start reaches on the anchor alone is no match: the reference
    tests finality only after a character or the R anchor
    (runtime/lexer.py:140-168), where JAX's walk tests it at every step
    (lexer.py:134).  ROADMAP.md section C has these faults.  The deepest final gives the position and
    Moore Ow.  SCAN: the action gathers, clamped at both ends as XLA clamps
    them, and each start's skip target.  The JAX while loop runs
    until every lane of the batch is dead; a dead lane stays dead, so
    stopping there changes nothing.  ``reads`` as in
    :func:`_walk_dense_plain`."""
    B, M = x.shape
    dev = x.device
    i32 = torch.int32
    pos = torch.arange(M, dtype=i32, device=dev)
    L = tables.max_token_length + 1  # letters budget + anchor/R step
    xp = _pad_row(x, L)
    r_pos = (ext_len - 1)[:, None]  # ext index of the R anchor
    valid = pos < r_pos
    state = torch.where(valid, init[:, None], -1).to(i32)
    fin_pos = torch.full((B, M), -1, dtype=i32, device=dev)
    fin_ow = torch.full((B, M), -1, dtype=i32, device=dev)
    any_c = torch.full((B, M), tables.any_iw, dtype=i32, device=dev)
    n_states = tables.base.numel()
    for d in range(L):
        if not bool((state >= 0).any()):
            break
        c = xp[:, d : d + M]
        # the length gate, applied before the lookups it makes moot
        allowed = (d < tables.max_token_length) | (pos + d == r_pos)
        st = torch.where(allowed, state, -1)
        if reads is not None:
            reads.step((st >= 0) & (c >= 0))
        ns, hit = comb_lookup(tables, st, c, reads)
        need = ~hit & (c >= 0) & (st >= 0)
        ns = torch.where(need, comb_lookup(tables, torch.where(need, st, -1),
                                           any_c, reads)[0], ns)
        ns_safe = ns.clamp(0, n_states - 1).long()
        fin = (ns >= 0) & tables.final[ns_safe]
        if d == 0:
            fin &= pos != 0  # no match of the L anchor alone
        if reads is not None:
            reads.note("final", tables.final, ns_safe, ns >= 0)
            reads.note("moore_ow", tables.moore_ow, ns_safe, fin)
        fin_pos = torch.where(fin, pos + d, fin_pos)
        fin_ow = torch.where(fin, tables.moore_ow[ns_safe], fin_ow)
        state = ns

    # SCAN: spans in ORIGINAL coordinates (ext - 1), clamped to the span
    hi = (ext_len - 3).clamp(min=0)[:, None]  # max(in_size - 1, 0)
    o = fin_ow.clamp(0, tables.act_right.numel() - 1).long()
    right = tables.act_right[o]
    tag = torch.where(fin_ow >= 0, tables.act_tag[o], 0)
    fn = torch.where(fin_ow >= 0, tables.act_fn[o], -1)
    if reads is not None:
        for name in ("act_right", "act_tag", "act_fn"):
            reads.note(name, getattr(tables, name), o, fin_ow >= 0)
    from_orig = pos - 1  # the L-anchor start q = 0 is FromPos -1
    reach = fin_pos - 1 - right
    from2 = torch.minimum(from_orig.clamp(min=0), hi)
    to2 = torch.minimum(reach.clamp(min=0), hi)
    has = fin_pos >= 0
    skip = torch.where(has, torch.maximum(from_orig, reach), from_orig)
    return valid & has, skip, tag, from2, to2, fn


def _lexer_pass_plain(tables: LexerDeviceTables, x, init, ext_len,
                      reads=None):
    """The five (B, M) planes of lexer.py::lexer_pass (lexer.py:93-176):
    (visited bool, tag, from2, to2, fn int32): :func:`_lexer_scan_plain`,
    then the FromPos chain up to each row's R anchor
    (:func:`visited_chain`; no lane at or past it is valid).  ``reads`` as
    in :func:`_walk_dense_plain`."""
    cand, skip, tag, from2, to2, fn = _lexer_scan_plain(tables, x, init,
                                                        ext_len, reads)
    return visited_chain(skip, ext_len - 1) & cand, tag, from2, to2, fn


def pack5(visited, tag, from2, to2, fn) -> torch.Tensor:
    """Plain version of the concatenation K9 writes: (B, 5M) int32 (B12,
    runtime/lexer_host.py:29-41)."""
    return torch.cat([visited.to(torch.int32), tag, from2, to2, fn], dim=1)


def unpack5(packed: torch.Tensor):
    """The five planes of a (B, 5M) pack, visited as bool."""
    vis, tag, from2, to2, fn = packed.chunk(PLANES, dim=1)
    return vis != 0, tag, from2, to2, fn


def _pass_dense_plain(tables, dnext, ow_perm, x, init, l_iw, r_iw, lw, n_f,
                      n_a, reads=None):
    fin_pos, fin_ow = _walk_dense_plain(tables, dnext, ow_perm, x, init, r_iw,
                                        lw, n_f, n_a, reads)
    return _emit_plain(tables, x, fin_pos, fin_ow, l_iw, r_iw, reads)


def _pass_comb_plain(tables, x, init, l_iw, r_iw, lw, reads=None):
    fin_pos, fin_ow = _walk_comb_plain(tables, x, init, r_iw, lw, reads)
    return _emit_plain(tables, x, fin_pos, fin_ow, l_iw, r_iw, reads)


# ---------------------------------------------------------------- wrappers


def _check_rows(tables, x, init, lw, tail, out):
    B, M = x.shape
    if not 1 <= M <= MAX_ROW:
        raise ValueError(f"rows of 1..{MAX_ROW} lanes only, got {M}")
    if not (0 <= lw <= 4096 and 0 <= tail[1] <= 4096):
        raise ValueError(f"walk depth {lw} or {tail[1]} out of range")
    if not 0 <= tail[0] <= B:
        raise ValueError(f"the second class starts at row {tail[0]} of {B}")
    if tables.act_right.numel() < 1:
        raise ValueError("the grammar has no actions")
    kernels.check(x, torch.int32, (B, M), "x")
    kernels.check(init, torch.int32, (B, M), "init_lanes")
    if out is None:
        out = torch.empty((B, M + 2), dtype=torch.int32, device=x.device)
    kernels.check(out, torch.int32, (B, M + 2), "out")
    return out


def _plain_into(res, out):
    if out is None:
        return res
    out.copy_(res)
    return out


def _by_class(plain, x, init, lw: int, tail):
    """The plain pass ``plain(x, init, lw)`` of rows of up to two length
    classes: rows from ``tail[0]`` on walk ``tail[1]`` steps."""
    if tail is None:
        return plain(x, init, lw)
    s = tail[0]
    return torch.cat([plain(x[:s], init[:s], lw),
                      plain(x[s:], init[s:], tail[1])])


def wp_subword_pass_dense(tables: LexerDeviceTables, dnext, ow_perm,
                          x: torch.Tensor, init_lanes: torch.Tensor,
                          l_iw: int, r_iw: int, lw: int, n_f: int, n_a: int,
                          out: torch.Tensor | None = None,
                          tail: tuple[int, int] | None = None) -> torch.Tensor:
    """The sub-token pass with the one-gather dense walk (K7).

    x: int32 (B, M) packed ``[L w R]`` unit rows, -1 padding; init_lanes:
    int32 (B, M) PERMUTED initial state of each lane's unit.  Every row
    walks ``lw`` steps at most, or, with ``tail = (row, lw_tail)``, the rows
    from ``row`` on (a second length class) ``lw_tail``: one launch for
    both.  Returns (or writes into ``out``) int32 (B, M + 2): left-compacted
    lanes, the match count, a zero column.  Replaces
    lexer.py::wp_subword_pass_dense, called once a class."""
    if not kernels.on_card(x):
        return _plain_into(_by_class(
            lambda xs, ins, depth: _pass_dense_plain(
                tables, dnext, ow_perm, xs, ins, l_iw, r_iw, depth, n_f, n_a),
            x, init_lanes, lw, tail), out)
    B, M = x.shape
    tail = tail or (B, lw)
    out = _check_rows(tables, x, init_lanes, lw, tail, out)
    kernels.check(dnext, torch.int32, (dnext.numel(),), "dnext")
    kernels.check(ow_perm, torch.int32, (ow_perm.numel(),), "ow_perm")
    if B:
        kernels.launch(
            "wp_subword_dense", x.device,
            dnext.data_ptr(), dnext.numel(), ow_perm.data_ptr(),
            ow_perm.numel(), n_f, n_a, tables.act_right.data_ptr(),
            tables.act_tag.data_ptr(), tables.act_fn.data_ptr(),
            tables.act_right.numel(), x.data_ptr(), init_lanes.data_ptr(),
            B, M, l_iw, r_iw, lw, tail[0], tail[1], tables.max_token_length,
            out.data_ptr(),
        )
    return out


def wp_subword_pass(tables: LexerDeviceTables, x: torch.Tensor,
                    init_lanes: torch.Tensor, l_iw: int, r_iw: int, lw: int,
                    out: torch.Tensor | None = None,
                    tail: tuple[int, int] | None = None) -> torch.Tensor:
    """The sub-token pass with the comb walk (K8): the same contract as
    :func:`wp_subword_pass_dense`, with init_lanes in the comb's own state
    numbering.  On the card it reads the tables' chained slot records
    (``tables.chain``, built at the first launch) and ``state_rec``; the
    plain version reads the comb arrays.  Replaces
    lexer.py::wp_subword_pass."""
    if not kernels.on_card(x):
        return _plain_into(_by_class(
            lambda xs, ins, depth: _pass_comb_plain(
                tables, xs, ins, l_iw, r_iw, depth),
            x, init_lanes, lw, tail), out)
    B, M = x.shape
    tail = tail or (B, lw)
    out = _check_rows(tables, x, init_lanes, lw, tail, out)
    chain = tables.chain
    n_states = tables.state_rec.shape[0]
    kernels.check(tables.state_rec, torch.int32, (n_states, 4), "state_rec")
    if B:
        kernels.launch(
            "wp_subword_comb", x.device,
            chain.data_ptr(), tables.state_rec.data_ptr(), n_states,
            tables.n_slots, tables.act_right.data_ptr(),
            tables.act_tag.data_ptr(), tables.act_fn.data_ptr(),
            tables.act_right.numel(), x.data_ptr(), init_lanes.data_ptr(), B,
            M, l_iw, r_iw, lw, tail[0], tail[1], tables.max_token_length,
            out.data_ptr(),
        )
    return out


def _on(a, dtype, device) -> torch.Tensor:
    """``a`` (an array or a tensor) as a contiguous tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype).contiguous()


def lexer_pass_packed(tables: LexerDeviceTables, x_ext: torch.Tensor,
                      init_states: torch.Tensor, ext_len: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The pattern lexer's pass over a batch of rows (K9), its five planes
    written as one (B, 5M) int32 array: visited (0/1), tag, from2, to2, fn.

    x_ext: int32 (B, M) rows ``[L_ANCHOR, chars..., R_ANCHOR, -1 ...]`` of
    dense input weights; init_states: int32 (B,) each row's initial state;
    ext_len: int32 (B,) its characters + 2.  from2/to2 are RightCx-adjusted
    and clamped to the span in ORIGINAL coordinates (ext - 1).  Replaces
    lexer.py::lexer_pass with lexer_host.py::_pack5."""
    if not kernels.on_card(x_ext):
        return _plain_into(pack5(*_lexer_pass_plain(
            tables, x_ext, init_states, ext_len)), out)
    B, M = x_ext.shape
    if not 1 <= M <= MAX_LEXER_ROW:
        raise ValueError(f"rows of 1..{MAX_LEXER_ROW} lanes only, got {M}")
    if tables.act_right.numel() < 1:
        raise ValueError("the grammar has no actions")
    kernels.check(x_ext, torch.int32, (B, M), "x_ext")
    kernels.check(init_states, torch.int32, (B,), "init_states")
    kernels.check(ext_len, torch.int32, (B,), "ext_len")
    if out is None:
        out = torch.empty((B, PLANES * M), dtype=torch.int32,
                          device=x_ext.device)
    kernels.check(out, torch.int32, (B, PLANES * M), "out")
    if B:
        kernels.launch(
            "lexer_pass", x_ext.device,
            tables.state_rec.data_ptr(), tables.slot_rec.data_ptr(),
            tables.state_rec.shape[0], tables.slot_rec.shape[0],
            tables.act_right.data_ptr(), tables.act_tag.data_ptr(),
            tables.act_fn.data_ptr(), tables.act_right.numel(),
            tables.any_iw, tables.max_token_length, x_ext.data_ptr(),
            init_states.data_ptr(), ext_len.data_ptr(), B, M, out.data_ptr(),
        )
    return out


def lexer_pass(tables: LexerDeviceTables, x_ext, init_states, ext_len,
               device: str | torch.device | None = None):
    """(visited bool, tag, from2, to2, fn), each (B, M): the planes of
    :func:`lexer_pass_packed`, as lexer.py::lexer_pass returns them.  The
    inputs (arrays or tensors) go to ``device``, by default the tables'."""
    device = tables.base.device if device is None else torch.device(device)
    return unpack5(lexer_pass_packed(
        tables, _on(x_ext, torch.int32, device),
        _on(init_states, torch.int32, device),
        _on(ext_len, torch.int32, device)))
