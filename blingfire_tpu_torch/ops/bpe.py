"""Vectorized byte-BPE segmentation: the port of blingfire_tpu/ops/bpe.py.

The reference's sequential per-string algorithm
(FATokenSegmentationTools_1best_bpe_t.h:125-316) as batched phases:

  1. WALK     every start position walks the vocabulary trie in lockstep,
              one ``trie_next`` gather per depth, recording matches by depth;
  2. FILTER   the bpe-opt whole-token optimisation, fast-forward skips and
              unknown-run merging;
  3. SORT     arcs ordered by (id asc, start asc);
  4. CLAIM    greedy non-overlap resolution with a per-row bitmask (K2
              claims each segment between cuts on its own thread:
              :func:`claim_segments`);
  5. EMIT     claimed arcs written at their start and compacted left.

Three kernels live here, each beside its plain PyTorch version:
``scatter_trie`` (K3), ``bpe_walk`` (K1) and ``bpe_resolve`` (K2).  A
wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (``kernels/csrc/``) or raises.  The plain
versions follow the JAX package's scatter (CPU) formulation line for line,
so the tests hold them to it, and ``chip_smoke.py`` holds the kernels to
them on the card.

The walk takes the vocabulary trie when ops/tables.py::build_trie_table
built one, else the comb table (a vocabulary whose trie is too large).  A
BPE_OPT_WITH_MERGES model whose ranks are all negative runs in merge-priority
mode (trie finals numbered by priority); any other merges model runs in rank
mode: the walk records each match's rank and the resolve sorts on it first.
Two places differ from the JAX package on purpose (ROADMAP.md section C): the
comb lookup takes no transition when ``base[s] + c`` lies outside the table
(JAX clamps it, bpe.py:307), and the rank key orders floats as the reference
compares them (:func:`float_desc_key`; JAX's ``_float_desc_key``, bpe.py:181,
puts every rank >= +0.0 after every negative one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .tables import CombTable

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)
L_REC = 32  # walk depth when no length class caps it (bpe.py:234)
# K2's limits (kernels/csrc/bpe_resolve.cu): one block a row of at most
# RESOLVE_MAX_N positions, its arc slab of at most RESOLVE_MAX_ARCS arcs in
# shared memory.  runtime/host.py keeps every launch inside them.
RESOLVE_MAX_N = 1024
RESOLVE_MAX_ARCS = 4096
# K2's mark of a token that covers an overflowed start, in its start's bit
# 10 (bpe_resolve's ``mark``; = bpe_resolve.cu MARK_BIT)
MARK_BIT = 1 << 10


@dataclass(frozen=True)
class BpeDeviceTables:
    """Model tables for the BPE kernels, as tensors on ``device``."""

    base: torch.Tensor  # int32[n_states]
    owner: torch.Tensor  # int32[slots]
    nxt: torch.Tensor  # int32[slots]
    ow: torch.Tensor  # int32[slots]
    final: torch.Tensor  # bool[n_states]
    ids_tab: torch.Tensor  # int32[nkeys]
    ranks_tab: torch.Tensor  # float32[nkeys]
    # vocabulary trie (ops/tables.py::build_trie_table): final nodes are
    # numbered by token id (or merge priority), so the walk is one gather
    trie_next: torch.Tensor | None
    rank_by_id: torch.Tensor | None
    # merge-priority mode: trie finals numbered by (rank desc, id asc);
    # ids come back at emit through this table (bpe.py:70-77)
    prio2id: torch.Tensor | None
    n_slots: int
    max_len: int
    with_merges: bool
    fast: bool
    id_offset: int
    trie_root: int = -1
    trie_v: int = 0
    trie_a: int = 0


def make_device_tables(
    table: CombTable,
    ids: np.ndarray,
    ranks: np.ndarray,
    max_len: int,
    with_merges: bool,
    fast: bool,
    id_offset: int,
    trie=None,  # (edge_idx, edge_val, rank_by_id, root, n_nodes)
    device: str | torch.device = "cuda",
) -> BpeDeviceTables:
    """Port of blingfire_tpu/ops/bpe.py::make_device_tables (bpe.py:88-158).

    Keeps both trie numberings: plain (final node = token id) and
    merge-priority with ``prio2id``.  Only the CSR trie crosses to the
    device; ``scatter_trie`` densifies it there."""
    device = torch.device(device)
    assert int(ids.max(initial=0)) < (1 << 20), "ids must fit the packed-slot layout"
    assert max_len <= 128, "token depth must fit the packed-slot layout"

    def t32(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    trie_next = rank_by_id = prio2id = None
    trie_root, trie_v = -1, 0
    if trie is not None:
        edge_idx, edge_val, rk, trie_root, n_nodes = trie
        edge_idx = np.asarray(edge_idx, np.int64)
        edge_val = np.asarray(edge_val, np.int32)
        A = table.n_iws
        V = int(ids.max(initial=-1)) + 1
        if with_merges and len(ranks) and float(ranks.max()) < 0.0:
            # merge-priority numbering: entries sorted by (rank desc, id
            # asc); priority p+1 = p-th entry, 0 reserved for unknown
            order = np.lexsort((ids.astype(np.int64), -ranks))
            prio_of = np.zeros(V, np.int64)
            prio_of[ids[order].astype(np.int64)] = 1 + np.arange(len(order))
            unused = np.flatnonzero(prio_of == 0)  # ids never emitted
            prio_of[unused] = 1 + len(order) + np.arange(len(unused))
            n_prio = 1 + V
            assert n_prio < (1 << 20), "priorities must fit the slot layout"
            shift = n_prio - V  # internal nodes move up by one
            node = edge_idx // A
            ciw = edge_idx % A
            nodes_m = np.where(node < V, prio_of[np.minimum(node, V - 1)],
                               node + shift)
            vals_m = np.where(edge_val < V,
                              prio_of[np.minimum(edge_val, V - 1)],
                              edge_val + shift).astype(np.int32)
            edge_idx = nodes_m * A + ciw
            edge_val = vals_m
            trie_root = (int(prio_of[trie_root]) if trie_root < V
                         else trie_root + shift)
            trie_v = n_prio
            size = (n_nodes + shift) * A
            p2i = np.zeros(n_prio, np.int32)
            p2i[prio_of] = np.arange(V)
            prio2id = t32(p2i)
        else:
            trie_v = V
            size = n_nodes * A
            rank_by_id = t32(rk, torch.float32)
        trie_next = scatter_trie(
            torch.from_numpy(np.ascontiguousarray(edge_idx, np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(edge_val, np.int32)).to(device),
            int(size),
        )
    return BpeDeviceTables(
        base=t32(table.base),
        owner=t32(table.owner),
        nxt=t32(table.nxt),
        ow=t32(table.ow),
        final=t32(table.final, torch.bool),
        ids_tab=t32(ids),
        ranks_tab=t32(ranks, torch.float32),
        trie_next=trie_next,
        rank_by_id=rank_by_id,
        prio2id=prio2id,
        n_slots=table.n_slots,
        max_len=max_len,
        with_merges=with_merges,
        fast=fast,
        id_offset=id_offset,
        trie_root=int(trie_root),
        trie_v=trie_v,
        trie_a=table.n_iws,
    )


# ------------------------------------------------------------- K3 scatter


def _scatter_trie_plain(idx: torch.Tensor, vals: torch.Tensor, size: int):
    out = torch.full((size,), -1, dtype=torch.int32, device=idx.device)
    return out.index_put_((idx,), vals)


def scatter_trie(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """Dense int32[size] filled with -1 and scattered from the CSR trie.

    Replaces blingfire_tpu/ops/bpe.py::_scatter_trie (bpe.py:161).  Indices
    stay int64 (no int32 cast as at bpe.py:175)."""
    if not kernels.on_card(idx):
        return _scatter_trie_plain(idx, vals, size)
    E = idx.shape[0]
    kernels.check(idx, torch.int64, (E,), "idx")
    kernels.check(vals, torch.int32, (E,), "vals")
    out = torch.empty(size, dtype=torch.int32, device=idx.device)
    kernels.launch(
        "scatter_trie", idx.device,
        idx.data_ptr(), vals.data_ptr(), E, out.data_ptr(), size,
    )
    return out


# ------------------------------------------------------------------ K1 walk


def _walk_depth(tables: BpeDeviceTables, lw: int | None) -> int:
    L = tables.max_len
    return min(L, L_REC) if lw is None else min(lw, L)


def rank_mode(tables: BpeDeviceTables) -> bool:
    """A merges model outside merge-priority mode: the walk records ranks
    (bpe.py:319-324) and the resolve sorts on them (bpe.py:470, :570)."""
    return tables.with_merges and tables.prio2id is None


def _check_spm(spm_iw: int) -> None:
    if spm_iw < 0:
        # x_iw uses -1 for "no symbol": a negative ▁ weight would mark it
        raise ValueError(f"spm_iw must be the input weight of ▁, got {spm_iw}")


def _walk_plain(tables, x_iw, lengths, spm_iw: int, LW: int, overflow: bool,
                reads=None):
    """Plain version of K1: blingfire_tpu/ops/bpe.py::_walk_impl in trie or
    comb mode, with the comb lookup guarded; ``reads`` (a ``kernels.Reads``)
    notes the table entries it reads.  m_rank holds each match's rank (0.0
    where there is none) in rank mode and is None otherwise."""
    B, N = x_iw.shape
    dev = x_iw.device
    i32 = torch.int32
    pos = torch.arange(N, dtype=i32, device=dev)
    valid = pos[None, :] < lengths[:, None]
    pad = torch.full((B, LW + 1), -1, dtype=i32, device=dev)
    x_pad = torch.cat([x_iw, pad], dim=1)
    posl = torch.arange(N + LW + 1, dtype=i32, device=dev)
    spm_or_end = (x_pad == spm_iw) | (posl[None, :] >= lengths[:, None])
    use_trie = tables.trie_next is not None
    rank = rank_mode(tables)
    init = tables.trie_root if use_trie else 0  # comb: state 0 is initial
    state = torch.where(valid & (x_iw >= 0), init, -1).to(i32)
    sum_ow = torch.zeros((B, N), dtype=i32, device=dev)
    nkeys = tables.ids_tab.shape[0]
    packs, ranks = [], []
    for d in range(LW):
        c = x_pad[:, d : d + N]
        live = (state >= 0) & (c >= 0)
        if reads is not None:
            reads.step(live)
        if use_trie:
            trie, A, V = tables.trie_next, tables.trie_a, tables.trie_v
            flat = (state.clamp(min=0).long() * A + c.clamp(min=0).long()
                    ).clamp(0, trie.shape[0] - 1)
            ns = torch.where(live, trie[flat], -1)
            fin = (ns >= 0) & (ns < V)
            mid = ns.clamp(min=0)
            if reads is not None:
                reads.note("trie_next", trie, flat, live)
            if rank:
                rid = mid.clamp(max=V - 1).long()
                rk = tables.rank_by_id[rid]
                if reads is not None:
                    reads.note("rank_by_id", tables.rank_by_id, rid, fin)
        else:
            # the guard: no transition when the probe lies outside the
            # table (JAX clamps it into the table, bpe.py:307)
            s_safe = state.clamp(min=0).long()
            raw = tables.base[s_safe].long() + c.clamp(min=0).long()
            inb = (raw >= 0) & (raw < tables.n_slots)
            slot = raw.clamp(0, tables.n_slots - 1)
            hit = live & inb & (tables.owner[slot] == state)
            ns = torch.where(hit, tables.nxt[slot], -1)
            sum_ow = sum_ow + torch.where(hit, tables.ow[slot], 0)
            fin = (ns >= 0) & tables.final[ns.clamp(min=0).long()]
            key = sum_ow.clamp(0, nkeys - 1).long()
            mid = tables.ids_tab[key]
            if rank:
                rk = tables.ranks_tab[key]
            if reads is not None:
                reads.note("base", tables.base, s_safe, live)
                reads.note("owner", tables.owner, slot, live & inb)
                reads.note("nxt", tables.nxt, slot, hit)
                reads.note("ow", tables.ow, slot, hit)
                reads.note("final", tables.final, ns.clamp(min=0).long(), ns >= 0)
                reads.note("ids_tab", tables.ids_tab, key, fin)
                if rank:
                    reads.note("ranks_tab", tables.ranks_tab, key, fin)
        nxt_spm = spm_or_end[:, d + 1 : d + 1 + N].to(i32)
        packs.append(torch.where(fin, mid | (nxt_spm << 27), -1))
        if rank:
            ranks.append(torch.where(fin, rk, 0.0))
        state = ns
    m_pack = torch.stack(packs)
    m_rank = torch.stack(ranks) if rank else None
    if overflow:
        slot_overflow = state >= 0
    else:
        slot_overflow = torch.zeros((B, N), dtype=torch.bool, device=dev)
    return m_pack, m_rank, slot_overflow


def bpe_walk(
    tables: BpeDeviceTables,
    x_iw: torch.Tensor,  # int32 (B, N) dense input weights, -1 = none
    lengths: torch.Tensor,  # int32 (B,)
    spm_iw: int,  # input weight of ▁: is_spm = x_iw == spm_iw
    lw: int | None = None,  # walk-depth cap (unit-length class)
    bounded: bool = False,  # caller guarantees no match exceeds lw
):
    """WALK: returns (m_pack int32 (LW, B, N), m_rank float32 (LW, B, N) or
    None, slot_overflow bool (B, N)).

    m_pack[d, b, p] is the match of length d+1 starting at p (-1 = none):
    bits 0..19 token id, bit 27 set when the next symbol is ▁ or the end;
    m_rank[d, b, p] its rank, in rank mode only (:func:`rank_mode`).
    Replaces blingfire_tpu/ops/bpe.py::_walk_impl (bpe.py:242, jit :793);
    ``is_spm`` is derived from ``x_iw`` (the fold of dedup derive_spm): for
    a model whose alphabet lacks ▁, pass a weight no symbol has."""
    _check_spm(spm_iw)
    LW = _walk_depth(tables, lw)
    overflow = tables.max_len > LW and not bounded
    if not kernels.on_card(x_iw):
        return _walk_plain(tables, x_iw, lengths, spm_iw, LW, overflow)
    B, N = x_iw.shape
    kernels.check(x_iw, torch.int32, (B, N), "x_iw")
    kernels.check(lengths, torch.int32, (B,), "lengths")
    dev = x_iw.device
    m_pack = torch.empty((LW, B, N), dtype=torch.int32, device=dev)
    m_rank = (torch.empty((LW, B, N), dtype=torch.float32, device=dev)
              if rank_mode(tables) else None)
    slot_overflow = torch.empty((B, N), dtype=torch.bool, device=dev)
    if B == 0:
        return m_pack, m_rank, slot_overflow
    t = tables
    trie = t.trie_next
    rank_by_id = t.rank_by_id if trie is not None else None
    kernels.launch(
        "bpe_walk", dev,
        x_iw.data_ptr(), lengths.data_ptr(),
        trie.data_ptr() if trie is not None else None,
        trie.shape[0] if trie is not None else 0,
        t.base.data_ptr(), t.owner.data_ptr(), t.nxt.data_ptr(),
        t.ow.data_ptr(), t.final.data_ptr(), t.ids_tab.data_ptr(),
        t.ranks_tab.data_ptr(),
        rank_by_id.data_ptr() if rank_by_id is not None else None,
        t.base.shape[0], t.n_slots, t.ids_tab.shape[0],
        B, N, LW, t.trie_a, t.trie_v, t.trie_root, int(spm_iw),
        int(overflow), m_pack.data_ptr(),
        m_rank.data_ptr() if m_rank is not None else None,
        slot_overflow.data_ptr(),
    )
    return m_pack, m_rank, slot_overflow


# --------------------------------------------------------------- K2 resolve


def float_desc_key(r: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ranks: ascending keys are descending ranks, in
    the reference's order (…_bpe_with_merges_t.h:229,247): -0.0 ties +0.0,
    and +0.0 (an unknown run's rank) comes before every negative rank.

    Replaces blingfire_tpu/ops/bpe.py::_float_desc_key (bpe.py:181), which
    maps -0.0 to the first key and every rank >= +0.0 after every negative
    one (ROADMAP.md section C item 5).  -0.0 becomes +0.0, the sign-magnitude
    bits become an ordered int32 (``bits >= 0 ? bits : bits ^ 0x7FFFFFFF``),
    and NOT reverses the order."""
    bits = r.contiguous().view(torch.int32)
    bits = torch.where(bits == INT32_MIN, 0, bits)
    return ~torch.where(bits >= 0, bits, bits ^ INT32_MAX)


def _filter_plain(tables, m_pack, x_iw, lengths, spm_iw: int):
    """FILTER phase of the plain resolve: returns (survive (LR, B, N),
    run_start (B, N), run_end (B, N), anomaly (B,), valid (B, N))."""
    LR, B, N = m_pack.shape
    dev = m_pack.device
    i32 = torch.int32
    pos = torch.arange(N, dtype=i32, device=dev)
    valid = pos[None, :] < lengths[:, None]
    is_spm = x_iw == spm_iw
    dslot = torch.arange(LR, dtype=i32, device=dev)[:, None, None]
    valid_slot = m_pack >= 0
    m_whole = valid_slot & (((m_pack >> 27) & 1) == 1)

    has = valid_slot.any(dim=0)
    if tables.fast:
        vs = valid_slot.to(i32)
        prev_valid = (vs.cumsum(dim=0) - vs) > 0
        fired = m_whole & is_spm[None] & prev_valid
        dlast = torch.where(fired, dslot, -1).amax(dim=0).to(i32)
        ff = torch.where(dlast >= 0, pos[None, :] + dlast, pos[None, :])
        survive = valid_slot & (dslot >= dlast[None])
    else:
        ff = pos[None, :].expand(B, N)
        survive = valid_slot
    ff_eff = torch.where(ff > pos[None, :], ff, -1).to(i32)
    cummax_incl = torch.cummax(ff_eff, dim=1).values
    cover_before = torch.cat(
        [torch.full((B, 1), -1, dtype=i32, device=dev), cummax_incl[:, :-1]], dim=1)
    visited = (cover_before < pos[None, :]) & valid
    anomaly = ((ff_eff >= 0) & (cover_before >= pos[None, :])
               & (ff_eff > cover_before)).any(dim=1)
    survive = survive & visited[None]

    unk = visited & ~has
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    prev_unk = torch.cat([no, unk[:, :-1]], dim=1)
    next_unk = torch.cat([unk[:, 1:], no], dim=1)
    run_start = unk & ~prev_unk
    run_endpt = unk & ~next_unk
    endpos = torch.where(run_endpt, pos[None, :], INT32_MAX).to(i32)
    run_end = torch.cummin(endpos.flip(1), dim=1).values.flip(1)
    return survive, run_start, run_end, anomaly, valid


def _resolve_plain(tables, m_pack, m_rank, slot_overflow, x_iw, lengths,
                   spm_iw: int, unk_id: int, a_max: int, mark: bool = False):
    """Plain version of K2: blingfire_tpu/ops/bpe.py::_resolve_impl, scatter
    (CPU) branch; in rank mode the arcs sort on (:func:`float_desc_key` of
    the rank, id * N + start), the unknown runs' rank being +0.0.  With
    ``mark``, K2's marks (:func:`bpe_resolve`)."""
    LR, B, N = m_pack.shape
    dev = m_pack.device
    i32 = torch.int32
    pos = torch.arange(N, dtype=i32, device=dev)
    dslot = torch.arange(LR, dtype=i32, device=dev)[:, None, None]
    m_id = m_pack & 0xFFFFF
    survive, run_start, run_end, anomaly, valid = _filter_plain(
        tables, m_pack, x_iw, lengths, spm_iw)

    # ---- SORT: slot-major arc slab (flat index d*N + p), then unknown runs
    use_prio = tables.prio2id is not None
    n_arcs = survive.sum(dim=(0, 2)) + run_start.sum(dim=1)
    arc_overflow = n_arcs > a_max

    def flat(a):  # (LR, B, N) -> (B, LR*N)
        return a.permute(1, 0, 2).reshape(B, LR * N)

    starts = torch.cat([pos.repeat(LR)[None, :].expand(B, LR * N),
                        pos[None, :].expand(B, N)], dim=1)
    ends = torch.cat([flat((pos[None, None, :] + dslot).expand(LR, B, N)),
                      run_end.clamp(max=N - 1)], dim=1)
    unk_slab = torch.full((B, N), 0 if use_prio else unk_id, dtype=i32, device=dev)
    ids = torch.cat([flat(m_id), unk_slab], dim=1)
    avalid = torch.cat([flat(survive), run_start], dim=1)
    slot_pos = avalid.to(torch.int64).cumsum(dim=1) - 1
    keep_arc = avalid & (slot_pos < a_max)
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    dst = torch.where(keep_arc, rows * a_max + slot_pos, B * a_max).reshape(-1)

    def compact(src, fill):
        out = torch.full((B * a_max + 1,), fill, dtype=src.dtype, device=dev)
        out[dst] = src.reshape(-1)
        return out[: B * a_max].reshape(B, a_max)

    c_start = compact(starts, 0)
    c_end = compact(ends, 0)
    c_id = compact(ids, 0)
    c_valid = compact(avalid, False)
    ckey2 = torch.where(c_valid, c_id * N + c_start, INT32_MAX)
    if m_rank is not None:
        ranks = torch.cat([flat(m_rank), torch.zeros((B, N), dtype=torch.float32,
                                                      device=dev)], dim=1)
        key_rank = torch.where(c_valid, float_desc_key(compact(ranks, 0.0)),
                               INT32_MAX)
        # (key_rank, ckey2) lexicographic as one int64
        skey = key_rank.long() * (1 << 32) + (ckey2.long() - INT32_MIN)
    else:
        skey = ckey2
    s_idx = torch.sort(skey, dim=1, stable=True).indices
    s_start = c_start.gather(1, s_idx)
    s_end = c_end.gather(1, s_idx)
    s_id = c_id.gather(1, s_idx)
    s_valid = c_valid.gather(1, s_idx)

    # ---- CLAIM: greedy, in sort order; occ[q] = q is inside a claimed arc
    occ = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    claimed = torch.zeros((B, a_max), dtype=torch.bool, device=dev)
    pos1 = torch.arange(N + 1, dtype=i32, device=dev)[None, :]
    limit = int(min(int(n_arcs.max()), a_max)) if B else 0
    for a in range(limit):
        stt, en, vd = s_start[:, a], s_end[:, a], s_valid[:, a]
        q1 = stt.clamp(0, N).long()[:, None]
        q2 = (en + 1).clamp(0, N).long()[:, None]
        free1 = ~occ.gather(1, q1)[:, 0]
        free2 = (en + 1 >= lengths) | ~occ.gather(1, q2)[:, 0]
        claim = vd & free1 & free2
        occ |= claim[:, None] & (pos1 > stt[:, None]) & (pos1 <= en[:, None])
        claimed[:, a] = claim

    # ---- EMIT: last claim wins per start, interior test, left compaction
    keep = claimed & s_valid
    idx = torch.arange(a_max, dtype=i32, device=dev)[None, :].expand(B, a_max)
    flat_idx = torch.where(keep, rows * N + s_start, B * N).reshape(-1)
    win = torch.full((B * N + 1,), -1, dtype=i32, device=dev).scatter_reduce(
        0, flat_idx, idx.reshape(-1), reduce="amax")[: B * N].reshape(B, N)
    has_win = win >= 0
    win_safe = win.clamp(min=0).long()
    unk_grid = 0 if use_prio else unk_id
    grid_id = torch.where(has_win, s_id.gather(1, win_safe), unk_grid).to(i32)
    grid_tos = torch.where(has_win, s_end.gather(1, win_safe), 0).to(i32)

    tok_here = has_win & ~occ[:, :N] & valid
    out_slot = tok_here.to(torch.int64).cumsum(dim=1) - 1
    flat_o = torch.where(tok_here, rows * N + out_slot, B * N).reshape(-1)

    def emit_compact(srcv):
        out = torch.zeros((B * N + 1,), dtype=srcv.dtype, device=dev)
        out[flat_o] = srcv.reshape(-1)
        return out[: B * N].reshape(B, N)

    counts = tok_here.sum(dim=1).to(i32)
    over = slot_overflow & valid
    grid_start = pos[None, :].expand(B, N)
    whole = over.any(dim=1)
    if mark:
        # overflowed positions inside each token: a difference of their
        # inclusive count at the token's end and before its start
        n_over = over.to(i32).cumsum(dim=1)
        before = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                            n_over[:, :-1]], dim=1)
        inside = torch.where(
            tok_here, n_over.gather(1, grid_tos.clamp(0, N - 1).long()) - before,
            0)
        grid_start = grid_start | torch.where(inside > 0, MARK_BIT, 0).to(i32)
        whole = inside.sum(dim=1) < over.sum(dim=1)
    raw = emit_compact(grid_id)
    if use_prio:
        raw = torch.where(
            raw == 0, unk_id,
            tables.prio2id[raw.clamp(0, tables.trie_v - 1).long()]).to(i32)
        raw = torch.where(pos[None, :] < counts[:, None], raw, 0)
    out_ids = (raw + tables.id_offset).to(i32)
    out_starts = emit_compact(grid_start.contiguous())
    out_ends = emit_compact(grid_tos)
    fallback = whole | arc_overflow | anomaly
    return out_ids, out_starts, out_ends, counts, fallback


@dataclass
class ClaimArcs:
    """The arcs K2 keeps, in slab order (B, LR*N + N lanes: slot-major
    matches, then the unknown runs), with the claim segment of each."""

    start: torch.Tensor  # int32
    end: torch.Tensor  # int32
    id: torch.Tensor  # int32: the match's id (or priority); a run's unk id
    rank: torch.Tensor | None  # float32 in rank mode (a run's +0.0)
    keep: torch.Tensor  # bool: an arc, and among the row's first a_max
    seg: torch.Tensor  # int32: cuts at or before the start
    n_arcs: torch.Tensor  # (B,) int64: arcs before the a_max cut
    depth: torch.Tensor  # (B,) int64: the largest segment's kept arcs


def claim_segments(tables, m_pack, m_rank, x_iw, lengths, spm_iw: int,
                   unk_id: int, a_max: int) -> ClaimArcs:
    """K2's claim segments, on the host: position q (0 < q < N) is a cut
    when no kept arc has st < q <= en, and an arc's segment is the number
    of cuts at or before its start.  No claim marks a cut interior, and a
    claim reads only its own segment's positions and the cut that ends it,
    so claiming each segment on its own, in the row's sort order, gives the
    row's claims; ``depth`` is the serial claim depth of K2.  The tests and
    chip_smoke.py use it; no path runs it."""
    LR, B, N = m_pack.shape
    dev = m_pack.device
    i32 = torch.int32
    pos = torch.arange(N, dtype=i32, device=dev)
    dslot = torch.arange(LR, dtype=i32, device=dev)[:, None, None]
    survive, run_start, run_end, _anomaly, _valid = _filter_plain(
        tables, m_pack, x_iw, lengths, spm_iw)

    def flat(a):  # (LR, B, N) -> (B, LR*N)
        return a.permute(1, 0, 2).reshape(B, LR * N)

    start = torch.cat([pos.repeat(LR)[None, :].expand(B, LR * N),
                       pos[None, :].expand(B, N)], dim=1)
    end = torch.cat([flat((pos[None, None, :] + dslot).expand(LR, B, N)),
                     run_end.clamp(max=N - 1)], dim=1)
    run_id = 0 if tables.prio2id is not None else unk_id
    ids = torch.cat([flat(m_pack & 0xFFFFF),
                     torch.full((B, N), run_id, dtype=i32, device=dev)], dim=1)
    rank = None if m_rank is None else torch.cat(
        [flat(m_rank), torch.zeros((B, N), dtype=torch.float32, device=dev)],
        dim=1)
    arc = torch.cat([flat(survive), run_start], dim=1)
    keep = arc & (arc.to(torch.int64).cumsum(dim=1) <= a_max)
    far = torch.full((B, N), -1, dtype=i32, device=dev).scatter_reduce(
        1, start.long(), torch.where(keep, end, -1), reduce="amax")
    cover = torch.cummax(far, dim=1).values
    cut = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     cover[:, :-1] < pos[None, 1:]], dim=1)
    seg = cut.to(i32).cumsum(dim=1, dtype=i32).gather(1, start.long())
    size = torch.zeros((B, N), dtype=torch.int64, device=dev).scatter_add(
        1, seg.long(), keep.to(torch.int64))
    return ClaimArcs(start, end, ids, rank, keep, seg,
                     arc.sum(dim=1), size.amax(dim=1))


def bpe_resolve(
    tables: BpeDeviceTables,
    m_pack: torch.Tensor,  # int32 (LR, B, N) from bpe_walk
    m_rank: torch.Tensor | None,  # float32 (LR, B, N) in rank mode, else None
    slot_overflow: torch.Tensor,  # bool (B, N)
    x_iw: torch.Tensor,  # int32 (B, N)
    lengths: torch.Tensor,  # int32 (B,)
    spm_iw: int,
    unk_id: int,
    a_max: int,
    mark: bool = False,  # overflow marks the token, not the row
):
    """FILTER+SORT+CLAIM+EMIT: returns (ids, starts, ends int32 (B, N),
    counts int32 (B,), fallback bool (B,)).

    Replaces blingfire_tpu/ops/bpe.py::_resolve_impl (bpe.py:340, jit :794)
    with the fallback flags of its scatter branch
    (slot_overflow | arc_overflow | anomaly), and the rank key of the
    reference (:func:`float_desc_key`).

    With ``mark``, a start with ``slot_overflow`` flags the token that
    covers it and not the row: such a token's start carries MARK_BIT (N is
    at most 1,024, so starts need bits 0-9 only), and the row's flag is
    arc_overflow | anomaly, or an overflowed position that no token covers.
    Under a chunk-safe vocabulary a match stays inside its unit, so the
    marked tokens name the units that the walk's depth cap may have
    changed; the row's other tokens are exact."""
    _check_spm(spm_iw)
    if not -(1 << 20) <= unk_id < (1 << 20):
        # ids < 2^20 and N <= 1024 keep the key id * N + start inside int32,
        # where the kernel's (id, start) order and the plain version's agree
        raise ValueError(f"unk_id {unk_id} does not fit 21 bits")
    if (m_rank is not None) != rank_mode(tables):
        raise ValueError("m_rank must be given in rank mode and only there")
    LR, B, N = m_pack.shape
    if mark and N > MARK_BIT:
        raise ValueError(f"marks need rows of at most {MARK_BIT} symbols, "
                         f"got {N}")
    if not kernels.on_card(m_pack):
        return _resolve_plain(tables, m_pack, m_rank, slot_overflow, x_iw,
                              lengths, spm_iw, unk_id, a_max, mark)
    kernels.check(m_pack, torch.int32, (LR, B, N), "m_pack")
    if m_rank is not None:
        kernels.check(m_rank, torch.float32, (LR, B, N), "m_rank")
    kernels.check(slot_overflow, torch.bool, (B, N), "slot_overflow")
    kernels.check(x_iw, torch.int32, (B, N), "x_iw")
    kernels.check(lengths, torch.int32, (B,), "lengths")
    if not (1 <= N <= RESOLVE_MAX_N and 1 <= LR <= L_REC
            and 1 <= a_max <= RESOLVE_MAX_ARCS):
        raise ValueError(f"bpe_resolve kernel takes N<={RESOLVE_MAX_N}, "
                         f"LR<={L_REC}, a_max<={RESOLVE_MAX_ARCS}; got N={N} "
                         f"LR={LR} a_max={a_max}")
    dev = m_pack.device
    out_ids = torch.empty((B, N), dtype=torch.int32, device=dev)
    out_starts = torch.empty((B, N), dtype=torch.int32, device=dev)
    out_ends = torch.empty((B, N), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    fallback = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out_ids, out_starts, out_ends, counts, fallback
    p2i = tables.prio2id
    kernels.launch(
        "bpe_resolve", dev,
        m_pack.data_ptr(), m_rank.data_ptr() if m_rank is not None else None,
        slot_overflow.data_ptr(), x_iw.data_ptr(),
        lengths.data_ptr(), p2i.data_ptr() if p2i is not None else None,
        B, N, LR, a_max, int(spm_iw), int(unk_id), tables.id_offset,
        int(tables.fast), tables.trie_v, int(mark),
        out_ids.data_ptr(), out_starts.data_ptr(), out_ends.data_ptr(),
        counts.data_ptr(), fallback.data_ptr(),
    )
    return out_ids, out_starts, out_ends, counts, fallback


def bpe_segment(
    tables: BpeDeviceTables,
    x_iw: torch.Tensor,
    lengths: torch.Tensor,
    spm_iw: int,
    unk_id: int,
    a_max: int,
    lw: int | None = None,
    bounded: bool = False,
    mark: bool = False,
):
    """Walk then resolve: (ids, starts, ends, counts, fallback); ``mark``
    as :func:`bpe_resolve`."""
    m_pack, m_rank, slot_overflow = bpe_walk(tables, x_iw, lengths, spm_iw,
                                             lw=lw, bounded=bounded)
    return bpe_resolve(tables, m_pack, m_rank, slot_overflow, x_iw, lengths,
                       spm_iw, unk_id, a_max, mark)
