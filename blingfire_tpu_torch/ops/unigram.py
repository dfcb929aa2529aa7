"""Vectorized SentencePiece unigram-LM Viterbi segmentation: the port of
blingfire_tpu/ops/unigram.py.

Reference semantics: FATokenSegmentationTools_1best_t.h:174-279.  For every
start position walk the vocabulary Mealy automaton; at each final state
relax the best arc per end (score = float32 token score + double best of the
position before the start, strict improvement, starts in ascending order);
an unknown start adds a -100000 arc of length 1 that merges with a preceding
unknown run; backtrace from the last position.

The JAX package's one device program (``unigram_segment``, unigram.py:145)
is split into two kernels, each beside its plain PyTorch version:

  K5 ``unigram_walk``     WALK: every (row, start) walks up to L symbols in
                          one of three table modes (dense packed, wide
                          two-word slots, comb) and records the Mealy key
                          and score of every final by (start, depth);
  K6 ``unigram_viterbi``  the arcs re-indexed by end (``start = e - d``),
                          the DP over positions in df64 pairs
                          (ops/dfloat.py), the backtrace, the deferred id
                          gather and the left compaction.

A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (``kernels/csrc/``) or raises.  The plain
versions follow unigram.py line for line, XLA's silent gather clamps made
explicit, so the tests hold them to it, and ``chip_smoke.py`` holds the
kernels to them on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .dfloat import df_add
from .tables import CombTable

UNK_SCORE = -100000.0
NEG_INF = float(np.finfo(np.float32).min)  # -FLT_MAX: reference initial best

# dense transition table limits: (ow << 16) | ((next + 1) << 1) | final
_DENSE_MAX_ENTRIES = 16 << 20  # 64 MB of int32
_DENSE_MAX_STATE = (1 << 15) - 2
_DENSE_MAX_OW = (1 << 15) - 1
_WIDE_OWNER_SENTINEL = (1 << 17) - 1  # empty-slot owner: matches no state

MODE_DENSE, MODE_WIDE, MODE_COMB = 0, 1, 2
# K6's shared memory a row (kernels/csrc/unigram_viterbi.cu): 5 bytes a
# position (a word and flags) beside a ring of four arc tiles of 16
# positions (512 L bytes; 16,384 at L = 32), or beside a best ring of R > L
# positions (8 R bytes) when L > 32, within a block's 232,448 bytes:
# (232,448 - 16,384) / 5 = 43,212 positions, rounded down to a power of two
VITERBI_SMEM = 232448
VITERBI_MAX_N = 32768
VITERBI_MAX_L = 4096  # a best ring of 8,192 positions beside 32,768


@dataclass(frozen=True)
class UnigramDeviceTables:
    """Model tables for the unigram kernels, as tensors on ``device``."""

    base: torch.Tensor  # int32[n_states]
    owner: torch.Tensor  # int32[slots]
    nxt: torch.Tensor  # int32[slots]
    ow: torch.Tensor  # int32[slots]
    final: torch.Tensor  # bool[n_states]
    ids_tab: torch.Tensor  # int32[nkeys]
    scores_tab: torch.Tensor  # float32[nkeys]
    dense: torch.Tensor | None  # int32[n_states * A] packed, or None
    # wide slot packing (models whose states x alphabet exceed the dense
    # limits): wide_a = owner(17) | final<<17 | ow_low14<<18,
    # wide_b = (nxt+1)(17) | ow_high<<17, both at the comb slot index
    wide_a: torch.Tensor | None
    wide_b: torch.Tensor | None
    n_slots: int
    max_len: int
    id_offset: int
    n_iws: int = 0

    @property
    def mode(self) -> int:
        if self.dense is not None:
            return MODE_DENSE
        return MODE_WIDE if self.wide_a is not None else MODE_COMB


def make_device_tables(
    table: CombTable,
    ids: np.ndarray,
    scores: np.ndarray,
    max_len: int,
    id_offset: int,
    device: str | torch.device = "cuda",
) -> UnigramDeviceTables:
    """Port of blingfire_tpu/ops/unigram.py::make_device_tables
    (unigram.py:81-142): the same mode choice and the same packed words,
    built in NumPy and uploaded once."""
    device = torch.device(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    dense = wide_a = wide_b = None
    n_states = int(table.base.shape[0])
    A = int(table.n_iws)
    ow_np = np.asarray(table.ow)
    ow_max = int(ow_np.max(initial=0))
    owner_np = np.asarray(table.owner)
    occ = np.flatnonzero(owner_np >= 0)
    owner = owner_np[occ]
    nxt = np.asarray(table.nxt)[occ]
    fin = np.where(nxt >= 0, np.asarray(table.final)[np.maximum(nxt, 0)], False)
    if (
        n_states * A <= _DENSE_MAX_ENTRIES
        and n_states <= _DENSE_MAX_STATE
        and ow_max <= _DENSE_MAX_OW
    ):
        d = np.zeros(n_states * A, np.int32)
        iw = occ - np.asarray(table.base)[owner]
        keep = (iw >= 0) & (iw < A)
        val = (
            (ow_np[occ].astype(np.int32) << 16)
            | ((nxt.astype(np.int32) + 1) << 1)
            | fin.astype(np.int32)
        )
        d[owner[keep] * A + iw[keep]] = np.where(nxt[keep] >= 0, val[keep], 0)
        dense = t(d)
    elif n_states < _WIDE_OWNER_SENTINEL and ow_max < (1 << 17):
        a = np.full(table.n_slots, _WIDE_OWNER_SENTINEL, np.int32)
        b = np.zeros(table.n_slots, np.int32)
        ow = ow_np[occ].astype(np.int32)
        live = nxt >= 0
        a[occ[live]] = (
            owner[live]
            | (fin[live].astype(np.int32) << 17)
            | ((ow[live] & 0x3FFF) << 18)
        )
        b[occ[live]] = (nxt[live] + 1) | ((ow[live] >> 14) << 17)
        wide_a, wide_b = t(a), t(b)
    return UnigramDeviceTables(
        base=t(table.base),
        owner=t(table.owner),
        nxt=t(table.nxt),
        ow=t(table.ow),
        final=t(table.final, torch.bool),
        ids_tab=t(ids),
        scores_tab=t(scores, torch.float32),
        dense=dense,
        wide_a=wide_a,
        wide_b=wide_b,
        n_slots=table.n_slots,
        max_len=max_len,
        id_offset=id_offset,
        n_iws=A,
    )


def walk_depth(tables: UnigramDeviceTables, lw: int | None) -> int:
    """L: the walk depth and DP ring length (unigram.py:157)."""
    return tables.max_len if lw is None else min(lw, tables.max_len)


# ------------------------------------------------------------------ K5 walk


def walk_step(tables: UnigramDeviceTables, state, c, reads=None):
    """One lockstep transition of every lane (unigram.py:175-205), every
    gather but the comb slot clamped as XLA clamps it.  Returns (next state, ow to add,
    final).  ``reads`` (a ``kernels.Reads``) notes the entries it reads."""
    live = (state >= 0) & (c >= 0)
    if reads is not None:
        reads.step(live)
    if tables.dense is not None:
        dense = tables.dense
        flat = (state.clamp(min=0).long() * tables.n_iws
                + c.clamp(min=0).long()).clamp(0, dense.numel() - 1)
        e = torch.where(live, dense[flat], 0)
        if reads is not None:
            reads.note("dense", dense, flat, live)
        ns = ((e >> 1) & 0x7FFF) - 1
        return ns, torch.where(e != 0, e >> 16, 0), (e & 1) == 1
    s_safe = state.clamp(min=0).long()
    # a slot outside [0, n_slots) is no transition; JAX clamps it
    # (unigram.py:179), which false-hits from the state owning slot 0
    # (ROADMAP.md section C; ops/lexer.py::comb_lookup)
    raw = tables.base[s_safe].long() + c.clamp(min=0).long()
    inside = live & (raw >= 0) & (raw < tables.n_slots)
    slot = raw.clamp(0, tables.n_slots - 1)
    if reads is not None:
        reads.note("base", tables.base, s_safe, live)
    if tables.wide_a is not None:
        ea = tables.wide_a[slot]
        eb = tables.wide_b[slot]
        hit = ((ea & 0x1FFFF) == state) & inside
        if reads is not None:
            reads.note("wide_a", tables.wide_a, slot, inside)
            reads.note("wide_b", tables.wide_b, slot, hit)
        ns = torch.where(hit, (eb & 0x1FFFF) - 1, -1)
        ow = ((ea >> 18) & 0x3FFF) | ((eb >> 17) << 14)
        return ns, torch.where(hit, ow, 0), hit & (((ea >> 17) & 1) == 1)
    hit = (tables.owner[slot] == state) & inside
    ns = torch.where(hit, tables.nxt[slot], -1)
    n_states = tables.final.numel()
    ns_safe = ns.clamp(0, n_states - 1).long()
    fin = (ns >= 0) & tables.final[ns_safe]
    if reads is not None:
        reads.note("owner", tables.owner, slot, inside)
        for name in ("nxt", "ow"):
            reads.note(name, getattr(tables, name), slot, hit)
        reads.note("final", tables.final, ns_safe, ns >= 0)
    return ns, torch.where(hit, tables.ow[slot], 0), fin


def _walk_plain(tables: UnigramDeviceTables, x_iw, lengths, L: int,
                reads=None):
    """Plain version of K5: the WALK of unigram.py:164-213; ``reads`` as
    in :func:`walk_step`."""
    B, N = x_iw.shape
    dev = x_iw.device
    i32 = torch.int32
    pos = torch.arange(N, dtype=i32, device=dev)
    valid = pos[None, :] < lengths[:, None]
    nkeys = tables.ids_tab.numel()
    x_pad = torch.cat([x_iw, torch.full((B, L + 1), -1, dtype=i32, device=dev)], 1)
    state = torch.where(valid & (x_iw >= 0), 0, -1).to(i32)
    sum_ow = torch.zeros((B, N), dtype=i32, device=dev)
    keys, scores = [], []
    for d in range(L):
        ns, ow, fin = walk_step(tables, state, x_pad[:, d : d + N], reads)
        sum_ow = sum_ow + ow.to(i32)
        key = sum_ow.clamp(0, nkeys - 1)
        if reads is not None:
            reads.note("scores_tab", tables.scores_tab, key, fin)
        keys.append(torch.where(fin, key, -1).to(i32))
        scores.append(torch.where(fin, tables.scores_tab[key.long()], NEG_INF))
        state = ns.to(i32)
    return torch.stack(keys, dim=2), torch.stack(scores, dim=2)


def unigram_walk(
    tables: UnigramDeviceTables,
    x_iw: torch.Tensor,  # int32 (B, N) dense input weights, -1 = none
    lengths: torch.Tensor,  # int32 (B,)
    lw: int | None = None,  # depth cap (unit-length class), exact when no
    # arc is longer
):
    """WALK: (m_key int32 (B, N, L), m_score float32 (B, N, L)) by (start,
    depth): the Mealy key of the match of length d+1 at start p, -1 where
    none, and its score, -FLT_MAX where none.  L = ``walk_depth(lw)``.

    Replaces the walk of blingfire_tpu/ops/unigram.py::unigram_segment
    (unigram.py:164-213).  Like it, the walk reads ``x_iw`` past
    ``lengths`` after its first step; only the start is masked."""
    L = walk_depth(tables, lw)
    if L < 1:
        raise ValueError(f"unigram_walk needs a depth >= 1, got {L}")
    if not kernels.on_card(x_iw):
        return _walk_plain(tables, x_iw, lengths, L)
    B, N = x_iw.shape
    kernels.check(x_iw, torch.int32, (B, N), "x_iw")
    kernels.check(lengths, torch.int32, (B,), "lengths")
    dev = x_iw.device
    m_key = torch.empty((B, N, L), dtype=torch.int32, device=dev)
    m_score = torch.empty((B, N, L), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return m_key, m_score
    t = tables
    dense, wa, wb = t.dense, t.wide_a, t.wide_b
    kernels.launch(
        "unigram_walk", dev,
        x_iw.data_ptr(), lengths.data_ptr(), t.mode,
        dense.data_ptr() if dense is not None else None,
        dense.numel() if dense is not None else 0,
        t.base.data_ptr(), t.owner.data_ptr(), t.nxt.data_ptr(),
        t.ow.data_ptr(), t.final.data_ptr(),
        wa.data_ptr() if wa is not None else None,
        wb.data_ptr() if wb is not None else None,
        t.n_slots, t.final.numel(), t.scores_tab.data_ptr(),
        t.scores_tab.numel(), B, N, L, t.n_iws,
        m_key.data_ptr(), m_score.data_ptr(),
    )
    return m_key, m_score


# --------------------------------------------------------------- K6 Viterbi


def _viterbi_plain(tables: UnigramDeviceTables, m_key, m_score, lengths,
                   unk_id: int):
    """Plain version of K6: unigram.py:214-351 (roll_d, the DP scan, the
    backtrace, the id gather and the compaction)."""
    B, N, L = m_key.shape
    dev = m_key.device
    i32, f32 = torch.int32, torch.float32
    pos = torch.arange(N, dtype=i32, device=dev)
    valid = pos[None, :] < lengths[:, None]
    nkeys = tables.ids_tab.numel()
    has_match = (m_key >= 0).any(dim=2)

    # re-index arcs by END: end_*[b, e, d] = arc starting at e-d of length d+1
    dgrid = torch.arange(L, dtype=i32, device=dev)
    ok = pos[None, :, None] - dgrid[None, None, :] >= 0  # (1, N, L)

    def roll_d(a, fill):
        r = torch.stack([torch.roll(a[:, :, d], d, dims=1) for d in range(L)], 2)
        return torch.where(ok, r, fill)

    end_key = roll_d(m_key, -1)
    end_ok = end_key >= 0
    end_score = torch.where(end_ok, roll_d(m_score, NEG_INF), NEG_INF)
    unk_start = ~has_match & valid

    # DP: candidates at end e in reference order, depth L-1 down to 0, then
    # the unknown arc; the first maximal (hi, lo) wins (strict improvement)
    ring_hi = torch.full((B, L), NEG_INF, dtype=f32, device=dev)
    ring_lo = torch.zeros((B, L), dtype=f32, device=dev)
    prev_unk = torch.zeros(B, dtype=torch.bool, device=dev)
    prev_begin = torch.zeros(B, dtype=i32, device=dev)
    cand_d = torch.cat([dgrid.flip(0), dgrid[:1] * 0])[None, :].expand(B, L + 1)
    unk_t, begin_t = [], []
    for e in range(N):
        before = (e - dgrid - 1 >= 0)[None, :]  # (1, L)
        base_hi = torch.where(before, ring_hi, 0.0)
        base_lo = torch.where(before, ring_lo, 0.0)
        eok = end_ok[:, e]
        c_hi, c_lo = df_add(base_hi, base_lo, end_score[:, e])
        c_hi = torch.where(eok, c_hi, NEG_INF)
        c_lo = torch.where(eok, c_lo, 0.0)
        # unknown candidate: start == e, score -1e5 + best[e-1]
        u_base = (ring_hi[:, 0], ring_lo[:, 0]) if e >= 1 else (
            torch.zeros(B, dtype=f32, device=dev),) * 2
        u_hi, u_lo = df_add(*u_base, UNK_SCORE)
        u_hi = torch.where(unk_start[:, e], u_hi, NEG_INF)
        u_lo = torch.where(unk_start[:, e], u_lo, 0.0)
        cand_hi = torch.cat([c_hi.flip(1), u_hi[:, None]], 1)
        cand_lo = torch.cat([c_lo.flip(1), u_lo[:, None]], 1)
        best_hi = cand_hi.max(dim=1, keepdim=True).values
        is_max_hi = cand_hi == best_hi
        lo_masked = torch.where(is_max_hi, cand_lo, NEG_INF)
        best_lo = lo_masked.max(dim=1, keepdim=True).values
        # argmax of a 0/1 mask returns its first maximum
        winner = (is_max_hi & (lo_masked == best_lo)).to(torch.uint8).argmax(dim=1)
        w_hi = cand_hi.gather(1, winner[:, None])[:, 0]
        w_lo = cand_lo.gather(1, winner[:, None])[:, 0]
        w_unk = winner == L
        begin = e - cand_d.gather(1, winner[:, None])[:, 0]
        # unknown-run merge (prev_unk is False at e = 0)
        begin = torch.where(w_unk & prev_unk, prev_begin, begin).to(i32)
        vald = valid[:, e]
        w_hi = torch.where(vald, w_hi, NEG_INF)
        w_lo = torch.where(vald, w_lo, 0.0)
        ring_hi = torch.cat([w_hi[:, None], ring_hi[:, :-1]], 1)
        ring_lo = torch.cat([w_lo[:, None], ring_lo[:, :-1]], 1)
        prev_unk, prev_begin = w_unk, begin
        unk_t.append(w_unk)
        begin_t.append(begin)
    best_unk = torch.stack(unk_t, 1)  # (B, N): winner at e is the unknown arc
    best_begin = torch.stack(begin_t, 1)

    # BACKTRACE: reverse scan marking segment ends
    cur = (lengths - 1).to(i32)
    emit = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for e in range(N - 1, -1, -1):
        em = cur == e
        emit[:, e] = em
        cur = torch.where(em, best_begin[:, e] - 1, cur)
    emit &= valid

    # ids: one deferred gather for the winning arcs; merged unknown runs
    # exceed L here, so both indices are clamped as XLA clamps them
    w_d = (pos[None, :] - best_begin).clamp(0, L - 1)
    w_key = m_key.reshape(B, N * L).gather(
        1, (best_begin.clamp(0, N - 1) * L + w_d).long())
    w_id = torch.where(best_unk, unk_id,
                       tables.ids_tab[w_key.clamp(0, nkeys - 1).long()]).to(i32)

    # left compaction
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    out_slot = emit.to(torch.int64).cumsum(dim=1) - 1
    flat_o = torch.where(emit, rows * N + out_slot, B * N).reshape(-1)

    def emit_compact(src):
        out = torch.zeros(B * N + 1, dtype=i32, device=dev)
        out[flat_o] = src.reshape(-1).to(i32)
        return out[: B * N].reshape(B, N)

    out_ends = emit_compact(pos[None, :].expand(B, N))
    out_starts = emit_compact(best_begin)
    out_ids = emit_compact(w_id) + tables.id_offset
    counts = emit.sum(dim=1).to(i32)
    return out_ids, out_starts, out_ends, counts


def viterbi_lane_group(L: int, N: int) -> int:
    """The lanes of K6's row group at depth L and row width N, as its
    launcher (bf_unigram_viterbi) picks them: the smallest power of two >= L,
    doubled while a warp's rows would not fit in VITERBI_SMEM; 32 (one row a
    warp, strided candidates) when L > 32."""
    if L > 32:
        return 32
    g = 1 << (L - 1).bit_length()
    stride = -(-(32 * 16 * L + 5 * N) // 16) * 16  # four 16-position tiles
    while g < 32 and (32 // g) * stride > VITERBI_SMEM:
        g *= 2
    return g


def unigram_viterbi(
    tables: UnigramDeviceTables,
    m_key: torch.Tensor,  # int32 (B, N, L) from unigram_walk
    m_score: torch.Tensor,  # float32 (B, N, L)
    lengths: torch.Tensor,  # int32 (B,)
    unk_id: int,
):
    """DP + BACKTRACE + EMIT: (ids, starts, ends int32 (B, N), counts int32
    (B,)), left-compacted.  Padding lanes hold ``id_offset`` in ids and 0 in
    starts and ends; unknown tokens emit ``unk_id + id_offset``.

    Replaces everything after the walk in blingfire_tpu/ops/unigram.py::
    unigram_segment (unigram.py:214-351)."""
    if not kernels.on_card(m_key):
        return _viterbi_plain(tables, m_key, m_score, lengths, unk_id)
    B, N, L = m_key.shape
    kernels.check(m_key, torch.int32, (B, N, L), "m_key")
    kernels.check(m_score, torch.float32, (B, N, L), "m_score")
    kernels.check(lengths, torch.int32, (B,), "lengths")
    if not (1 <= L <= VITERBI_MAX_L and N <= VITERBI_MAX_N):
        raise ValueError(f"unigram_viterbi kernel takes 1 <= L <= "
                         f"{VITERBI_MAX_L} and N <= {VITERBI_MAX_N}; got N={N} "
                         f"L={L}")
    dev = m_key.device
    # one allocation for the four outputs: the launch's host time is most
    # of a short launch's time
    buf = m_key.new_empty(3 * B * N + B)
    out_ids, out_starts, out_ends = buf[: 3 * B * N].view(3, B, N)
    counts = buf[3 * B * N :]
    if B == 0 or N == 0:
        return out_ids, out_starts, out_ends, counts
    kernels.launch(
        "unigram_viterbi", dev,
        m_key.data_ptr(), m_score.data_ptr(), lengths.data_ptr(),
        tables.ids_tab.data_ptr(), tables.ids_tab.numel(), B, N, L,
        int(unk_id), tables.id_offset,
        out_ids.data_ptr(), out_starts.data_ptr(), out_ends.data_ptr(),
        counts.data_ptr(),
    )
    return out_ids, out_starts, out_ends, counts


def unigram_segment(
    tables: UnigramDeviceTables,
    x_iw: torch.Tensor,  # int32 (B, N), -1 = no transition
    lengths: torch.Tensor,  # int32 (B,)
    unk_id: int,
    lw: int | None = None,
):
    """Walk then Viterbi: (ids, starts, ends, counts) padded to N tokens per
    row.  ``lw`` caps the walk and the DP ring; exact when no arc can exceed
    lw symbols (unit-length-classed packed rows, runtime/dedup.py)."""
    m_key, m_score = unigram_walk(tables, x_iw, lengths, lw=lw)
    return unigram_viterbi(tables, m_key, m_score, lengths, unk_id)
