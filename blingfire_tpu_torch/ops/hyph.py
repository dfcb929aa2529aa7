"""W2H hyphenation on the card: port of blingfire_tpu/ops/hyph.py.

Reference: FAHyphInterpreter_core_t.h:136-267.  Every start position of an
anchored word walks the patterns' Moore DFA; each final applies its
pattern's per-position ops with the first-wins/conflict rule; the word's
edges are then suppressed.  The rule is order-free: a position is CONFLICT
iff two distinct non-DONT_CARE ops cover it, so each position keeps the
least and the greatest op applied to it (UNKNOWN where none was, the op
where they are equal, CONFLICT otherwise), as the JAX package's
scatter-min/scatter-max does.

``hyph_segment`` (K10, ``kernels/csrc/hyph_segment.cu``) runs on the card;
``hyph_segment_packed`` launches it once over the rows of several widths
that ``pack_rows`` put in one buffer (every bucket of a
``HyphTpu.process_batch`` call).  ``_hyph_segment_plain`` is its plain
PyTorch version, which the wrappers run only for tensors on the CPU.  The comb lookup takes no transition when
``base[s] + c`` falls outside the slot array (``ops/lexer.py::comb_lookup``);
the JAX package clamps the slot (hyph.py:96) and so, from the state that
owns slot 0, takes a transition that the automaton does not have
(ROADMAP.md section C).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..formats.consts import Param
from .lexer import comb_lookup
from .tables import CombTable

HYPH_CONFLICT = -2
HYPH_UNKNOWN = -1
HYPH_NO_HYPH = 0
HYPH_DONT_CARE = 7  # FAFsmConst.h:345-357
BIG = 2**30  # the empty value of the min and max grids
MAX_WORD_SIZE = 300  # FAHyphInterpreter_core_t.h's limit; longer words get None
# K10 holds a row (the word and its anchors) and its two grids in shared memory
MAX_HYPH_ROW = MAX_WORD_SIZE + 2


@dataclass(frozen=True)
class HyphDeviceTables:
    """Comb tables and pattern ops of a [w2h] model on one device."""

    base: torch.Tensor  # int32[n_states]
    owner: torch.Tensor  # int32[slots]
    nxt: torch.Tensor  # int32[slots]
    final: torch.Tensor  # bool[n_states]
    moore_ow: torch.Tensor  # int32[n_states] pattern id of a final
    # K10's packed records (ops/lexer.py's layout): a step reads one slot
    # record and the next state's record
    state_rec: torch.Tensor  # int32 (n_states, 4): base, final, Moore Ow, 0
    slot_rec: torch.Tensor  # int32 (slots, 2): owner, nxt
    pat_vals: torch.Tensor  # int32 (n_pats, max_pat), DONT_CARE padded
    pat_len: torch.Tensor  # int32 (n_pats,)
    n_slots: int
    max_pat: int
    min_pat_len: int
    no_hyph_len: int


def make_device_tables(table: CombTable, moore_ow, i2info: dict, params,
                       device: str | torch.device = "cuda"
                       ) -> HyphDeviceTables:
    """Port of blingfire_tpu/ops/hyph.py::make_device_tables (hyph.py:43-64)."""
    n_pats = max(i2info.keys()) + 1 if i2info else 0
    max_pat = max((len(v) for v in i2info.values()), default=1)
    pat_vals = np.full((n_pats, max_pat), HYPH_DONT_CARE, np.int32)
    pat_len = np.zeros(n_pats, np.int32)
    for k, v in i2info.items():
        pat_vals[k, : len(v)] = v
        pat_len[k] = len(v)

    state_rec = np.zeros((len(table.base), 4), np.int32)
    state_rec[:, 0] = table.base
    state_rec[:, 1] = np.asarray(table.final, bool)
    state_rec[:, 2] = moore_ow
    slot_rec = np.stack([np.asarray(table.owner, np.int32),
                         np.asarray(table.nxt, np.int32)], axis=1)

    def dev(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    return HyphDeviceTables(
        base=dev(table.base),
        owner=dev(table.owner),
        nxt=dev(table.nxt),
        final=dev(table.final, torch.bool),
        moore_ow=dev(moore_ow),
        state_rec=dev(state_rec),
        slot_rec=dev(slot_rec),
        pat_vals=dev(pat_vals),
        pat_len=dev(pat_len),
        n_slots=table.n_slots,
        max_pat=max_pat,
        min_pat_len=params.get(Param.MIN_LEN, 3),
        no_hyph_len=params.get(Param.MIN_LEN2, 0),
    )


def _hyph_segment_plain(tables: HyphDeviceTables, x_iw: torch.Tensor,
                        word_len: torch.Tensor, reads=None) -> torch.Tensor:
    """The ops (B, M - 2) of hyph.py::hyph_segment (hyph.py:67-143).

    x_iw: int32 (B, M) rows ``[L_ANCHOR, chars..., R_ANCHOR, -1 ...]`` of
    dense input weights; word_len: int32 (B,) characters without anchors.
    Starts ``From < n + 2 - (min_pat_len - 1)`` walk from state 0 in
    lockstep until every lane is dead; a final applies its pattern's ops
    ``j`` in ``[js, je)`` to position ``From + j - 1``, with ``js = 1`` only
    at From 0 (the L anchor's op) and ``je = plen - max(0, From + plen - n)``,
    DONT_CARE skipped.  The pattern gathers clamp the id, as XLA does
    (hyph.py:101, :109).  ``reads`` (a ``kernels.Reads``) notes the table
    entries the walk reads."""
    B, M = x_iw.shape
    W = M - 2
    dev = x_iw.device
    i32 = torch.int32
    pos = torch.arange(M, dtype=i32, device=dev)
    wl = word_len.to(i32)[:, None]
    xp = torch.cat([x_iw, torch.full((B, M + 1), -1, dtype=i32, device=dev)],
                   dim=1)
    n_states = tables.base.numel()
    n_pats = tables.pat_len.numel()
    P = tables.max_pat
    j = torch.arange(P, dtype=i32, device=dev)
    oi = pos[:, None] + j[None, :] - 1  # (M, P) output index of op j
    js = (pos == 0).to(i32)[:, None]  # the L-anchor start skips op 0
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    # grids with one spare cell that takes the ops not applied
    vmin = torch.full((B * W + 1,), BIG, dtype=i32, device=dev)
    vmax = torch.full((B * W + 1,), -BIG, dtype=i32, device=dev)
    start_ok = pos[None, :] < (wl + 2 - (tables.min_pat_len - 1)).clamp(min=0)
    state = torch.where(start_ok, 0, -1).to(i32)
    for d in range(M):
        if not bool((state >= 0).any()):
            break
        c = xp[:, d : d + M]
        if reads is not None:
            reads.step((state >= 0) & (c >= 0))
        ns = comb_lookup(tables, state, c, reads)[0]
        ns_safe = ns.clamp(0, n_states - 1).long()
        fin = (ns >= 0) & tables.final[ns_safe]
        pid = torch.where(fin, tables.moore_ow[ns_safe], 0)
        pid_safe = pid.clamp(0, n_pats - 1).long()
        plen = tables.pat_len[pid_safe]
        if reads is not None:
            reads.note("final", tables.final, ns_safe, ns >= 0)
            reads.note("moore_ow", tables.moore_ow, ns_safe, fin)
            reads.note("pat_len", tables.pat_len, pid_safe, fin)
        je = plen - (pos[None, :] + plen - wl).clamp(min=0)
        vals = tables.pat_vals[pid_safe]  # (B, M, P)
        ok = (fin[..., None] & (j >= js) & (j < je[..., None])
              & (vals != HYPH_DONT_CARE) & (oi >= 0) & (oi < W))
        if reads is not None:
            reads.note("pat_vals", tables.pat_vals, pid_safe[..., None] * P + j,
                       fin[..., None] & (j < plen[..., None]))
        flat = torch.where(ok, rows * W + oi, B * W).reshape(-1)
        v = vals.reshape(-1)
        vmin.scatter_reduce_(0, flat, v, reduce="amin")
        vmax.scatter_reduce_(0, flat, v, reduce="amax")
        state = ns
    vmin = vmin[: B * W].reshape(B, W)
    vmax = vmax[: B * W].reshape(B, W)
    out = torch.where(vmin == BIG, HYPH_UNKNOWN,
                      torch.where(vmin == vmax, vmin, HYPH_CONFLICT)).to(i32)
    # edge suppression (FAHyphInterpreter:252-263)
    wpos = torch.arange(W, dtype=i32, device=dev)[None, :]
    k = wl.clamp(max=tables.no_hyph_len)
    lead = wpos < k
    tail = (wpos >= wl - 1 - k) & (wpos < wl - 1) & (wpos > 0)
    return torch.where(lead | tail, HYPH_NO_HYPH, out).to(i32)


def hyph_segment(tables: HyphDeviceTables, x_iw: torch.Tensor,
                 word_len: torch.Tensor) -> torch.Tensor:
    """Per-position hyphenation ops (B, M - 2) int32 of a batch of anchored
    words (K10): the contract of :func:`_hyph_segment_plain`.  Replaces
    blingfire_tpu/ops/hyph.py::hyph_segment."""
    if not kernels.on_card(x_iw):
        return _hyph_segment_plain(tables, x_iw, word_len)
    B, M = x_iw.shape
    if not 2 <= M <= MAX_HYPH_ROW:
        raise ValueError(f"rows of 2..{MAX_HYPH_ROW} lanes only, got {M}")
    kernels.check(x_iw, torch.int32, (B, M), "x_iw")
    kernels.check(word_len, torch.int32, (B,), "word_len")
    out = torch.empty((B, M - 2), dtype=torch.int32, device=x_iw.device)
    if B:
        kernels.launch(
            "hyph_segment", x_iw.device,
            tables.state_rec.data_ptr(), tables.slot_rec.data_ptr(),
            tables.base.numel(), tables.n_slots,
            tables.pat_vals.data_ptr(), tables.pat_len.data_ptr(),
            tables.pat_len.numel(), tables.max_pat, tables.min_pat_len,
            tables.no_hyph_len, x_iw.data_ptr(), word_len.data_ptr(), B, M,
            out.data_ptr(),
        )
    return out


# ------------------------------------------------- one launch, many widths

TILE_THREADS = 256  # K10's block; a tile is tile_rows(M) rows of one width
SEG_INTS = 8  # int32 words of a segment record


def tile_rows(M: int) -> int:
    """Rows of width M in one of K10's tiles."""
    return max(1, TILE_THREADS // M)


@dataclass(frozen=True)
class Packed:
    """Where :func:`pack_rows` put each segment (rows of one width): the
    buffer holds the segment records, then every segment's rows, then
    every row's word length; the ops of segment s are ``out[out_offs[s] :
    out_offs[s] + rows[s] * (widths[s] - 2)]``."""

    rows: tuple[int, ...]
    widths: tuple[int, ...]  # M of each segment
    out_offs: tuple[int, ...]
    n_tiles: int
    buf_len: int
    out_len: int

    def split(self, out: torch.Tensor) -> list[torch.Tensor]:
        """The (rows, M - 2) ops of each segment, views of ``out`` (a
        tensor or an array)."""
        return [out[o : o + b * (m - 2)].reshape(b, m - 2)
                for b, m, o in zip(self.rows, self.widths, self.out_offs)]


def pack_rows(segs) -> tuple[np.ndarray, Packed]:
    """One int32 buffer of the segments ``segs``, [(x int32 (B, M), word_len
    int32 (B,))], for :func:`hyph_segment_packed`: a record of SEG_INTS ints
    a segment {first tile, rows, M, tile rows, rows' offset, word lengths'
    offset, ops' offset, 0} (offsets in int32 elements of the buffer and of
    the output), then the rows back to back, then the word lengths."""
    n = len(segs)
    if not n:
        raise ValueError("no segment to pack")
    shapes = [tuple(np.shape(x)) for x, _wl in segs]
    for (B, M), (_x, wl) in zip(shapes, segs):
        if not 2 <= M <= MAX_HYPH_ROW or np.shape(wl) != (B,):
            raise ValueError(f"a segment of rows (B, 2..{MAX_HYPH_ROW}) and "
                             f"word lengths (B,), got {(B, M)} and "
                             f"{np.shape(wl)}")
    rows = [B for B, _M in shapes]
    widths = [M for _B, M in shapes]
    tiles = [-(-B // tile_rows(M)) for B, M in shapes]
    x_offs = np.cumsum([n * SEG_INTS] + [B * M for B, M in shapes])
    wl_offs = x_offs[-1] + np.cumsum([0] + rows)
    out_offs = np.cumsum([0] + [B * (M - 2) for B, M in shapes])
    buf_len = int(wl_offs[-1])
    if max(buf_len, int(out_offs[-1])) >= 2**31:
        raise ValueError("a packed launch past 2^31 elements")
    buf = np.empty(buf_len, np.int32)
    rec = np.zeros((n, SEG_INTS), np.int64)
    rec[:, 0] = np.cumsum([0] + tiles[:-1])
    rec[:, 1] = rows
    rec[:, 2] = widths
    rec[:, 3] = [tile_rows(M) for M in widths]
    rec[:, 4] = x_offs[:-1]
    rec[:, 5] = wl_offs[:-1]
    rec[:, 6] = out_offs[:-1]
    buf[: n * SEG_INTS] = rec.reshape(-1)
    for s, (x, wl) in enumerate(segs):
        buf[x_offs[s] : x_offs[s + 1]] = np.asarray(x, np.int32).reshape(-1)
        buf[wl_offs[s] : wl_offs[s + 1]] = wl
    return buf, Packed(tuple(rows), tuple(widths),
                       tuple(int(o) for o in out_offs[:-1]), sum(tiles),
                       buf_len, int(out_offs[-1]))


def hyph_segment_packed(tables: HyphDeviceTables, buf: torch.Tensor,
                        packed: Packed) -> torch.Tensor:
    """The ops of every segment of ``buf`` (:func:`pack_rows`, on the
    device) in one int32 tensor (``packed.out_len``,); ``packed.split``
    cuts it by segment.  K10 in one launch on a CUDA buffer; on a CPU
    buffer the plain version segment by segment, reading the records."""
    if buf.dtype != torch.int32 or tuple(buf.shape) != (packed.buf_len,) \
            or not buf.is_contiguous():
        raise ValueError(f"buf: want contiguous int32 ({packed.buf_len},), "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    n = len(packed.rows)
    out = torch.empty(packed.out_len, dtype=torch.int32, device=buf.device)
    if not kernels.on_card(buf):
        rec = buf[: n * SEG_INTS].view(n, SEG_INTS).tolist()
        for _tile, B, M, _T, xo, wo, oo, _z in rec:
            out[oo : oo + B * (M - 2)] = _hyph_segment_plain(
                tables, buf[xo : xo + B * M].view(B, M),
                buf[wo : wo + B]).reshape(-1)
        return out
    if packed.n_tiles:
        kernels.launch(
            "hyph_segment_packed", buf.device,
            tables.state_rec.data_ptr(), tables.slot_rec.data_ptr(),
            tables.base.numel(), tables.n_slots,
            tables.pat_vals.data_ptr(), tables.pat_len.data_ptr(),
            tables.pat_len.numel(), tables.max_pat, tables.min_pat_len,
            tables.no_hyph_len, buf.data_ptr(), n, packed.n_tiles,
            out.data_ptr(),
        )
    return out
