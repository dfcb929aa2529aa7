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
``_hyph_segment_plain`` is its plain PyTorch version, which the wrapper runs
only for tensors on the CPU.  The comb lookup takes no transition when
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

    def dev(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dtype)

    return HyphDeviceTables(
        base=dev(table.base),
        owner=dev(table.owner),
        nxt=dev(table.nxt),
        final=dev(table.final, torch.bool),
        moore_ow=dev(moore_ow),
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
            tables.base.data_ptr(), tables.owner.data_ptr(),
            tables.nxt.data_ptr(), tables.final.data_ptr(),
            tables.moore_ow.data_ptr(), tables.base.numel(), tables.n_slots,
            tables.pat_vals.data_ptr(), tables.pat_len.data_ptr(),
            tables.pat_len.numel(), tables.max_pat, tables.min_pat_len,
            tables.no_hyph_len, x_iw.data_ptr(), word_len.data_ptr(), B, M,
            out.data_ptr(),
        )
    return out
