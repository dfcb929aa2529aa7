"""Data-parallel corpus tokenization over torch.distributed: port of
blingfire_tpu/parallel/mesh.py (ShardedStats, ShardedSpRunner.run and
run_units, ShardedWpRunner.run_rows, the ShardedBpeRunner alias), with
K12 ``shard_stats`` for each rank's statistics.

The JAX package shards one batch over a device mesh from a single
controller: tables are replicated, rows split over the mesh axis "dp" in
contiguous blocks (``P("dp")``), and the token total and a position-weighted
int32 checksum are reduced across devices.  The port runs one process per
card, the PyTorch idiom: ``torchrun --nproc-per-node=<cards>`` (or the
caller's own processes), rank r on ``cuda:$LOCAL_RANK`` over NCCL, or CPU
processes over gloo.  Every rank is given the whole batch and keeps the
single-controller semantics: rank r takes the block of rows
``[r*Rp/n, (r+1)*Rp/n)`` that device r holds under ``P("dp")``, runs it,
and the ranks all-reduce one int64 ``[total, checksum]``; the checksum is
taken mod 2^32 on the host, which is the JAX package's int32 wrap-around
whatever the order of the partial sums (a gloo or NCCL sum of int32 is not
specified to wrap).  Totals and checksums therefore equal the JAX runner's
on any world size.  ``init_group`` takes the place of
``data_parallel_mesh``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import kernels, native
from ..ops import bpe as bpe_ops
from ..runtime import dedup

KNUTH = -1640531527  # the checksum's multiplier (mesh.py:101), 0x9E3779B9


def init_group(device: str | torch.device = "cuda", init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None):
    """The data-parallel process group for tokenizers on ``device``: NCCL
    for a CUDA device, gloo for the CPU.  Starts torch.distributed when it
    is not started (rank and world size from the arguments, else from
    torchrun's RANK and WORLD_SIZE; ``init_method`` defaults to env://),
    and for CUDA makes ``cuda:$LOCAL_RANK`` (else the rank) the current
    device.  Raises when a running group has the other backend."""
    dev = torch.device(device)
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", 1))
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank,
            world_size=world_size)
    group = dist.group.WORLD
    _check_backend(group, dev)
    return group


def spawn_ranks(fn, args: tuple, world: int, timeout: float) -> None:
    """Runs ``fn(rank, *args)`` in ``world`` spawned processes and waits
    for them.  Raises if a rank fails, or kills every rank and raises when
    they have not ended within ``timeout`` seconds (a rank that dies leaves
    the others blocked in a collective)."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _check_backend(group, device: torch.device) -> None:
    want = "nccl" if device.type == "cuda" else "gloo"
    got = dist.get_backend(group)
    if got != want:
        raise ValueError(f"a tokenizer on {device} needs a {want} group, "
                         f"got {got}")


@dataclass
class ShardedStats:
    total_tokens: int
    total_docs: int
    # sum over rows and t < count of id * (t * -1640531527 + 1), int32
    # wrap-around: order-sensitive within a row, the same on any sharding
    checksum: int


# ------------------------------------------------------------ K12 shard_stats


def _shard_stats_plain(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """int64 [total, checksum mod 2^32] of rows ``ids`` (R, W) and their
    ``counts`` (mesh.py:97-103 in int64, masked to 32 bits)."""
    W = ids.shape[1]
    pos = torch.arange(W, dtype=torch.int64, device=ids.device)[None, :]
    c = counts.to(torch.int64)
    weight = (pos * KNUTH + 1) & 0xFFFFFFFF
    prod = (ids.to(torch.int64) * weight) & 0xFFFFFFFF
    chk = torch.where(pos < c[:, None], prod, 0).sum() & 0xFFFFFFFF
    return torch.stack([c.sum(), chk])


def shard_stats(ids: torch.Tensor, counts: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
    """Adds the token total and the checksum partial of rows ``ids`` int32
    (R, W), whose rows may be strided (lanes contiguous), and their
    ``counts`` int32 (R,) (any stride) into ``acc``, int64 [total,
    checksum partials]; :func:`finish_stats` reads it.  K12
    (kernels/csrc/shard_stats.cu) on CUDA tensors; the plain version on CPU
    tensors."""
    if not kernels.on_card(ids):
        acc += _shard_stats_plain(ids, counts)
        return acc
    R, W = ids.shape
    if (ids.dtype != torch.int32 or counts.dtype != torch.int32
            or counts.shape != (R,) or (R > 1 and ids.stride(1) != 1)
            or acc.dtype != torch.int64 or acc.shape != (2,)
            or not acc.is_contiguous()):
        raise ValueError(f"shard_stats: want int32 rows (R, W) with "
                         f"contiguous lanes, int32 counts (R,), int64 acc "
                         f"(2,); got {ids.dtype} {tuple(ids.shape)} stride "
                         f"{ids.stride()}, {counts.dtype} "
                         f"{tuple(counts.shape)}, {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if R:
        kernels.launch("shard_stats", ids.device, ids.data_ptr(),
                       ids.stride(0), counts.data_ptr(), counts.stride(0), R,
                       W, acc.data_ptr())
    return acc


def finish_stats(acc: torch.Tensor) -> tuple[int, int]:
    """(total, checksum as the JAX package's int32) of an ``acc``."""
    total, chk = (int(v) for v in acc.cpu())
    chk &= 0xFFFFFFFF
    return total, chk - (1 << 32) if chk >= 1 << 31 else chk


# ------------------------------------------------------------------ runners


class _Sharded:
    def __init__(self, device: torch.device, group):
        self.group = group if group is not None else dist.group.WORLD
        _check_backend(self.group, device)
        self.device = device
        self.n_dp = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def _block(self, n: int) -> tuple[int, int]:
        """This rank's rows of ``n`` (a multiple of the world size)."""
        per = n // self.n_dp
        return self.rank * per, (self.rank + 1) * per

    def _reduce(self, acc: torch.Tensor) -> tuple[int, int]:
        dist.all_reduce(acc, group=self.group)
        return finish_stats(acc)

    def _gather(self, rows: torch.Tensor) -> np.ndarray:
        """Every rank's rows, in rank order, on the host."""
        parts = [torch.empty_like(rows) for _ in range(self.n_dp)]
        dist.all_gather(parts, rows, group=self.group)
        return torch.cat(parts).cpu().numpy()


class ShardedSpRunner(_Sharded):
    """The [pos-dict] (BPE or unigram) device pass, data-parallel, with
    all-reduced statistics.  Two input modes, as mesh.py:
    :meth:`run`, the classic doc rows (one document a row), and
    :meth:`run_units`, the native unique-unit rows."""

    def __init__(self, tokenizer, group=None):
        from ..runtime.host import SpTokenizer

        if not isinstance(tokenizer, SpTokenizer):
            raise TypeError("ShardedSpRunner takes an SpTokenizer")
        self.tok = tokenizer
        super().__init__(tokenizer.device, group)

    def run(self, docs: list[bytes], unk_id: int = 0):
        """The batch padded with b"" to a multiple of the world size; this
        rank preps its block of documents and runs it as classic doc rows
        (``SpTokenizer._segment`` on its width groups, full walk depth, no
        chunking: a document past the window is an empty row, as in
        mesh.py:131-139).  Returns (ids int32 (b, n_doc), counts int32 (b,),
        fallback bool (b,), the block's first row, ShardedStats of the
        whole batch)."""
        tok = self.tok
        if tok.is_bpe and tok.n_doc > bpe_ops.RESOLVE_MAX_N:
            raise ValueError(f"run takes doc rows of at most "
                             f"{bpe_ops.RESOLVE_MAX_N} symbols (K2); this "
                             f"tokenizer's window is {tok.n_doc}")
        B = len(docs)
        docs = list(docs) + [b""] * ((-B) % self.n_dp)
        lo, hi = self._block(len(docs))
        x, lengths, _status = tok._prep_batch(docs[lo:hi])
        dev = self.device
        b = hi - lo
        ids = torch.zeros((b, tok.n_doc), dtype=torch.int32, device=dev)
        counts = torch.zeros(b, dtype=torch.int32, device=dev)
        fb = torch.zeros(b, dtype=torch.bool, device=dev)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        rows = np.flatnonzero(lengths > 0)
        for w, idx in tok._row_groups(lengths[rows]):
            sel = rows[idx]
            xd = torch.from_numpy(np.ascontiguousarray(x[sel, :w])).to(dev)
            ld = torch.from_numpy(lengths[sel]).to(dev)
            g_ids, g_counts, g_fb = tok._segment(xd, ld, unk_id)
            shard_stats(g_ids, g_counts, acc)
            st = torch.from_numpy(sel).to(dev)
            ids[st, :w] = g_ids
            counts[st] = g_counts
            fb[st] = g_fb
        total, chk = self._reduce(acc)
        return ids, counts, fb, lo, ShardedStats(total, B, chk)

    def run_units(self, docs: list[bytes], unk_id: int = 0, cache=None):
        """The native unit rows of the batch (every rank packs the same
        rows), padded to a multiple of the world size; this rank runs its
        block at full walk depth (one pass, as mesh.py:171-176's slab, not
        the three regions of ``dispatch_docs``), packs it with K4, and the
        ranks all-gather the packed rows; every rank stitches the whole
        batch.  Returns (ids, bounds, need, status, ShardedStats) as
        mesh.py:158-183, save that K2 marks the tokens over a capped walk,
        as in ``dispatch_docs``: ``need`` holds the documents of the
        overflowing units, not of their whole rows."""
        tok = self.tok
        runner = tok._unit_runner()
        if not (runner.compact_ok and 0 <= unk_id < (1 << 20)):
            raise ValueError("run_units needs ids, unk_id and the window to "
                             "fit the compact lanes (compact_ok)")
        N = tok.n_doc
        nu = native.units_analyze(
            docs, N, tok._sym2iw, runner.spm_iw, tok.seg.use_raw_bytes,
            tok.seg.no_dummy_prefix, tok.seg.charmap, cache=cache)
        R = max(nu.n_rows, 1)
        Rp = -(-R // self.n_dp) * self.n_dp
        lo, hi = self._block(Rp)
        bx = np.full((hi - lo, N), -1, np.int32)
        bl = np.zeros(hi - lo, np.int32)
        real = max(0, min(hi, nu.n_rows) - lo)
        bx[:real] = nu.px[lo : lo + real]
        bl[:real] = nu.plen[lo : lo + real]
        dev = self.device
        xd, ld = torch.from_numpy(bx).to(dev), torch.from_numpy(bl).to(dev)
        out = torch.empty((hi - lo, N + 2), dtype=torch.int32, device=dev)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        step = dedup.launch_rows(tok, N, None)
        for a in range(0, hi - lo, step):
            z = min(a + step, hi - lo)
            ids, st, counts, fb = runner._kernel(xd[a:z], ld[a:z], unk_id,
                                                 mark=True)
            shard_stats(ids, counts, acc)
            dedup.pack_out_compact(ids, st, counts, fb, out=out[a:z])
        packed = self._gather(out)
        total, chk = self._reduce(acc)
        ids, bounds, need = nu.stitch(
            np.ascontiguousarray(packed[: nu.n_rows]), dedup.ID_SHIFT)
        return ids, bounds, need, nu.status, ShardedStats(total, len(docs), chk)


class ShardedWpRunner(_Sharded):
    """The WordPiece hybrid's device stage (the dense sub-token pass, K7)
    data-parallel over one packed row slab; host stages are
    WordPieceHybrid's."""

    def __init__(self, wp, group=None):
        from ..runtime.wp_hybrid import WordPieceHybrid

        if not isinstance(wp, WordPieceHybrid):
            raise TypeError("ShardedWpRunner takes a WordPieceHybrid")
        if not (wp.available() and wp._dense is not None):
            raise ValueError("ShardedWpRunner needs a pack-safe model with "
                             "the dense sub-grammar")
        self.wp = wp
        super().__init__(wp.device, group)

    def run_rows(self, bx: np.ndarray, bi: np.ndarray, lw: int):
        """One packed slab (symbols ``bx`` and initial states ``bi``, int32
        (R, W)), padded with -1 to a multiple of the world size; this rank
        runs its block and the ranks all-gather the output rows.  Returns
        (rows_out int32 (R, W + 2), total, checksum) as mesh.py:239-249."""
        R = bx.shape[0]
        Rp = -(-max(R, 1) // self.n_dp) * self.n_dp
        if Rp != R:
            bx = np.pad(bx, ((0, Rp - R), (0, 0)), constant_values=-1)
            bi = np.pad(bi, ((0, Rp - R), (0, 0)), constant_values=-1)
        lo, hi = self._block(Rp)
        dev = self.device
        out = self.wp._device_pass(
            torch.from_numpy(np.ascontiguousarray(bx[lo:hi])).to(dev),
            torch.from_numpy(np.ascontiguousarray(bi[lo:hi])).to(dev), lw)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        shard_stats(out[:, :-2], out[:, -2], acc)
        rows = self._gather(out)
        total, chk = self._reduce(acc)
        return rows[:R], total, chk


# the JAX package's earlier name (mesh.py:253)
ShardedBpeRunner = ShardedSpRunner
