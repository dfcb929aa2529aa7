"""Corpus tokenization entry point: port of blingfire_tpu/runtime/host.py
(the host prep: _ws_table, _is_ws, decode_utf8, PreparedDoc,
prepare_sp_doc; SpTokenizer: __init__, _compute_chunk_safe, _native_units_ok,
_prep_batch, _classic_rows, _split_chunks, _encode_overflow, the NumPy unit
path of encode_batch and encode_corpus,
_native_fallback_handle, _fallback_ids, _patch_fallbacks, encode_corpus_flat,
encode_batch, encode_corpus; _batches_by_bytes and _max_token_len), with
the batch pipeline and the splice
of fallback documents that it shares with runtime/wp_hybrid.py
(``run_pipeline``, ``splice_docs``).

Three routes, as the JAX package's (host.py:540-551, :605-630, :706,
:789-791):

- a chunk-safe model whose window and ids fit the compact lanes
  (``UnitRunner.compact_ok``: ``max_doc_symbols`` at most 1,024, ids within
  21 bits) takes the native unique-unit device path (runtime/dedup.py);
- any other chunk-safe model takes the NumPy unit path (``UnitRunner.dispatch``
  and ``collect``, with K11 ``pack_out``), and the documents it marks take the
  classic doc rows;
- a model that is not chunk-safe takes the classic doc rows: native prep of
  each batch, one walk and resolve (BPE) or walk and Viterbi (unigram) over
  the rows.

Every device row is at most ``row_max`` symbols wide: the window, but for a
BPE model no more than K2's ``RESOLVE_MAX_N`` = 1,024, and each resolve gets
at most ``RESOLVE_MAX_ARCS`` = 4,096 arcs (a row with more is flagged).  A
document longer than ``row_max`` (past the window, or a BPE document past
1,024 symbols in a wider window) is split at ▁ into chunk rows (for a model
that is not chunk-safe, only at a ▁ that no vocabulary match crosses), which
gives the same ids.  Documents the device flags, and documents that no split
fits, go to the native runtime's TextToIds; its ids are reference-exact, as
the scalar oracle's are.  On the native unit path the device flags the unit,
not the row: K2 marks the token over a walk cut at its depth cap, and only
the documents that hold that unit (or a unit of a row flagged whole: too
many arcs, an anomaly) take the fallback.  The classic rows and the NumPy
unit path flag whole rows.  The JAX package's fixed batch shapes, its b""
padding and its power-of-two row counts exist for XLA's compile cache and
are not ported; the rows of a batch go to the device grouped by width
(128, 256, ... up to ``row_max``), which gives the same ids.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..formats.consts import SP_DELIMITER, TokAlgo
from ..models.loader import Model, SegmenterModel
from ..ops import bpe as bpe_ops
from ..ops import unigram as uni_ops
from ..ops.tables import build_comb_table_cached, build_trie_table_cached
from . import metrics
from .oracle import SpTokenizerOracle

MIN_ROW_WIDTH = 128  # narrowest row width of the classic pass
_WS_SMALL = None


def _ws_table() -> np.ndarray:
    """Dense whitespace-class table up to 0xFEFF (blingfiretokdll.h:16-21)."""
    global _WS_SMALL
    if _WS_SMALL is None:
        t = np.zeros(0xFF00, bool)
        t[: 0x21] = True
        t[0xA0] = True
        t[0x2000:0x2010] = True
        t[0x202F] = True
        t[0x205F] = True
        t[0x2060] = True
        t[0x2420] = True
        t[0x2424] = True
        t[0x3000] = True
        t[0xFEFF] = True
        _WS_SMALL = t
    return _WS_SMALL


def _is_ws(sym: np.ndarray) -> np.ndarray:
    t = _ws_table()
    small = sym < len(t)
    return np.where(small, t[np.minimum(sym, len(t) - 1)], False)


def decode_utf8(data: bytes) -> tuple[np.ndarray, np.ndarray] | None:
    """Strict UTF-8 -> (code points, byte offsets), or None when invalid:
    the vectorized FAStrUtf8ToArray (FAUtf8Utils.cpp:199-288)."""
    if data[:3] == b"\xef\xbb\xbf":
        data = data[3:]
        base = 3
    else:
        base = 0
    b = np.frombuffer(data, np.uint8)
    n = len(b)
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    is_lead1 = b < 0x80
    is_lead2 = (b & 0xE0) == 0xC0
    is_lead3 = (b & 0xF0) == 0xE0
    is_lead4 = (b & 0xF8) == 0xF0
    is_cont = (b & 0xC0) == 0x80
    lead = is_lead1 | is_lead2 | is_lead3 | is_lead4
    if not (lead | is_cont).all():
        return None
    sizes = np.where(is_lead1, 1, np.where(is_lead2, 2, np.where(is_lead3, 3, 4)))
    starts = np.flatnonzero(lead)
    if len(starts) == 0 or starts[0] != 0:
        return None
    sz = sizes[starts]
    if (starts + sz != np.append(starts[1:], n)).any():
        return None
    b32 = b.astype(np.int32)
    cp = np.where(
        is_lead1[starts],
        b32[starts],
        np.where(
            is_lead2[starts],
            b32[starts] & 0x1F,
            np.where(is_lead3[starts], b32[starts] & 0x0F, b32[starts] & 0x07),
        ),
    )
    for k in (1, 2, 3):
        sel = sz > k
        idx = np.minimum(starts + k, n - 1)
        cp = np.where(sel, (cp << 6) | (b32[idx] & 0x3F), cp)
    # shortest form + surrogate checks
    minv = np.array([0, 0, 0x80, 0x800, 0x10000], np.int32)
    if (cp < minv[sz]).any() or (cp > 0x10FFFF).any():
        return None
    if ((cp & np.int32(-2048)) == 0xD800).any():  # surrogate range mask 0xFFFFF800
        return None
    return cp, (starts + base).astype(np.int32)


@dataclass
class PreparedDoc:
    syms: np.ndarray  # int32 squeezed raw symbols
    offs: np.ndarray  # int32 original byte offset per symbol (-1 = prefix)
    ok: bool  # False => invalid input (API returns 0 tokens)


def prepare_sp_doc(data: bytes, model: SegmenterModel) -> PreparedDoc:
    """decode -> dummy prefix -> charmap normalize -> whitespace squeeze
    (blingfiretokdll.cpp:1349-1535), in NumPy; native.prep_sp_batch is the
    same over a batch."""
    empty = PreparedDoc(np.empty(0, np.int32), np.empty(0, np.int32), False)
    if len(data) == 0:
        return empty
    if model.use_raw_bytes:
        base = 3 if data[:3] == b"\xef\xbb\xbf" else 0
        syms = np.frombuffer(data, np.uint8)[base:].astype(np.int32)
        offs = np.arange(base, len(data), dtype=np.int32)
    else:
        dec = decode_utf8(data)
        if dec is None:
            return empty
        syms, offs = dec
    if len(syms) == 0 or len(syms) > len(data):
        return empty
    if not model.no_dummy_prefix:
        syms = np.concatenate([np.array([SP_DELIMITER], np.int32), syms])
        offs = np.concatenate([np.array([-1], np.int32), offs])

    if model.charmap is not None:
        cm = model.charmap
        in_range = (syms >= cm.min_key) & (syms <= cm.max_key)
        idx = np.where(in_range, syms - cm.min_key, 0)
        counts = np.where(in_range, cm.counts[idx], -1)
        # count > slot capacity => map Get fails => identity
        # (FAMultiMap_pack_fixed.cpp:86-88 -> FANormalize identity branch);
        # count == 0 or count > 10 => character dropped entirely
        # (FAUtils_cl.h:324-363: no branch emits)
        counts = np.where(counts > cm.values.shape[1], -1, counts)
        reps = np.where(
            counts == -1, 1, np.where((counts >= 1) & (counts <= 10), counts, 0)
        )
        total = int(reps.sum())
        out = np.empty(total, np.int32)
        out_off = np.repeat(offs, reps)
        pos = np.cumsum(reps) - reps
        ident = counts == -1
        out[pos[ident]] = syms[ident]
        multi = ~ident
        if multi.any():
            mpos = pos[multi]
            mvals = cm.values[idx[multi]]
            mreps = reps[multi]
            for j in range(int(mreps.max()) if len(mreps) else 0):
                sel = mreps > j
                out[mpos[sel] + j] = mvals[sel, j]
        syms, offs = out, out_off

    # whitespace squeeze (blingfiretokdll.cpp:1462-1496)
    ws = _is_ws(syms)
    prev_ws = np.concatenate([[False], ws[:-1]])
    prev_sym = np.concatenate([[np.int32(-1)], syms[:-1]])
    emit = ~ws | ((~prev_ws) & (prev_sym != SP_DELIMITER))
    if len(emit):
        emit[0] = True
    out = np.where(ws, SP_DELIMITER, syms)[emit]
    offs = offs[emit]
    if len(out) > 1 and out[-1] == SP_DELIMITER:
        out = out[:-1]
        offs = offs[:-1]
    return PreparedDoc(out.astype(np.int32), offs.astype(np.int32), True)


class SpTokenizer:
    """Batched tokenizer for [pos-dict] ("sentence piece") models on a GPU:
    byte/char BPE, BPE with merges, and unigram LM.

    ``device`` defaults to ``"cuda"``, where every device step is one of the
    port's kernels; ``device="cpu"`` runs their plain PyTorch versions."""

    def __init__(self, model: Model, max_doc_symbols: int = 512,
                 a_max: int | None = None, device: str | torch.device = "cuda"):
        assert model.seg is not None, "model has no [pos-dict] section"
        seg = model.seg
        self.model = model
        self.seg = seg
        self.device = torch.device(device)
        self.comb = build_comb_table_cached(seg.aut, model.source_key, "seg")
        self.max_token_len = _max_token_len(seg.aut)
        self.is_bpe = seg.tok_algo in (
            TokAlgo.BPE,
            TokAlgo.BPE_OPT,
            TokAlgo.BPE_OPT_WITH_MERGES,
        )
        if self.is_bpe:
            trie = build_trie_table_cached(
                self.comb, seg.i2info_ids, seg.i2info_scores, model.source_key
            )
            self.tables = bpe_ops.make_device_tables(
                self.comb,
                seg.i2info_ids,
                seg.i2info_scores,
                max_len=self.max_token_len,
                with_merges=seg.tok_algo == TokAlgo.BPE_OPT_WITH_MERGES,
                fast=seg.tok_algo in (TokAlgo.BPE_OPT, TokAlgo.BPE_OPT_WITH_MERGES),
                id_offset=seg.id_offset,
                trie=trie,
                device=self.device,
            )
        else:
            self.tables = uni_ops.make_device_tables(
                self.comb,
                seg.i2info_ids,
                seg.i2info_scores,
                max_len=self.max_token_len,
                id_offset=seg.id_offset,
                device=self.device,
            )
        self.n_doc = max_doc_symbols
        # arc budget: 4 arcs per position covers realistic text; rows
        # beyond it fall back (host.py:232-237)
        self.a_max = a_max or max_doc_symbols * 4
        # the widest device row: K2 resolves rows of at most RESOLVE_MAX_N
        # positions, K6 of at most VITERBI_MAX_N
        self.row_max = min(self.n_doc, bpe_ops.RESOLVE_MAX_N if self.is_bpe
                           else uni_ops.VITERBI_MAX_N)
        self._oracle = SpTokenizerOracle(seg)
        self._sym2iw = self.comb.sym2iw
        m = self._sym2iw
        spm_iw = int(m[SP_DELIMITER]) if SP_DELIMITER < len(m) else -1
        # the classic rows' ▁ weight; when the alphabet lacks ▁, a weight no
        # symbol has.  JAX marks raw ▁ there (x_iw -1), which enters its ids
        # only through a match that starts at a ▁ (bpe.py:384): none does.
        self._spm_iw = spm_iw if spm_iw >= 0 else self.comb.n_iws
        self._chunk_safe = self._compute_chunk_safe()
        self._splittable = self._spm_alone()
        self._units = None
        self._nfb = None

    def _unit_runner(self):
        if self._units is None:
            from .dedup import UnitRunner

            self._units = UnitRunner(self)
        return self._units

    def _spm_alone(self) -> bool:
        """The single piece "▁" is accepted, so no unknown run spans a ▁."""
        comb = self.comb
        m = comb.sym2iw
        if SP_DELIMITER >= len(m) or int(m[SP_DELIMITER]) < 0:
            return False
        slot = int(comb.base[0]) + int(m[SP_DELIMITER])
        if not (0 <= slot < comb.n_slots) or comb.owner[slot] != 0:
            return False
        dst = int(comb.nxt[slot])
        return dst >= 0 and bool(comb.final[dst])

    def _compute_chunk_safe(self) -> bool:
        """True when documents may be split at every ▁ without changing the
        result: (a) no vocabulary piece has an internal ▁, and (b) the single
        piece "▁" is accepted (host.py:286-310)."""
        if not self._spm_alone():
            return False
        comb = self.comb
        occ = np.flatnonzero(comb.owner >= 0)
        iw = occ - comb.base[comb.owner[occ]]
        # internal-▁ pieces: a split can cut an arc
        return not np.any((iw == self._spm_iw) & (comb.owner[occ] != 0))

    def _crossed(self, xx: np.ndarray) -> np.ndarray:
        """bool per position p of ``xx`` (dense input weights of documents
        back to back, each followed by -1): some vocabulary match starts
        before p and ends at or after it.  A walk of the guarded comb table
        from every position at once, dropping lanes as they die.

        A split at a ▁ that no match crosses leaves every arc, fast-forward
        skip and unknown run (▁ being a piece) on one side, so BPE's
        resolution and unigram's Viterbi factorize there as they do at every
        ▁ of a chunk-safe model."""
        comb = self.comb
        q = np.flatnonzero(xx >= 0)  # starts; xx ends in -1, so no walk leaves
        pos, state = q.copy(), np.zeros(len(q), np.int64)
        max_end = np.full(len(xx), -1, np.int64)
        for _ in range(self.max_token_len):
            c = xx[pos]
            slot = comb.base[state] + np.maximum(c, 0)
            sl = np.clip(slot, 0, comb.n_slots - 1)
            hit = ((c >= 0) & (slot >= 0) & (slot < comb.n_slots)
                   & (comb.owner[sl] == state))
            q, pos, state = q[hit], pos[hit], comb.nxt[sl[hit]]
            live = state >= 0
            q, pos, state = q[live], pos[live], state[live]
            fin = comb.final[state]
            max_end[q[fin]] = pos[fin]  # pos grows: the last match wins
            pos = pos + 1
            if not len(q):
                break
        reach = np.maximum.accumulate(max_end)  # furthest end of a start <= p
        crossed = np.zeros(len(xx), bool)
        crossed[1:] = reach[:-1] >= np.arange(1, len(xx))
        return crossed

    def _native_units_ok(self) -> bool:
        """True when the native unique-unit device path can serve this
        model; a chunk-safe model for which it is False takes the NumPy
        unit path."""
        return self._chunk_safe and self._unit_runner().compact_ok

    # ------------------------------------------------------ the fallback

    def _native_fallback_handle(self):
        """The native runtime's handle of this model (runtime.cpp SetModel on
        the model image: a model built in memory has no file to load) with
        the model's current no-dummy-prefix setting, or None when the
        runtime rejects the image (host.py:452-467)."""
        if self._nfb is None:
            try:
                self._nfb = native.set_model(self.model.ldb.image)
            except ValueError:
                self._nfb = 0
            else:
                native.get_runtime().SetNoDummyPrefix(
                    ctypes.c_void_p(self._nfb), bool(self.seg.no_dummy_prefix))
        return self._nfb or None

    def _fallback_native(self, d: bytes, unk_id: int, c=None) -> np.ndarray:
        """Host-path ids (int32) of one fallback document: the native
        TextToIds, or the scalar oracle where it gives no answer in [0, cap]
        (host.py:469-485; counted in ``c.oracle_docs``)."""
        h = self._native_fallback_handle()
        if h is not None:
            cap = len(d) + 16
            arr = np.empty(cap, np.int32)
            n = native.get_runtime().TextToIds(
                ctypes.c_void_p(h), d, len(d),
                arr.ctypes.data_as(ctypes.c_void_p), cap, unk_id)
            if 0 <= n <= cap:
                return arr[:n]
        if c is not None:
            c.oracle_docs += 1
        return np.asarray(self._oracle.text_to_ids(d, unk_id=unk_id), np.int32)

    def _fallback_ids(self, d: bytes, unk_id: int, c=None) -> list[int]:
        """Host-path ids of one fallback document (:meth:`_fallback_native`)."""
        return self._fallback_native(d, unk_id, c).tolist()

    def _fallback_batch(self, docs: list[bytes], unk_id: int, c
                        ) -> list[list[int]]:
        """Host-path ids of a batch's fallback documents, counted in
        ``c.fallback_docs`` and ``c.fallback_bytes``.  Each document's
        native call is timed alone, and their sum goes to the stage
        "fallback.native" once a batch: a profiler range a document would
        weigh on a traced run."""
        clock = time.perf_counter
        native_s = 0.0
        out = []
        for d in docs:
            t = clock()
            got = self._fallback_native(d, unk_id, c)
            native_s += clock() - t
            out.append(got.tolist())
        c.stage_seconds["fallback.native"] += native_s
        c.fallback_docs += len(docs)
        c.fallback_bytes += sum(map(len, docs))
        return out

    def _patch_fallbacks(self, chunk, ids, bounds, need, status, unk_id, c):
        """Replace the (rare) fallback docs' empty spans in a flat result:
        invalid -> 0 ids, rest -> the native runtime.  Returns updated (ids,
        bounds)."""
        repl: dict[int, list[int]] = {}
        patch = []
        for k in np.flatnonzero(need):
            k = int(k)
            if len(chunk[k]) == 0:
                repl[k] = []
                c.invalid_docs += 1
            else:
                patch.append(k)
        repl.update(zip(patch, self._fallback_batch(
            [chunk[k] for k in patch], unk_id, c)))
        return splice_docs(ids, bounds, repl)

    # ------------------------------------------------ the classic doc rows

    def _iw_of(self, syms: np.ndarray) -> np.ndarray:
        m = self._sym2iw
        return np.where(syms < len(m), m[np.minimum(syms, len(m) - 1)], -1)

    def _prep_batch(self, docs: list[bytes], force_numpy: bool = False,
                    with_spm: bool = False):
        """Doc rows of a batch (host.py:400-440): (x_iw int32 (B, n_doc), -1
        past the length; lengths int32 (B,); status uint8 (B,): 0 ok, 1
        invalid input, 2 more than n_doc symbols; rows of status 1 and 2 are
        empty), with ``with_spm`` (x_iw, is ▁ bool (B, n_doc), lengths,
        status).  Native prep_sp_batch, or prepare_sp_doc a document with
        ``force_numpy``."""
        if not force_numpy:
            x, spm, lengths, status = native.prep_sp_batch(
                docs, self.n_doc, self._sym2iw, self.seg.use_raw_bytes,
                self.seg.no_dummy_prefix, self.seg.charmap)
        else:
            B, N = len(docs), self.n_doc
            x = np.full((B, N), -1, np.int32)
            spm = np.zeros((B, N), bool)
            lengths = np.zeros(B, np.int32)
            status = np.zeros(B, np.uint8)
            for i, d in enumerate(docs):
                p = prepare_sp_doc(d, self.seg)
                n = len(p.syms)
                if not p.ok or n > N:
                    status[i] = 1 if not p.ok else 2
                    continue
                x[i, :n] = self._iw_of(p.syms)
                spm[i, :n] = p.syms == SP_DELIMITER
                lengths[i] = n
        return (x, spm, lengths, status) if with_spm else (x, lengths, status)

    def _segment(self, xd, ld, unk_id: int):
        """(ids, counts, fallback) of doc rows on the device: bpe_segment
        (K1, K2; at most RESOLVE_MAX_ARCS arcs a row, more flags it) or
        unigram_segment (K5, K6), in launches whose walk scratch stays under
        dedup.SCRATCH_BYTES."""
        from .dedup import launch_rows

        R, W = xd.shape
        step = launch_rows(self, W, None)
        a_max = min(self.a_max, bpe_ops.RESOLVE_MAX_ARCS)
        outs = []
        for lo in range(0, R, step):
            x, ln = xd[lo : lo + step], ld[lo : lo + step]
            if self.is_bpe:
                ids, _st, _en, counts, fb = bpe_ops.bpe_segment(
                    self.tables, x, ln, self._spm_iw, unk_id, a_max)
            else:
                ids, _st, _en, counts = uni_ops.unigram_segment(
                    self.tables, x, ln, unk_id)
                fb = torch.zeros(len(x), dtype=torch.bool, device=x.device)
            outs.append((ids, counts, fb))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(p) for p in zip(*outs))

    def _row_groups(self, lengths: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """(width, row indices) of rows of these lengths (at most
        ``row_max``): each row in the narrowest of 128, 256, ... (and
        row_max) that holds it."""
        widths = [MIN_ROW_WIDTH << k for k in range(8)
                  if MIN_ROW_WIDTH << k < self.row_max] + [self.row_max]
        cls = np.searchsorted(widths, lengths)  # first width >= the length
        return [(w, np.flatnonzero(cls == k)) for k, w in enumerate(widths)
                if (cls == k).any()]

    def _classic_rows(self, x: np.ndarray, lengths: np.ndarray, unk_id: int,
                      c=None):
        """The classic doc-row device pass (host.py:254-284) over prepped
        rows of positive length up to ``row_max``, grouped by width: each
        group's rows cut to the narrowest of 128, 256, ... (and row_max)
        that holds them, which
        gives the same ids.  Returns a handle for :meth:`_rows_out`, with the
        device work and its device-to-host copies queued.  The rows, their
        lanes and symbols are counted in ``c.classic_rows``,
        ``c.classic_lanes`` and ``c.classic_symbols``."""
        dev = self.device
        groups = []
        for w, idx in self._row_groups(lengths):
            if c is not None:
                c.classic_rows += len(idx)
                c.classic_lanes += w * len(idx)
                c.classic_symbols += int(lengths[idx].sum())
            xd = torch.from_numpy(np.ascontiguousarray(x[idx, :w])).to(dev)
            ld = torch.from_numpy(np.ascontiguousarray(lengths[idx])).to(dev)
            out = self._segment(xd, ld, unk_id)
            if dev.type == "cuda":
                host = []
                for t in out:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.append(h.copy_(t, non_blocking=True))
                out = tuple(host)
            groups.append((idx, out))
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return len(lengths), groups, done

    @staticmethod
    def _rows_out(handle, c=None):
        """(ids int32, the rows' tokens back to back in row order; counts
        int64 (R,); fallback bool (R,)) of a :meth:`_classic_rows` pass; the
        flagged rows counted in ``c.flagged_rows``."""
        R, groups, done = handle
        if done is not None:
            done.synchronize()
        counts = np.zeros(R, np.int64)
        fb = np.zeros(R, bool)
        for idx, (_ids, cnt, f) in groups:
            counts[idx] = cnt.numpy()
            fb[idx] = f.numpy()
        if c is not None:
            c.flagged_rows += int(np.count_nonzero(fb))
        off = np.zeros(R + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        ids = np.empty(int(off[-1]), np.int32)
        for idx, (t, _cnt, _f) in groups:
            t = t.numpy()
            c = counts[idx]
            lane = np.arange(t.shape[1])[None, :] < c[:, None]
            # each row's tokens land at its offset, in lane order
            dest = np.repeat(off[idx] - (np.cumsum(c) - c), c) + np.arange(c.sum())
            ids[dest] = t[lane]
        return ids, counts, fb

    def _split_chunks(self, n: int, pos: np.ndarray
                      ) -> list[tuple[int, int]] | None:
        """Greedy whitespace-safe windowing (host.py:312-329) of a row of n
        symbols at the sorted split positions ``pos`` (its ▁): (start, end)
        spans of at most row_max symbols, every span after the first
        starting at a ▁.  None when a word (or, for a model that is not
        chunk-safe, a run between uncrossed ▁) exceeds the row."""
        N = self.row_max
        spans: list[tuple[int, int]] = []
        start = 0
        while n - start > N:
            j = int(np.searchsorted(pos, start + N, side="right")) - 1
            if j < 0 or pos[j] <= start:
                return None
            spans.append((start, int(pos[j])))
            start = int(pos[j])
        spans.append((start, n))
        return spans

    def _overflow_syms(self, d: bytes):
        """(x_iw, is ▁) of one document's whole symbol row, or None for
        invalid input: native prep at the width of its own scratch (10
        symbols a byte and 16), which no document overflows."""
        seg = self.seg
        x, spm, ln, status = native.prep_sp_batch(
            [d], 10 * len(d) + 16, self._sym2iw, seg.use_raw_bytes,
            seg.no_dummy_prefix, seg.charmap)
        return (x[0, : ln[0]], spm[0, : ln[0]]) if status[0] == 0 else None

    def _encode_overflow(self, docs: list[bytes], unk_id: int, c=None
                         ) -> list[list[int] | None]:
        """Device ids of documents longer than ``row_max`` (host.py:331-398):
        prep each whole document, split it at ▁ (:meth:`_split_chunks`),
        run the chunks as rows and join their ids in order.  A model that
        is not chunk-safe splits only at a ▁ that no match crosses
        (:meth:`_crossed`, one walk over all the documents); JAX sends its
        long documents to the host instead.  None where no split fits (or
        "▁" alone is no piece), the input is invalid or the device flags a
        chunk: those take the fallback.  Flagged rows are counted in
        ``c.flagged_rows``, chunk rows in ``c.chunk_rows``.  Timed inside
        the stage "chunk": "chunk.prep" (each document's native prep),
        "chunk.crossed" (the walk of :meth:`_crossed`) and "chunk.rows" (the
        chunk rows' device pass and its ids)."""
        results: list[list[int] | None] = [None] * len(docs)
        if not self._splittable:
            return results
        with metrics.stage("chunk.prep", c):
            prepped = [(i, r) for i, r in
                       enumerate(map(self._overflow_syms, docs))
                       if r is not None]
        if not prepped:
            return results
        if not self._chunk_safe:
            with metrics.stage("chunk.crossed", c):
                xx = np.concatenate([a for _i, (x, _s) in prepped
                                     for a in (x, np.full(1, -1, np.int32))])
                crossed = self._crossed(xx)
        per_doc: list[tuple[int, int]] = []
        rows: list[np.ndarray] = []
        off = 0
        for i, (x, spm) in prepped:
            ok = spm if self._chunk_safe else spm & ~crossed[off : off + len(x)]
            off += len(x) + 1
            spans = self._split_chunks(len(x), np.flatnonzero(ok))
            if spans is not None:
                per_doc.append((i, len(spans)))
                rows += [x[s:e] for s, e in spans]
        if not rows:
            return results
        # the chunk rows' device pass, timed as "chunk.rows" by the clock
        # alone: a stage's profiler range over card work would show on the
        # card's timeline (metrics.stage)
        t = time.perf_counter()
        x = np.full((len(rows), self.row_max), -1, np.int32)
        lengths = np.array([len(r) for r in rows], np.int32)
        for r, ch in enumerate(rows):
            x[r, : len(ch)] = ch
        ids, counts, fb = self._rows_out(
            self._classic_rows(x, lengths, unk_id, c), c)
        cc = c or metrics.global_counters()
        cc.chunk_rows += len(rows)
        cc.stage_seconds["chunk.rows"] += time.perf_counter() - t
        off = np.concatenate([[0], np.cumsum(counts)])
        row = 0
        for i, k in per_doc:
            if not fb[row : row + k].any():
                results[i] = ids[off[row] : off[row + k]].tolist()
            row += k
        return results

    def _classic_dispatch(self, docs_b: list[bytes], unk_id: int, c=None):
        """Prep a batch (the stage "dispatch.prep") and queue the device pass
        of its rows up to ``row_max``: (state, rows)."""
        with metrics.stage("dispatch.prep", c):
            x, lengths, status = self._prep_batch(docs_b)
            rows = np.flatnonzero((lengths > 0) & (lengths <= self.row_max))
        handle = self._classic_rows(x[rows], lengths[rows], unk_id, c)
        return (rows, status, lengths, handle), len(rows)

    def _classic_collect(self, docs_b: list[bytes], state, unk_id: int, c):
        """The batch's flat (ids, bounds) of a :meth:`_classic_dispatch`:
        the stage "collect" ("collect.wait" for the card, "collect.rows_out"
        for the ids' scatter), then :meth:`_finish`."""
        rows, status, lengths, handle = state
        with metrics.stage("collect", c):
            with metrics.stage("collect.wait", c):
                done = handle[2]  # _rows_out's own wait then returns at once
                if done is not None:
                    done.synchronize()
            with metrics.stage("collect.rows_out", c):
                ids, counts, fb = self._rows_out(handle, c)
            cnt = np.zeros(len(docs_b), np.int64)
            cnt[rows] = counts
            bounds = np.zeros(len(docs_b) + 1, np.int64)
            np.cumsum(cnt, out=bounds[1:])
        over = (status == 2) | (lengths > self.row_max)
        return self._finish(docs_b, ids, bounds, {}, rows[fb], over, status,
                            unk_id, c)

    def _finish(self, docs_b, ids, bounds, repl, fb_docs, over, status,
                unk_id: int, c):
        """A batch's flat (ids, bounds) from the device's ``ids``/``bounds``
        and the replacements ``repl`` (document -> ids): the documents of
        the mask ``over`` through :meth:`_encode_overflow` (timed as the
        stage "chunk"), and documents the device flags (``fb_docs``) or no
        split holds through :meth:`_fallback_batch` (the stage "fallback")."""
        with metrics.stage("chunk", c):
            over_idx = np.flatnonzero(over)
            chunked = self._encode_overflow([docs_b[k] for k in over_idx],
                                            unk_id, c)
            n_repl = len(repl)
            repl.update((int(k), got) for k, got in zip(over_idx, chunked)
                        if got is not None)
            c.chunked_docs += len(repl) - n_repl
            c.invalid_docs += int((status == 1).sum())
        need = [int(k) for k in fb_docs] + [int(k) for k in over_idx
                                            if int(k) not in repl]
        if need:
            with metrics.stage("fallback", c):
                repl.update(zip(need, self._fallback_batch(
                    [docs_b[k] for k in need], unk_id, c)))
        return splice_docs(ids, bounds, repl) if repl else (ids, bounds)

    # ---------------------------------------------------- the NumPy unit path

    def _units_np_dispatch(self, docs_b: list[bytes], unk_id: int, c=None):
        """Prep a batch (the stage "dispatch.prep") and queue the NumPy unit
        path's device pass (``UnitRunner.dispatch``; host.py:706): (state,
        rows)."""
        with metrics.stage("dispatch.prep", c):
            x, spm, lengths, status = self._prep_batch(docs_b, with_spm=True)
        st = self._unit_runner().dispatch(x, spm, lengths, unk_id)
        return (x, lengths, status, st), len(st[4])  # st[4]: the packed rows

    def _units_np_collect(self, docs_b: list[bytes], state, unk_id: int, c):
        """The batch's flat (ids, bounds) of a :meth:`_units_np_dispatch`:
        the units' ids, and the documents the unit path marks (a unit past
        UNIT_MAX, a flagged row) through the classic rows (host.py:755-791),
        or through :meth:`_finish`'s chunk rows when longer than
        ``row_max``."""
        x, lengths, status, st = state
        c.units_np_batches += 1
        with metrics.stage("collect", c):
            ids, bounds, need = self._unit_runner().collect_flat(st, c)
            rows = np.flatnonzero(need & (lengths > 0)
                                  & (lengths <= self.row_max))
            cids, counts, fb = self._rows_out(
                self._classic_rows(x[rows], lengths[rows], unk_id, c), c)
            off = np.zeros(len(rows) + 1, np.int64)
            np.cumsum(counts, out=off[1:])
            repl = {int(k): cids[off[i] : off[i + 1]].tolist()
                    for i, k in enumerate(rows) if not fb[i]}
        over = (status == 2) | (need & (lengths > self.row_max))
        return self._finish(docs_b, ids, bounds, repl, rows[fb], over, status,
                            unk_id, c)

    def _units_collect(self, docs_b: list[bytes], state, unk_id: int, c):
        """The batch's flat (ids, bounds) of ``UnitRunner.dispatch_docs``:
        the stages "collect" (the wait and the native stitch) and, apart
        from it, "fallback" (one native call a document that holds a
        flagged unit)."""
        with metrics.stage("collect", c):
            ids, bounds, need, status = self._unit_runner().collect_docs(state)
        if need.any():
            with metrics.stage("fallback", c):
                ids, bounds = self._patch_fallbacks(
                    docs_b, ids, bounds, need, status, unk_id, c)
        return ids, bounds

    def _route(self, dedup: bool | None = None):
        """(dispatch, collect) of this model's batch path: the native unit
        path (None), the NumPy unit path, or the classic doc rows; ``dedup
        = False`` forces the classic rows."""
        if dedup is False or not self._chunk_safe:
            return self._classic_dispatch, self._classic_collect
        if self._native_units_ok():
            return None
        return self._units_np_dispatch, self._units_np_collect

    # ------------------------------------------------------- entry points

    def encode_corpus_flat(
        self,
        docs: list[bytes | str],
        unk_id: int = 0,
        batch_docs: int = 16384,
        counters=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Production corpus tokenization.

        Returns (ids, bounds): document i's token ids are
        ``ids[bounds[i]:bounds[i+1]]``.  Native prep (and, on the unit path,
        dedup and packing), the device passes of each batch, one
        device-to-host copy per row group, a native stitch on the unit path;
        up to three batches in flight, so host prep overlaps device work.
        A chunk-safe model off the compact lanes takes the NumPy unit path,
        a model that is not chunk-safe the classic doc rows (host.py:540-551,
        :673-817)."""
        c = counters or metrics.global_counters()
        with metrics.stage("call.split", c):
            docs_b = [d.encode("utf-8") if isinstance(d, str) else d
                      for d in docs]
        route = self._route()
        if route is not None:
            dispatch_b, collect_b = route
            return run_pipeline(
                docs_b, batch_docs,
                lambda chunk: dispatch_b(chunk, unk_id, c),
                lambda chunk, st: collect_b(chunk, st, unk_id, c),
                c)
        runner = self._unit_runner()
        # cross-batch unit cache, fresh per call: later batches dispatch
        # only units never resolved before
        ucache = native.UnitCache()

        def dispatch(chunk):
            state = runner.dispatch_docs(chunk, unk_id, cache=ucache,
                                         counters=c)
            return state, state[0].n_rows

        def collect(chunk, state):
            return self._units_collect(chunk, state, unk_id, c)

        out = run_pipeline(docs_b, batch_docs, dispatch, collect, c)
        c.cache_units = ucache.stats()["units"]
        return out

    def encode_batch(self, docs: list[bytes | str], unk_id: int = 0,
                     dedup: bool | None = None) -> list[list[int]]:
        """Per-document id lists for one batch (host.py:605-670): the unit
        path (native, or NumPy off the compact lanes) when the model is
        chunk-safe and ``dedup`` is not False, else the classic doc rows.
        The native unit path times the stages of the corpus path
        ("dispatch", "collect", "fallback" and their sub-stages); every
        route times the lists' building as "lists"."""
        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        c = metrics.global_counters()
        route = self._route(dedup)
        if route is None:
            with metrics.stage("dispatch", c):
                state = self._unit_runner().dispatch_docs(docs_b, unk_id,
                                                          counters=c)
            ids, bounds = self._units_collect(docs_b, state, unk_id, c)
        else:
            state, _rows = route[0](docs_b, unk_id, c)
            ids, bounds = route[1](docs_b, state, unk_id, c)
        with metrics.stage("lists", c):
            return [ids[bounds[i] : bounds[i + 1]].tolist()
                    for i in range(len(docs_b))]

    def encode_corpus(self, docs: list[bytes | str], unk_id: int = 0,
                      batch_docs: int = 2048, counters=None
                      ) -> list[list[int]]:
        """Per-document id lists of a corpus (host.py:673-817): the lists of
        :meth:`encode_corpus_flat`."""
        ids, bounds = self.encode_corpus_flat(docs, unk_id=unk_id,
                                              batch_docs=batch_docs,
                                              counters=counters)
        return [ids[bounds[i] : bounds[i + 1]].tolist()
                for i in range(len(bounds) - 1)]


def run_pipeline(docs_b: list[bytes], batch_docs: int, dispatch, collect,
                 c) -> tuple[np.ndarray, np.ndarray]:
    """A corpus through a path's batches, up to three in flight, so the
    host work of one overlaps the device work of another.

    ``dispatch(chunk)`` -> (state, rows dispatched), timed as the stage
    "dispatch"; ``collect(chunk, state)`` -> the batch's flat (ids, bounds),
    timing its own stages.  The batching is timed as "call.split" and the
    joining of the batches' parts as "call.join".  Returns the corpus's
    flat (ids, bounds) and adds to the counters ``c``."""
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    inflight: list = []

    def finish(entry):
        ids, bounds = collect(*entry)
        c.tokens_out += int(bounds[-1])
        parts.append((ids, bounds))

    with metrics.stage("call.split", c):
        batches = _batches_by_bytes(docs_b, batch_docs)
    for chunk in batches:
        with metrics.stage("dispatch", c):
            state, n_rows = dispatch(chunk)
        c.dispatched_rows += n_rows
        c.docs_in += len(chunk)
        c.batches += 1
        inflight.append((chunk, state))
        if len(inflight) > 2:
            finish(inflight.pop(0))
    while inflight:
        finish(inflight.pop(0))
    c.bytes_in += sum(map(len, docs_b))
    with metrics.stage("call.join", c):
        if len(parts) == 1:
            return parts[0]
        ids = np.concatenate([i for i, _b in parts]
                             or [np.zeros(0, np.int32)], dtype=np.int32)
        bounds = np.zeros(len(docs_b) + 1, np.int64)
        t = d = 0
        for pi, pb in parts:
            nb = len(pb) - 1
            bounds[d + 1 : d + 1 + nb] = pb[1:] + t
            t += len(pi)
            d += nb
        return ids, bounds


def splice_docs(ids: np.ndarray, bounds: np.ndarray,
                repl: dict[int, list[int]]) -> tuple[np.ndarray, np.ndarray]:
    """Flat (ids, bounds) with document k's ids replaced by ``repl[k]``."""
    cnt = np.diff(bounds)
    for k, v in repl.items():
        cnt[k] = len(v)
    nb = np.zeros(len(bounds), np.int64)
    np.cumsum(cnt, out=nb[1:])
    out = np.empty(int(nb[-1]), np.int32)
    prev = 0
    for k in sorted(repl):
        if k > prev:  # untouched run [prev, k): counts unchanged
            out[nb[prev] : nb[k]] = ids[bounds[prev] : bounds[k]]
        out[nb[k] : nb[k + 1]] = repl[k]
        prev = k + 1
    n = len(cnt)
    if prev < n:
        out[nb[prev] : nb[n]] = ids[bounds[prev] : bounds[n]]
    return out, nb


def _batches_by_bytes(
    docs_b: list[bytes], max_docs: int, target_bytes: int = 2 << 20
) -> list[list[bytes]]:
    """Greedy batching by total bytes (capped at max_docs documents), so
    corpora of tiny documents do not pay per-batch fixed costs per doc."""
    n = len(docs_b)
    if n == 0:
        return []
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((len(d) for d in docs_b), np.int64, n), out=cs[1:])
    out: list[list[bytes]] = []
    i = 0
    while i < n:
        j = int(np.searchsorted(cs, cs[i] + target_bytes, side="left"))
        j = min(max(j, i + 1), i + max_docs, n)
        out.append(docs_b[i:j])
        i = j
    return out


def _max_token_len(aut) -> int:
    """Longest accepted string = longest path to a final state (DAG)."""
    import collections

    n = aut.n_states
    dst = np.where(aut.edge_dst < 0, n, aut.edge_dst)
    indeg = np.zeros(n + 1, np.int64)
    np.add.at(indeg, dst, 1)
    order = np.argsort(aut.edge_src, kind="stable")
    src_s = aut.edge_src[order]
    dst_s = dst[order]
    row = np.searchsorted(src_s, np.arange(n + 2))
    depth = np.zeros(n + 1, np.int64)
    q = collections.deque([s for s in range(n + 1) if indeg[s] == 0])
    visited = 0
    while q:
        s = q.popleft()
        visited += 1
        if s < n:
            for ei in range(row[s], row[s + 1]):
                d = dst_s[ei]
                depth[d] = max(depth[d], depth[s] + 1)
                indeg[d] -= 1
                if indeg[d] == 0:
                    q.append(d)
    if visited != n + 1:
        # cyclic automaton (not a finite vocab) — cap at the product limit
        return 300
    return int(depth.max())
