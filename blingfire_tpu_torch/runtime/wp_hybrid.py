"""WordPiece hybrid production path (bert-class [wbd] models) on the card:
port of blingfire_tpu/runtime/wp_hybrid.py (WpUnitCache, WordPieceHybrid:
__init__, _map_raw, _fn_pack_safe, available, new_cache, _device_pass,
dispatch, collect, _patch_native, encode_corpus_flat, text_to_ids_batch).

Division of labour, as in the JAX package:

  C++   per document: UTF-8 decode, charmap normalization, the LEVEL-0 lexer
        scan (words and ignores; the sub-token function is not entered),
        and the intern of each function span, typically a Zipf-repeated
        word, once per corpus (native runtime.cpp::BtlWpAnalyzeC with a
        WpUnitCache);
  card  the sub-token pass over the UNIQUE words only, packed densely with
        their own anchors into 128-lane rows (ops/lexer.py: K7, or K8 when
        the dense table is declined), one launch over both unit-length
        classes and one device-to-host copy per batch;
  C++   the per-unit coverage check and the flat per-document ids
        (runtime.cpp::BtlWpStitch); documents it cannot serve (a word over
        MAX_UNIT symbols, a nested sub-function) go to the native
        TextToIds, the same semantics on the host.

Packing many words into one row is sound only when the sub-grammar cannot
walk across an R anchor and has no IW_ANY transitions; `_fn_pack_safe`
checks both at load.  A model that fails it raises NotImplementedError
that points to runtime/lexer_host.py::WordPieceTpu, the row-level pattern
lexer that serves any WordPiece model (the JAX package's api.py:125-128
fallback).  The TPU
package's fixed row buckets, background warm-up and transfer groups
(``warm``, ``warm_all``, ``big_ready``, ``BIG_BUCKET``, ``GROUP_CHUNKS``)
avoided XLA recompiles; nothing here compiles per shape, so a batch is one
launch over its exact row count, each length class at its own walk depth,
and the output rows keep their packed order, so the stitch's row map is the
identity.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.consts import Iw
from ..models.loader import Model
from ..ops import lexer as lexer_ops
from . import metrics
from .host import run_pipeline, splice_docs

MAX_UNIT = 40  # longest word the device path handles (fallback beyond)
LW_CLASSES = (16, MAX_UNIT)  # unit-length classes -> walk depth lw = len + 2
ROW_W = 128


class WpUnitCache:
    """Cross-batch (word -> sub-token ids) cache for the hybrid path."""

    def __init__(self, rt):
        self._rt = rt
        self._handle = rt.BtlWpCacheNew()

    def stats(self) -> dict:
        s = np.zeros(4, np.int64)
        self._rt.BtlWpCacheStats(self._handle,
                                 s.ctypes.data_as(ctypes.c_void_p))
        return {"units": int(s[0]), "resolved": int(s[1]),
                "arena_ids": int(s[2]), "bytes": int(s[3])}

    def close(self):
        if self._handle is not None:
            self._rt.BtlWpCacheFree(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class WordPieceHybrid:
    """Batched TextToIds for one WordPiece model, native + card hybrid.

    ``device`` defaults to ``"cuda"``, where the sub-token pass is K7 (or
    K8); ``device="cpu"`` runs their plain PyTorch versions."""

    def __init__(self, model: Model, model_path: str | None = None,
                 device: str | torch.device = "cuda"):
        from .. import native
        from ..ops.tables import build_comb_table_cached
        from .lexer import LexerEngine

        if model.wbd is None or model.wbd.aut.iw2iw is None:
            raise ValueError("not a WordPiece [wbd] model with an iw map")
        self.device = torch.device(device)
        self.model = model
        self.wbd = model.wbd
        self.engine = LexerEngine(model.wbd)
        self.comb = build_comb_table_cached(model.wbd.aut, model.source_key,
                                            "wbd")
        self.tables = lexer_ops.make_device_tables(
            self.comb,
            model.wbd.aut.moore_ow,
            model.wbd.acts,
            model.wbd.max_token_length,
            device=self.device,
        )
        self._iw2iw = model.wbd.aut.iw2iw
        self._n_iws = self.comb.n_iws
        self._l_iw = int(self._map_raw(np.array([Iw.L_ANCHOR], np.int32))[0])
        self._r_iw = int(self._map_raw(np.array([Iw.R_ANCHOR], np.int32))[0])
        self._rt = native.get_runtime()
        if model_path is not None:
            h = self._rt.LoadModel(model_path.encode())
        else:
            img = model.ldb.image
            self._img_buf = ctypes.create_string_buffer(img, len(img))
            h = self._rt.SetModel(self._img_buf, len(img))
        if not h:
            raise RuntimeError("the native runtime could not load the model")
        self._nh = h
        self._inis = [s for s in self.engine.fn2ini[1:]
                      if s is not None and s >= 0]
        self._safe = self._fn_pack_safe()
        # per function id: the initial state the lanes of its units start
        # from (the dense walk numbers states finals-first)
        self._fn2ini = np.array(
            [f if f is not None and f >= 0 else -1
             for f in self.engine.fn2ini] or [-1], np.int32)
        self._dense = None
        if self._safe:
            self._dense = lexer_ops.make_dense_sub(
                self.comb, model.wbd.aut.moore_ow, self._inis,
                device=self.device)
        if self._dense is not None:
            perm = self._dense[2]
            ok = (self._fn2ini >= 0) & (self._fn2ini < len(perm))
            self._fn2ini = np.where(
                ok, perm[np.clip(self._fn2ini, 0, len(perm) - 1)], -1
            ).astype(np.int32)

    def _map_raw(self, raw: np.ndarray) -> np.ndarray:
        m = self._iw2iw
        idx = np.clip(raw, 0, len(m) - 1)
        v = np.where((raw >= 0) & (raw < len(m)), m[idx], -1)
        return np.where(v < 0, self._n_iws, v).astype(np.int32)

    def _fn_pack_safe(self) -> bool:
        """Dense word packing + no-ANY walk are sound iff, over the states
        reachable from the sub-function initial states: (a) no transition is
        labelled IW_ANY, (b) every R-anchor destination is a dead end, and
        (c) the tag ids fit the 17-bit lane field."""
        comb = self.comb
        inis = self._inis
        if not inis:
            return False
        act_tag = self.tables.act_tag
        if (int(act_tag.max()) if act_tag.numel() else 0) + 1 >= (1 << 17):
            return False
        any_iw = int(comb.sym2iw[0]) if len(comb.sym2iw) else -1
        base = np.asarray(comb.base)
        owner = np.asarray(comb.owner)
        nxt = np.asarray(comb.nxt)
        n_states = len(base)
        seen = np.zeros(n_states, bool)
        stack = list(dict.fromkeys(inis))
        for s in stack:
            seen[s] = True
        occ = np.flatnonzero(owner >= 0)
        occ_iw = occ - base[owner[occ]]
        # state -> its occupied slots (grouped)
        order = np.argsort(owner[occ], kind="stable")
        so = owner[occ][order]
        slot_sorted = occ[order]
        iw_sorted = occ_iw[order]
        row = np.searchsorted(so, np.arange(n_states + 1))
        while stack:
            s = stack.pop()
            for k in range(row[s], row[s + 1]):
                iw = int(iw_sorted[k])
                d = int(nxt[slot_sorted[k]])
                if d < 0:
                    continue
                if iw == any_iw and any_iw >= 0:
                    return False
                if iw == self._r_iw:
                    # R destination must be a dead end
                    if row[d] != row[d + 1]:
                        return False
                    continue
                if not seen[d]:
                    seen[d] = True
                    stack.append(d)
        return True

    def available(self) -> bool:
        return self._safe

    def _require_safe(self) -> None:
        if not self._safe:
            raise NotImplementedError(
                "this grammar's sub-token function is not pack-safe (IW_ANY "
                "transitions or a live state after an R anchor): use "
                "runtime/lexer_host.py::WordPieceTpu(model).text_to_ids_batch, "
                "the row-level lexer pass that serves it")

    # ------------------------------------------------------------------ run

    def new_cache(self):
        """Cross-batch word cache handle (runtime.cpp::WpCache)."""
        return WpUnitCache(self._rt)

    def _device_pass(self, bx, bi, lw: int, out=None, tail=None):
        if self._dense is not None:
            dnext, ow_perm, _perm, n_f, _n_reach = self._dense
            return lexer_ops.wp_subword_pass_dense(
                self.tables, dnext, ow_perm, bx, bi, self._l_iw, self._r_iw,
                lw, n_f, self._n_iws, out=out, tail=tail)
        return lexer_ops.wp_subword_pass(
            self.tables, bx, bi, self._l_iw, self._r_iw, lw, out=out,
            tail=tail)

    def _passes(self, xd, idv, class_rows, out) -> None:
        """The device pass of a batch's packed rows into ``out``: one launch
        over both length classes (class_rows as _pack gives them, at most
        two, the first from row 0), each at its own walk depth."""
        (lo, hi, lw), *rest = class_rows
        if lo != 0 or len(rest) > 1 or (rest and rest[0][0] != hi):
            raise ValueError(f"not one or two classes from row 0: "
                             f"{class_rows}")
        self._device_pass(xd, idv, lw, out=out,
                          tail=(hi, rest[0][2]) if rest else None)

    def _analyze(self, docs_b: list[bytes], cache=None):
        """Native level-0 scan and intern of a batch: (handle, u_syms,
        u_soff, u_fn) of the units to pack (the cache's misses)."""
        rt = self._rt
        B = len(docs_b)
        blob = b"".join(docs_b)
        doc_off = np.zeros(B + 1, np.int64)
        np.cumsum([len(d) for d in docs_b], out=doc_off[1:])
        counts = np.zeros(5, np.int64)
        h = rt.BtlWpAnalyzeC(
            cache._handle if cache is not None else None,
            self._nh, blob, doc_off.ctypes.data_as(ctypes.c_void_p), B,
            MAX_UNIT, counts.ctypes.data_as(ctypes.c_void_p),
        )
        if not h:
            raise RuntimeError("BtlWpAnalyzeC failed")
        U, S = int(counts[0]), int(counts[1])
        u_syms = np.empty(max(S, 1), np.int32)
        u_soff = np.empty(U + 1, np.int32)
        u_fn = np.empty(max(U, 1), np.int32)
        rt.BtlWpUnits(
            h,
            u_syms.ctypes.data_as(ctypes.c_void_p),
            u_soff.ctypes.data_as(ctypes.c_void_p),
            u_fn.ctypes.data_as(ctypes.c_void_p),
        )
        return h, u_syms[:S], u_soff, u_fn[:U]

    def _pack(self, u_syms, u_soff, u_fn):
        """Dense packing into ROW_W-wide rows, by unit-length class.

        Units are grouped by EXACT ext length e (length + 2 anchors): a row
        holds floor(ROW_W / e) of them at stride e.  Returns (px, pinit,
        class_rows, u_row, u_off): int32 (R, ROW_W) symbols and per-lane
        initial states, [(row_lo, row_hi, lw)] per class, and each unit's
        row and offset."""
        U = len(u_soff) - 1
        ulen = np.diff(u_soff)
        ext = ulen + 2
        u_row = np.zeros(max(U, 1), np.int32)
        u_off = np.zeros(max(U, 1), np.int32)
        fn2ini = self._fn2ini
        iw_flat = self._map_raw(u_syms) if len(u_syms) else u_syms
        blocks_x: list[np.ndarray] = []
        blocks_i: list[np.ndarray] = []
        class_rows: list[tuple[int, int, int]] = []
        base_row = 0
        for cap_len in LW_CLASSES:
            lo_row = base_row
            members = np.flatnonzero(
                (ulen <= cap_len)
                & (ulen > (0 if cap_len == LW_CLASSES[0] else LW_CLASSES[0]))
            )
            for e in np.unique(ext[members]) if len(members) else []:
                grp = members[ext[members] == e]
                e = int(e)
                per = ROW_W // e
                nrows = -(-len(grp) // per)
                k = np.arange(len(grp))
                r = (k // per).astype(np.int32)
                o = ((k % per) * e).astype(np.int32)
                u_row[grp] = base_row + r
                u_off[grp] = o
                X = np.full((nrows, ROW_W), -1, np.int32)
                I = np.full((nrows, ROW_W), -1, np.int32)
                X[r, o] = self._l_iw
                X[r, o + e - 1] = self._r_iw
                starts = u_soff[grp]
                for j in range(e - 2):
                    X[r, o + 1 + j] = iw_flat[starts + j]
                finis = fn2ini[np.clip(u_fn[grp], 0, len(fn2ini) - 1)]
                for j in range(e):
                    I[r, o + j] = finis
                blocks_x.append(X)
                blocks_i.append(I)
                base_row += nrows
            class_rows.append((lo_row, base_row, cap_len + 2))
        px = (np.concatenate(blocks_x) if blocks_x
              else np.zeros((0, ROW_W), np.int32))
        pinit = (np.concatenate(blocks_i) if blocks_i
                 else np.zeros((0, ROW_W), np.int32))
        return px, pinit, class_rows, u_row, u_off

    def dispatch(self, docs_b: list[bytes], cache=None):
        """Analysis, packing and the device pass of one batch; returns with
        the launches and the one device-to-host copy queued."""
        self._require_safe()
        h, u_syms, u_soff, u_fn = self._analyze(docs_b, cache)
        px, pinit, class_rows, u_row, u_off = self._pack(u_syms, u_soff, u_fn)
        R = len(px)
        dev = self.device
        out = torch.empty((R, ROW_W + 2), dtype=torch.int32, device=dev)
        if R:
            self._passes(torch.from_numpy(px).to(dev),
                         torch.from_numpy(pinit).to(dev), class_rows, out)
        if dev.type == "cuda":
            host = torch.empty((R, ROW_W + 2), dtype=torch.int32,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = out, None
        return (h, len(docs_b), u_row, u_off, host, done)

    def _stitch(self, state, unk_id: int, docs_b: list[bytes]):
        """Waits for the batch's rows; native stitch: (ids, bounds, need)."""
        h, B, u_row, u_off, host, done = state
        if done is not None:
            done.synchronize()
        rows = np.ascontiguousarray(host.numpy())
        cap = int(sum(len(d) for d in docs_b)) + B + 16
        out_ids = np.empty(cap, np.int32)
        bounds = np.empty(B + 1, np.int64)
        need = np.empty(B, np.uint8)
        t = self._rt.BtlWpStitch(
            h, rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0], ROW_W + 2,
            u_row.ctypes.data_as(ctypes.c_void_p),
            u_off.ctypes.data_as(ctypes.c_void_p), unk_id,
            out_ids.ctypes.data_as(ctypes.c_void_p), cap,
            bounds.ctypes.data_as(ctypes.c_void_p),
            need.ctypes.data_as(ctypes.c_void_p),
        )
        self._rt.BtlWpFree(h)
        if t < 0:
            raise RuntimeError("BtlWpStitch capacity exceeded")
        return out_ids[:t], bounds, need

    def collect(self, state, unk_id: int, docs_b: list[bytes]):
        """(ids, bounds, fallback doc count) of a dispatched batch."""
        ids, bounds, need = self._stitch(state, unk_id, docs_b)
        n_fb = int(need.sum())
        if n_fb:
            ids, bounds = self._patch_native(docs_b, ids, bounds, need, unk_id)
        return ids, bounds, n_fb

    def _patch_native(self, docs_b, ids, bounds, need, unk_id):
        """Fallback docs run the full native TextToIds (host C++)."""
        rt = self._rt
        buf = np.empty(1 << 16, np.int32)
        repl = {}
        for k in np.flatnonzero(need):
            d = docs_b[int(k)]
            n = rt.TextToIds(self._nh, d, len(d),
                             buf.ctypes.data_as(ctypes.c_void_p), len(buf),
                             unk_id)
            repl[int(k)] = buf[:n].tolist()
        return splice_docs(ids, bounds, repl)

    def encode_corpus_flat(
        self, docs, unk_id: int = 0, batch_docs: int = 16384, counters=None
    ):
        """(ids, bounds) over the whole corpus: document i's ids are
        ``ids[bounds[i]:bounds[i+1]]``.  Up to three batches in flight, so
        the native analysis of one overlaps the device pass of another."""
        self._require_safe()
        c = counters or metrics.global_counters()
        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        ucache = self.new_cache()  # cumulative dedup over this call

        def dispatch(chunk):
            state = self.dispatch(chunk, cache=ucache)
            return state, state[4].shape[0]

        def collect(chunk, state):
            with metrics.stage("collect", c):
                ids, bounds, need = self._stitch(state, unk_id, chunk)
            n_fb = int(need.sum())
            if n_fb:
                # timed apart from the stitch: native TextToIds per document
                with metrics.stage("fallback", c):
                    ids, bounds = self._patch_native(chunk, ids, bounds, need,
                                                     unk_id)
            c.fallback_docs += n_fb
            c.fallback_bytes += sum(len(chunk[k]) for k in np.flatnonzero(need))
            return ids, bounds

        out = run_pipeline(docs_b, batch_docs, dispatch, collect, c)
        c.cache_units = ucache.stats()["units"]
        return out

    def text_to_ids_batch(self, docs, unk_id: int = 0) -> list[list[int]]:
        ids, bounds = self.encode_corpus_flat(docs, unk_id=unk_id)
        return [
            ids[bounds[i] : bounds[i + 1]].tolist() for i in range(len(docs))
        ]
