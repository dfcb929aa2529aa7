"""Corpus tokenization entry point: port of blingfire_tpu/runtime/host.py
(SpTokenizer: __init__, _compute_chunk_safe, _native_units_ok,
_fallback_ids, _patch_fallbacks, encode_corpus_flat, the native-units
branch of encode_batch; _batches_by_bytes and _max_token_len), with the
batch pipeline and the splice of fallback documents that it shares with
runtime/wp_hybrid.py (``run_pipeline``, ``splice_docs``).

This port serves chunk-safe byte/char BPE and unigram-LM models through the
unique-unit device path (runtime/dedup.py).  Not ported yet, and raising
NotImplementedError (ROADMAP.md queue A item 5): the classic doc-row path
(encode_corpus, _classic_rows, _prep_batch), long-document chunking
(_encode_overflow), the NumPy unit path, and models that are not
chunk-safe.  Fallback documents go to the scalar oracle
(runtime/oracle.py), whose ids are reference-exact; the native C++ runtime
the JAX package uses for them is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.consts import SP_DELIMITER, TokAlgo
from ..models.loader import Model
from ..ops import bpe as bpe_ops
from ..ops import unigram as uni_ops
from ..ops.tables import build_comb_table_cached, build_trie_table_cached
from . import metrics
from .oracle import SpTokenizerOracle

ROADMAP_A5 = "ROADMAP.md queue A item 5"


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
        self._oracle = SpTokenizerOracle(seg)
        self._sym2iw = self.comb.sym2iw
        self._chunk_safe = self._compute_chunk_safe()
        self._units = None

    def _unit_runner(self):
        if self._units is None:
            from .dedup import UnitRunner

            self._units = UnitRunner(self)
        return self._units

    def _compute_chunk_safe(self) -> bool:
        """True when documents may be split at ▁ boundaries without changing
        the result: (a) no vocabulary piece has an internal ▁, and (b) the
        single piece "▁" is accepted (host.py:286-310)."""
        comb = self.comb
        m = comb.sym2iw
        if SP_DELIMITER >= len(m):
            return False
        spm_iw = int(m[SP_DELIMITER])
        if spm_iw < 0:
            return False
        occ = np.flatnonzero(comb.owner >= 0)
        iw = occ - comb.base[comb.owner[occ]]
        if np.any((iw == spm_iw) & (comb.owner[occ] != 0)):
            return False  # internal-▁ pieces exist: splits can cut an arc
        slot = int(comb.base[0]) + spm_iw
        if not (0 <= slot < comb.n_slots) or comb.owner[slot] != 0:
            return False
        dst = int(comb.nxt[slot])
        return dst >= 0 and bool(comb.final[dst])

    def _native_units_ok(self) -> bool:
        """True when the unique-unit device path can serve this model."""
        return self._chunk_safe and self._unit_runner().compact_ok

    def _require_units(self) -> None:
        if not self._native_units_ok():
            raise NotImplementedError(
                "this model cannot take the unique-unit path (not chunk-safe "
                "or ids too wide for compact lanes); the classic doc-row path "
                "is not ported yet: " + ROADMAP_A5)

    def _fallback_ids(self, d: bytes, unk_id: int) -> list[int]:
        """Host-path ids for one fallback document (scalar oracle)."""
        return self._oracle.text_to_ids(d, unk_id=unk_id)

    def _patch_fallbacks(self, chunk, ids, bounds, need, status, unk_id, c):
        """Replace the (rare) fallback docs' empty spans in a flat result:
        invalid -> 0 ids, rest -> the oracle.  Returns updated (ids, bounds)."""
        repl: dict[int, list[int]] = {}
        need_idx = np.flatnonzero(need)
        for k in need_idx:
            k = int(k)
            d = chunk[k]
            if len(d) == 0:
                repl[k] = []
                c.invalid_docs += 1
            else:
                repl[k] = self._fallback_ids(d, unk_id)
                c.fallback_docs += 1
        return splice_docs(ids, bounds, repl)

    def encode_corpus_flat(
        self,
        docs: list[bytes | str],
        unk_id: int = 0,
        batch_docs: int = 16384,
        counters=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Production corpus tokenization.

        Returns (ids, bounds): document i's token ids are
        ``ids[bounds[i]:bounds[i+1]]``.  Native prep/dedup/packing, one
        walk + resolve + pack per row region on the device, one
        device-to-host copy per batch, a native stitch; up to three batches
        in flight, so host prep overlaps device work."""
        from .. import native

        self._require_units()
        c = counters or metrics.global_counters()
        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        runner = self._unit_runner()
        # cross-batch unit cache, fresh per call: later batches dispatch
        # only units never resolved before
        ucache = native.UnitCache()

        def dispatch(chunk):
            state = runner.dispatch_docs(chunk, unk_id, cache=ucache)
            return state, state[0].n_rows

        def collect(chunk, state):
            with metrics.stage("collect", c):
                ids, bounds, need, status = runner.collect_docs(state)
            if need.any():
                # timed apart from the stitch: the scalar oracle is slow
                with metrics.stage("fallback", c):
                    ids, bounds = self._patch_fallbacks(
                        chunk, ids, bounds, need, status, unk_id, c
                    )
            return ids, bounds

        out = run_pipeline(docs_b, batch_docs, dispatch, collect, c)
        c.cache_units = ucache.stats()["units"]
        return out

    def encode_batch(self, docs: list[bytes | str], unk_id: int = 0
                     ) -> list[list[int]]:
        """Per-document id lists for one batch (unique-unit path only)."""
        self._require_units()
        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        ids, bounds, need, status = self._unit_runner().encode_docs(docs_b, unk_id)
        if need.any():
            ids, bounds = self._patch_fallbacks(
                docs_b, ids, bounds, need, status, unk_id,
                metrics.global_counters(),
            )
        return [ids[bounds[i] : bounds[i + 1]].tolist()
                for i in range(len(docs_b))]

    def encode_corpus(self, *args, **kwargs):
        raise NotImplementedError(
            "encode_corpus (classic doc-row streaming path) is not ported "
            "yet; use encode_corpus_flat: " + ROADMAP_A5)

    def _classic_rows(self, *args, **kwargs):
        raise NotImplementedError(
            "classic doc-row device pass is not ported yet: " + ROADMAP_A5)

    def _encode_overflow(self, *args, **kwargs):
        raise NotImplementedError(
            "long-document chunking is not ported yet: " + ROADMAP_A5)


def run_pipeline(docs_b: list[bytes], batch_docs: int, dispatch, collect,
                 c) -> tuple[np.ndarray, np.ndarray]:
    """A corpus through a path's batches, up to three in flight, so the
    host work of one overlaps the device work of another.

    ``dispatch(chunk)`` -> (state, rows dispatched), timed as the stage
    "dispatch"; ``collect(chunk, state)`` -> the batch's flat (ids, bounds),
    timing its own stages.  Returns the corpus's flat (ids, bounds) and
    adds to the counters ``c``."""
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    inflight: list = []

    def finish(entry):
        ids, bounds = collect(*entry)
        c.tokens_out += int(bounds[-1])
        parts.append((ids, bounds))

    for chunk in _batches_by_bytes(docs_b, batch_docs):
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
    if len(parts) == 1:
        return parts[0]
    ids = np.concatenate([i for i, _b in parts] or [np.zeros(0, np.int32)],
                         dtype=np.int32)
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
