"""The pattern lexer on the card: port of blingfire_tpu/runtime/lexer_host.py
(LexerTpu, WordsTpu, WordPieceTpu, _stitch_wordpiece; its ``_pack5`` is
inside K9).

K9 (ops/lexer.py::lexer_pass_packed) runs one grammar function over a batch
of rows; this module drives whole documents through it, level by level, as
the JAX package does: level 0 tokenizes the text; a match whose action calls
a function queues its span, with the function's initial state, as a row of
the next level; the matches of all levels are then assembled bottom-up into
the reference's depth-first order (FALexTools_t.h:329-382, single-function
actions).  Spans are memoized on (initial state, remaining depth, symbols),
within a call and across calls, so each distinct document and each distinct
called span (typically a Zipf-repeated word) is walked once per memo
lifetime.  A span wider than the largest bucket runs in the scalar engine
(runtime/lexer.py).

Products: TextToWords and TextToSentences (blingfiretokdll.cpp:163-582) and
WordPiece TextToIds (:1097-1314).

Not ported, by design: the TPU's fixed launch shapes (``BUCKET_ROWS``, which
bound XLA recompiles).  A span goes to the narrowest of BUCKETS that holds
it, and a launch takes as many rows of one bucket as LAUNCH_BYTES allows;
nothing here compiles per shape.  The output does not depend on either
choice.  Entry points run on the card (``device="cuda"``) unless asked for
the CPU, where K9's plain version runs.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.consts import Iw, WBD_IGNORE_TAG, WBD_WORD_TAG, is_whitespace
from ..models.loader import Model
from ..ops import lexer as lexer_ops
from ..ops.tables import build_comb_table_cached
from . import metrics
from .host import decode_utf8
from .lexer import LexerEngine

# span widths of the launches: the longest document of the seeded 32 MiB
# corpus that chip_smoke.py runs (testing.zipf_corpus), 3,603 characters,
# fits the largest
BUCKETS = (64, 256, 1024, 4096)
LAUNCH_BYTES = 64 << 20  # rows in and planes out of one launch
MEMO_MAX = 300_000  # spans the memo keeps across calls (lexer_host.py:108)


@dataclass
class LexStats:
    """What one :meth:`LexerTpu.process_docs` call did."""

    rows: collections.Counter = field(default_factory=collections.Counter)
    launches: collections.Counter = field(default_factory=collections.Counter)
    # keys of both: (level, bucket width)
    memo_hits: int = 0  # spans found in the memo or already queued
    device_spans: int = 0  # spans walked by K9 (or its plain version)
    scalar_spans: int = 0  # spans wider than the largest bucket


class LexerTpu:
    """The pattern lexer of one [wbd] model on ``device``."""

    def __init__(self, model: Model, buckets: tuple[int, ...] = BUCKETS,
                 device: str | torch.device = "cuda"):
        if model.wbd is None:
            raise ValueError("not a [wbd] model")
        self.device = torch.device(device)
        self.model = model
        self.wbd = model.wbd
        self.engine = LexerEngine(model.wbd)  # fn2ini + the scalar path
        self.comb = build_comb_table_cached(model.wbd.aut, model.source_key,
                                            "wbd")
        self.tables = lexer_ops.make_device_tables(
            self.comb, model.wbd.aut.moore_ow, model.wbd.acts,
            model.wbd.max_token_length, device=self.device)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[0] < 1 \
                or self.buckets[-1] + 2 > lexer_ops.MAX_LEXER_ROW:
            raise ValueError(f"bucket widths 1..{lexer_ops.MAX_LEXER_ROW - 2}")
        self.max_depth = model.wbd.max_depth
        iw2iw = model.wbd.aut.iw2iw
        if iw2iw is None:
            raise ValueError("the [wbd] DFA is expected to be iw-remapped")
        self._iw2iw = iw2iw
        self._n_iws = self.comb.n_iws
        self._lanchor = int(self._map_raw(np.array([Iw.L_ANCHOR], np.int32))[0])
        self._ranchor = int(self._map_raw(np.array([Iw.R_ANCHOR], np.int32))[0])
        self._fn2ini = np.asarray(self.engine.fn2ini, np.int64)
        # span key -> its assembled (n, 3) triples, span-relative
        self._flat_cache: dict = {}
        self.last_stats = LexStats()

    def _map_raw(self, raw: np.ndarray) -> np.ndarray:
        """original iw -> dense internal iw; missing -> the n_iws sentinel
        (still ANY-fallback-able on the card), never -1 (which kills the
        lane)."""
        m = self._iw2iw
        idx = np.clip(raw, 0, len(m) - 1)
        v = np.where((raw >= 0) & (raw < len(m)), m[idx], -1)
        return np.where(v < 0, self._n_iws, v).astype(np.int32)

    def encode_chars(self, cps: np.ndarray) -> np.ndarray:
        """guard control weights, case-fold, then remap (FALexTools_t.h:259-264)."""
        guarded = np.where(cps < int(Iw.EPSILON), int(Iw.EPSILON), cps)
        if self.wbd.ignore_case:
            from .casefold import str_lower

            guarded = str_lower(guarded)
        return self._map_raw(guarded)

    # -- batched multi-level processing ------------------------------------

    def rows(self, spans, M: int):
        """(x int32 (n, M), init int32 (n,), ext_len int32 (n,)) of spans
        ``(key, seq, raw, init, rem)``: ``[L seq R -1 ...]`` rows."""
        n = len(spans)
        lens = np.fromiter((len(s[1]) for s in spans), np.int64, n)
        x = np.full((n, M), -1, np.int32)
        x[:, 0] = self._lanchor
        if lens.sum():
            r = np.repeat(np.arange(n), lens)
            first = np.cumsum(lens) - lens
            x[r, 1 + np.arange(len(r)) - np.repeat(first, lens)] = \
                np.concatenate([s[1] for s in spans])
        x[np.arange(n), lens + 1] = self._ranchor
        init = np.fromiter((s[3] for s in spans), np.int32, n)
        return x, init, (lens + 2).astype(np.int32)

    def launch(self, x, init, ext_len) -> np.ndarray:
        """K9 over rows built by :meth:`rows`: the (n, 5M) planes."""
        dev = self.device
        out = lexer_ops.lexer_pass_packed(
            self.tables, torch.from_numpy(x).to(dev),
            torch.from_numpy(init).to(dev), torch.from_numpy(ext_len).to(dev))
        return out.cpu().numpy()

    def process_docs(self, docs_cps: list[np.ndarray],
                     counters: metrics.Counters | None = None,
                     trace: list | None = None) -> list[np.ndarray]:
        """Run the full grammar over documents (code point arrays): each
        one's (n, 3) int32 triples (tag, from, to) in the reference's order
        (the JAX package returns them flattened to lists).  ``last_stats``
        gets what the call did, ``counters`` its stage seconds; ``trace``,
        when a list, gets (level, bucket, x, init, ext_len, raws) of every
        launch, ``raws`` the spans' code points."""
        c = counters or metrics.global_counters()
        st = self.last_stats = LexStats()
        cache = self._flat_cache
        if len(cache) > MEMO_MAX:
            cache.clear()
        md = self.max_depth
        # spans whose matches this call computes, in discovery order
        # (children after their parent, so reversed order assembles
        # bottom-up); value: (tags, los, his, child match index, child keys)
        span_order: list = []
        matches: dict = {}
        queued: set = set()
        doc_keys = []
        level: list[tuple] = []  # (key, seq, raw, init, rem)
        with metrics.stage("encode", c):
            n = len(docs_cps)
            raws = [np.asarray(d, np.int32) for d in docs_cps]
            lens = np.fromiter((len(r) for r in raws), np.int64, n)
            ends = np.cumsum(lens)
            allc = np.concatenate(raws) if n else np.zeros(0, np.int32)
            enc = self.encode_chars(allc)
            ini = int(self.engine.initial)
            for i in range(n):
                a, b = ends[i] - lens[i], ends[i]
                seq = enc[a:b]
                k = (ini, md - 1, seq.tobytes())
                doc_keys.append(k)
                if k in cache or k in queued:
                    st.memo_hits += 1
                else:
                    queued.add(k)
                    level.append((k, seq, allc[a:b], ini, md - 1))

        depth = 0
        while level:
            nxt: list[tuple] = []
            lens = np.fromiter((len(s[1]) for s in level), np.int64, len(level))
            which = np.searchsorted(self.buckets, lens)  # narrowest that fits
            for bi in np.unique(which):
                idxs = np.flatnonzero(which == bi)
                if bi == len(self.buckets):  # wider than every bucket
                    with metrics.stage("scalar", c):
                        for si in idxs:
                            k, _seq, raw, init, rem = level[si]
                            cache[k] = self._scalar_flat(raw, init, md - rem)
                    st.scalar_spans += len(idxs)
                    continue
                bucket = self.buckets[bi]
                M = bucket + 2
                per = max(1, LAUNCH_BYTES // (M * 4 * (1 + lexer_ops.PLANES)))
                for off in range(0, len(idxs), per):
                    part = [level[si] for si in idxs[off : off + per]]
                    with metrics.stage("pack", c):
                        x, init, elen = self.rows(part, M)
                    with metrics.stage("device", c):
                        packed = self.launch(x, init, elen)
                    if trace is not None:
                        trace.append((depth, bucket, x, init, elen,
                                      [s[2] for s in part]))
                    st.rows[(depth, bucket)] += len(part)
                    st.launches[(depth, bucket)] += 1
                    st.device_spans += len(part)
                    with metrics.stage("matches", c):
                        self._take_matches(part, packed, M, cache, queued,
                                           matches, span_order, nxt, st)
            level = nxt
            depth += 1

        with metrics.stage("assemble", c):
            self._assemble(span_order, matches, cache)
        return [cache[k] for k in doc_keys]

    def _take_matches(self, part, packed, M, cache, queued, matches,
                      span_order, nxt, st) -> None:
        """The visited matches of one launch's rows; queue the spans their
        function calls name (lexer_host.py:171-199)."""
        vis = packed[:, :M] != 0
        ks, qs = np.nonzero(vis)  # row-major: in-row match order
        tags = packed[:, M : 2 * M][ks, qs]
        los = packed[:, 2 * M : 3 * M][ks, qs]
        his = packed[:, 3 * M : 4 * M][ks, qs]
        fns = packed[:, 4 * M : 5 * M][ks, qs]
        rem = np.fromiter((s[4] for s in part), np.int64, len(part))
        nested = (fns >= 0) & (rem[ks] > 0)
        bounds = np.searchsorted(ks, np.arange(len(part) + 1))
        # the nested matches, grouped by row like the matches
        cj = np.flatnonzero(nested)
        cbounds = np.searchsorted(ks[cj], np.arange(len(part) + 1))
        cini = self._fn2ini[fns[cj]] if len(cj) else cj
        ckeys = []
        for row, lo, hi, ini in zip(ks[cj].tolist(), los[cj].tolist(),
                                    his[cj].tolist(), cini.tolist()):
            _k, seq, raw, _init, r = part[row]
            cseq = seq[lo : hi + 1]
            ck = (ini, r - 1, cseq.tobytes())
            ckeys.append(ck)
            if ck in cache or ck in queued:
                st.memo_hits += 1
            else:
                queued.add(ck)
                nxt.append((ck, cseq, raw[lo : hi + 1], ini, r - 1))
        for i, span in enumerate(part):
            a, b = bounds[i], bounds[i + 1]
            ca, cb = cbounds[i], cbounds[i + 1]
            k = span[0]
            matches[k] = (tags[a:b], los[a:b], his[a:b], cj[ca:cb] - a,
                          ckeys[ca:cb])
            span_order.append(k)

    @staticmethod
    def _assemble(span_order, matches, cache) -> None:
        """Bottom-up assembly (lexer_host.py:202-222): a span's triples are,
        match by match, its own (tag != 0) and then its child's, shifted to
        the match's start."""
        for k in reversed(span_order):
            tags, los, his, cidx, ckeys = matches[k]
            own = tags != 0
            if not ckeys:
                cache[k] = np.stack([tags[own], los[own], his[own]],
                                    axis=1).astype(np.int32)
                continue
            subs = [cache[ck] for ck in ckeys]
            clen = np.fromiter((len(s) for s in subs), np.int64, len(subs))
            per = own.astype(np.int64)
            per[cidx] += clen
            start = np.cumsum(per) - per
            out = np.empty((int(per.sum()), 3), np.int32)
            out[start[own]] = np.stack([tags[own], los[own], his[own]], 1)
            if clen.sum():
                rows = np.concatenate(subs).copy()
                shift = np.repeat(los[cidx], clen)
                rows[:, 1] += shift
                rows[:, 2] += shift
                first = np.cumsum(clen) - clen
                at = np.repeat(start[cidx] + own[cidx], clen) \
                    + np.arange(len(rows)) - np.repeat(first, clen)
                out[at] = rows
            cache[k] = out

    def _scalar_flat(self, raw: np.ndarray, init: int, depth: int) -> np.ndarray:
        """A span wider than the largest bucket: the scalar engine (emits
        flat triples already in depth-first order, span-relative)."""
        out: list[int] = []
        self.engine._process_int(
            init, 0, raw.tolist(), 0, len(raw), out, 1 << 30, depth, False
        )
        return np.asarray(out, np.int32).reshape(-1, 3)


def _end_bytes(offs: np.ndarray, n_bytes: int, to: np.ndarray) -> np.ndarray:
    """The byte offset just past character ``to`` of a decoded document."""
    nxt = np.minimum(to + 1, len(offs) - 1)
    return np.where(to + 1 < len(offs), offs[nxt], n_bytes)


def _first_non_ws(cps: np.ndarray, lo: int, hi: int) -> int:
    for i in range(lo, hi):
        if not is_whitespace(int(cps[i])):
            return i - lo
    return hi - lo


class WordsTpu:
    """Batched TextToWords / TextToSentences.

    A word or sentence is the document's own bytes between the character
    offsets of its span, so the strings equal the JAX package's
    code-point-by-code-point ones: NUL is read as a space
    (blingfiretokdll.cpp:482), and both are one byte in UTF-8."""

    def __init__(self, model: Model, **opts):
        self.lex = LexerTpu(model, **opts)

    def _run(self, docs, counters):
        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        decs = [decode_utf8(d) for d in docs_b]
        todo = [i for i, dec in enumerate(decs)
                if dec is not None and len(dec[0])]
        flats = self.lex.process_docs(
            [np.where(decs[i][0] == 0, 0x20, decs[i][0]) for i in todo],
            counters)
        return docs_b, decs, todo, flats

    def text_to_words_batch(self, docs: list[bytes | str],
                            counters: metrics.Counters | None = None
                            ) -> list[str | None]:
        docs_b, decs, todo, flats = self._run(docs, counters)
        out: list[str | None] = [None] * len(docs_b)
        for i, flat in zip(todo, flats):
            data = docs_b[i].replace(b"\x00", b" ")
            offs = decs[i][1]
            keep = flat[:, 0] != WBD_IGNORE_TAG
            starts = offs[flat[keep, 1]].tolist()
            ends = _end_bytes(offs, len(data), flat[keep, 2]).tolist()
            out[i] = b" ".join([data[a:b].replace(b" ", b"_")
                                for a, b in zip(starts, ends)]).decode("utf-8")
        for i, d in enumerate(docs_b):
            if len(d) == 0:
                out[i] = ""
        return out

    def text_to_sentences_batch(self, docs: list[bytes | str],
                                counters: metrics.Counters | None = None
                                ) -> list[str | None]:
        docs_b, decs, todo, flats = self._run(docs, counters)
        out: list[str | None] = [None] * len(docs_b)
        for i, flat in zip(todo, flats):
            data = docs_b[i].replace(b"\x00", b" ")
            cps, offs = decs[i]
            n = len(cps)
            sents = []

            def emit(frm: int, to: int) -> None:
                delta = _first_non_ws(cps, frm, to + 1)
                if delta < to + 1 - frm:
                    a = int(offs[frm + delta])
                    b = int(_end_bytes(offs, len(data), np.int64(to)))
                    sents.append(data[a:b].replace(b"\n", b" "))

            prev_end = -1
            for to in flat[:, 2].tolist():
                frm = prev_end + 1
                prev_end = to
                emit(frm, to)
            if prev_end + 1 < n:
                emit(prev_end + 1, n - 1)
            out[i] = b"\n".join(sents).decode("utf-8")
        for i, d in enumerate(docs_b):
            if len(d) == 0:
                out[i] = ""
        return out


class WordPieceTpu:
    """Batched WordPiece TextToIds (bert models) through the pattern lexer:
    the JAX package's path for a model the hybrid (runtime/wp_hybrid.py)
    cannot pack (api.py:125-128)."""

    def __init__(self, model: Model, **opts):
        self.lex = LexerTpu(model, **opts)
        self.charmap = model.wbd.charmap

    def text_to_ids_batch(self, docs: list[bytes | str], unk_id: int = 0,
                          counters: metrics.Counters | None = None
                          ) -> list[list[int]]:
        from .oracle import normalize

        docs_b = [d.encode("utf-8") if isinstance(d, str) else d for d in docs]
        seqs = []
        for d in docs_b:
            dec = decode_utf8(d)
            if dec is None or len(dec[0]) == 0 or len(dec[0]) > len(d):
                seqs.append(None)
                continue
            cps = dec[0]
            if self.charmap is not None:
                norm, _ = normalize(cps.tolist(), self.charmap)
                if len(norm) <= 0 or len(norm) > len(d):
                    seqs.append(None)
                    continue
                cps = np.asarray(norm, np.int32)
            seqs.append(cps)
        todo = [(i, s) for i, s in enumerate(seqs) if s is not None]
        flats = self.lex.process_docs([s for _, s in todo], counters)
        out: list[list[int]] = [[] for _ in docs_b]
        for (i, _s), flat in zip(todo, flats):
            out[i] = _stitch_wordpiece(flat.ravel().tolist(), unk_id)
        return out


def _stitch_wordpiece(res: list[int], unk_id: int) -> list[int]:
    """The wp id-emission loop (blingfiretokdll.cpp:1210-1311)."""
    out: list[int] = []
    i = 0
    n = len(res)
    while i < n:
        tag = res[i]
        if tag == WBD_IGNORE_TAG:
            i += 3
            continue
        if tag == WBD_WORD_TAG:
            tok_from, tok_to = res[i + 1], res[i + 2]
            j = i + 3
            num_sub = 0
            covered = False
            if j < n:
                expected = tok_from
                while j < n and res[j] > WBD_IGNORE_TAG and expected == res[j + 1]:
                    expected = res[j + 2] + 1
                    num_sub += 1
                    j += 3
                if num_sub > 0 and expected - 1 == tok_to:
                    for k in range(num_sub):
                        out.append(res[i + (k + 1) * 3])
                    covered = True
            if not covered:
                out.append(unk_id)
            i = j - 3
        i += 3
    return out
