"""W2H hyphenation: port of blingfire_tpu/runtime/hyph.py.

``HyphEngine`` is the scalar engine (FAHyphInterpreter_core_t.h:136-267),
copied.  ``HyphTpu(model, device="cuda").process_batch(words)`` hyphenates
a batch of words (code point lists) on the card through K10
(ops/hyph.py::hyph_segment_packed): each distinct word once, folded
(ignore-case), mapped through the model's 1:1 charmap and its dense
alphabet, with the anchors around it.  A word over MAX_WORD_SIZE code points gives None.

Not ported, by design: the TPU's fixed launch shape (``ROWS = 4096``) and
the single width doubled to the batch's longest word, with which one
300-character word makes every row 512 lanes wide.  A word goes to the
narrowest of BUCKETS that holds it (the last is MAX_WORD_SIZE, so one always
does).  A launch of K10 takes the rows of every bucket back to back, each
bucket a segment at its own width, as many as LAUNCH_BYTES allows
(``launch_plan``): one h2d of one buffer (``ops/hyph.py::pack_rows``), one
launch, one d2h.  The output does not depend on either choice.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.consts import Param
from ..models.loader import HyphModel, Model
from ..ops import hyph as hyph_ops
from ..ops.hyph import (HYPH_CONFLICT, HYPH_DONT_CARE, HYPH_NO_HYPH,
                        HYPH_UNKNOWN, MAX_WORD_SIZE)
from ..ops.tables import build_comb_table_cached
from . import metrics
from .oracle import TransitionIndex

# word widths of the launches; the last is always MAX_WORD_SIZE
BUCKETS = (16, 32, 64, 128, MAX_WORD_SIZE)
LAUNCH_BYTES = 64 << 20  # rows in and ops out of one launch


def launch_plan(groups) -> list[list[tuple[int, np.ndarray]]]:
    """The launches of ``groups``, [(bucket, row indices)]: [(bucket, row
    indices) of each segment] a launch, the groups' rows in order, as many
    as LAUNCH_BYTES (rows in, word lengths, ops out) allows and at least
    one a launch."""
    plan, cur, left = [], [], LAUNCH_BYTES
    for bucket, idxs in groups:
        row = 4 * (2 * bucket + 3)  # the row (M), its length, its ops (W)
        off = 0
        while off < len(idxs):
            k = min(len(idxs) - off, max(left, 0) // row)
            if not k and cur:
                plan.append(cur)
                cur, left = [], LAUNCH_BYTES
                continue
            k = max(k, 1)
            cur.append((bucket, idxs[off : off + k]))
            off += k
            left -= k * row
    if cur:
        plan.append(cur)
    return plan


class HyphEngine:
    """The scalar engine: a copy of blingfire_tpu/runtime/hyph.py:26-103."""

    def __init__(self, model: HyphModel):
        self.m = model
        self.trans = TransitionIndex(model.aut)
        self.final = model.aut.final
        self.moore_ow = model.aut.moore_ow
        self.iw2iw = model.aut.iw2iw
        p = model.params
        self.left_anchor = p.get(Param.LEFT_ANCHOR, 1)
        self.right_anchor = p.get(Param.RIGHT_ANCHOR, 2)
        self.min_pat_len = p.get(Param.MIN_LEN, 3)
        self.no_hyph_len = p.get(Param.MIN_LEN2, 0)
        self.ignore_case = bool(p.get(Param.IGNORE_CASE, 0))

    def _dest(self, state: int, raw_iw: int) -> int:
        if state < 0:
            return -1
        if self.iw2iw is not None:
            if raw_iw < 0 or raw_iw >= len(self.iw2iw):
                return -1
            iw = int(self.iw2iw[raw_iw])
            if iw == -1:
                return -1
        else:
            iw = raw_iw
        dst, _ = self.trans.step(state, iw)
        return dst

    def process(self, word: list[int]) -> list[int] | None:
        """Per-position hyphenation ops, or None on error."""
        n = len(word)
        if n > MAX_WORD_SIZE:
            return None
        seq = [self.left_anchor] + list(word) + [self.right_anchor]
        if self.ignore_case:
            # case fold before charmap (FAHyphInterpreter_core_t.h:165-170)
            from .casefold import to_lower

            for i in range(1, n + 1):
                seq[i] = to_lower(seq[i])
        if self.m.charmap is not None:
            cm = self.m.charmap
            for i in range(1, n + 1):
                v = cm.get(seq[i])
                if v is not None and len(v) == 1:
                    seq[i] = int(v[0])
        n2 = n + 2
        out = [HYPH_UNKNOWN] * n
        js = 1
        for frm in range(0, n2 - (self.min_pat_len - 1)):
            state = self.m.aut.initial
            for i in range(frm, n2):
                state = self._dest(state, seq[i])
                if state == -1:
                    break
                if state >= 0 and self.final[state]:
                    pat_id = int(self.moore_ow[state])
                    pat = self.m.i2info.get(pat_id)
                    assert pat is not None
                    je = len(pat)
                    oob = frm + len(pat) - n
                    if oob > 0:
                        je -= oob
                    for j in range(js, je):
                        ow = int(pat[j])
                        if ow == HYPH_DONT_CARE:
                            continue
                        oi = frm + j - 1
                        cur = out[oi]
                        if cur == HYPH_UNKNOWN:
                            out[oi] = ow
                        elif cur != ow:
                            out[oi] = HYPH_CONFLICT
            js = 0
        k = min(self.no_hyph_len, n)
        for i in range(k):
            out[i] = HYPH_NO_HYPH
            j = n - i - 2
            if j > 0:
                out[j] = HYPH_NO_HYPH
        return out


def render(word: list[int], ops: list[int], hyphen: int) -> str:
    """A word with ``hyphen`` after each position whose op is > NO_HYPH, NUL
    read as a space: the string WordHyphenationWithModel returns
    (blingfire_tpu/api.py:313-324)."""
    out = []
    for c, h in zip(word, ops):
        out.append(chr(0x20 if c == 0 else c))
        if h > HYPH_NO_HYPH:
            out.append(chr(hyphen))
    return "".join(out)


@dataclass
class HyphStats:
    """What one :meth:`HyphTpu.process_batch` call did."""

    words: int = 0
    unique: int = 0  # distinct words of at most MAX_WORD_SIZE
    oversize: int = 0  # words over MAX_WORD_SIZE (None)
    rows: collections.Counter = field(default_factory=collections.Counter)
    # the launches that held the bucket
    launches: collections.Counter = field(default_factory=collections.Counter)
    # keys of both: bucket width


class HyphTpu:
    """Batched hyphenation over the [w2h] section of one model on
    ``device``; its comb table is cached under the model's content key."""

    def __init__(self, model: Model, device: str | torch.device = "cuda"):
        if model.w2h is None:
            raise ValueError("not a [w2h] model")
        key, model = model.source_key, model.w2h
        self.device = torch.device(device)
        self.model = model
        self.engine = HyphEngine(model)
        self.comb = build_comb_table_cached(model.aut, key, "w2h")
        self.tables = hyph_ops.make_device_tables(
            self.comb, model.aut.moore_ow, model.i2info, model.params,
            device=self.device)
        self._sym2iw = self.comb.sym2iw
        self._n_iws = self.comb.n_iws
        eng = self.engine
        self._l_iw, self._r_iw = (int(v) for v in self._map_raw(
            np.array([eng.left_anchor, eng.right_anchor], np.int32)))
        self.last_stats = HyphStats()

    def _map_raw(self, raw: np.ndarray) -> np.ndarray:
        """raw symbol -> dense iw; a symbol outside the alphabet -> the
        n_iws sentinel, which no transition takes."""
        m = self._sym2iw
        idx = np.clip(raw, 0, len(m) - 1)
        v = np.where((raw >= 0) & (raw < len(m)), m[idx], -1)
        return np.where(v < 0, self._n_iws, v).astype(np.int32)

    def _normalize(self, cps: np.ndarray) -> np.ndarray:
        """Case fold (ignore-case models) and then the charmap's 1:1
        entries, as HyphEngine.process does, over many code points."""
        if self.engine.ignore_case:
            from .casefold import str_lower

            cps = str_lower(cps)
        cm = self.model.charmap
        if cm is not None and cm.values.shape[1] >= 1 and len(cps):
            i = np.clip(cps - cm.min_key, 0, len(cm.counts) - 1)
            one = (cps >= cm.min_key) & (cps <= cm.max_key) \
                & (cm.counts[i] == 1)
            cps = np.where(one, cm.values[i, 0], cps)
        return cps.astype(np.int32)

    def rows(self, seqs: list[np.ndarray], M: int):
        """(x int32 (n, M), word_len int32 (n,)) of mapped words:
        ``[L w R -1 ...]`` rows."""
        n = len(seqs)
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        x = np.full((n, M), -1, np.int32)
        x[:, 0] = self._l_iw
        if lens.sum():
            r = np.repeat(np.arange(n), lens)
            first = np.cumsum(lens) - lens
            x[r, 1 + np.arange(len(r)) - np.repeat(first, lens)] = \
                np.concatenate(seqs)
        x[np.arange(n), lens + 1] = self._r_iw
        return x, lens.astype(np.int32)

    def process_batch(self, words: list[list[int]],
                      counters: metrics.Counters | None = None,
                      trace: list | None = None) -> list[list[int] | None]:
        """Per-position ops of each word (a code point list), None for a
        word over MAX_WORD_SIZE.  Hyphenation is a function of the word
        alone, so each distinct word is hyphenated once a call.
        ``last_stats`` gets what the call did, ``counters`` its stage
        seconds; ``trace``, when a list, gets (bucket, x, word_len, words)
        of every segment (a bucket's rows in one launch)."""
        c = counters or metrics.global_counters()
        st = self.last_stats = HyphStats(words=len(words))
        out: list[list[int] | None] = [None] * len(words)
        with metrics.stage("dedup", c):
            uniq: dict[tuple, int] = {}
            inst = []  # word -> its distinct word, -1 oversize
            for w in words:
                key = tuple(w)
                if len(key) > MAX_WORD_SIZE:
                    inst.append(-1)
                    continue
                inst.append(uniq.setdefault(key, len(uniq)))
            st.oversize = inst.count(-1)
            st.unique = len(uniq)
            if not uniq:
                return out
            uwords = list(uniq)
            lens = np.fromiter((len(w) for w in uwords), np.int64, len(uwords))
        with metrics.stage("map", c):
            flat = np.fromiter((v for w in uwords for v in w), np.int64,
                               int(lens.sum()))
            enc = self._map_raw(self._normalize(flat))
            cuts = np.cumsum(lens)
            seqs = np.split(enc, cuts[:-1])
        results: list = [None] * len(uwords)
        assert BUCKETS[-1] == MAX_WORD_SIZE
        which = np.searchsorted(BUCKETS, lens)  # narrowest that fits
        for launch in launch_plan([(BUCKETS[bi], np.flatnonzero(which == bi))
                                   for bi in np.unique(which)]):
            with metrics.stage("pack", c):
                segs = [(bucket, part,
                         *self.rows([seqs[u] for u in part], bucket + 2))
                        for bucket, part in launch]
                buf, packed = hyph_ops.pack_rows([(x, wl) for _b, _p, x, wl
                                                  in segs])
            with metrics.stage("device", c):
                flat = hyph_ops.hyph_segment_packed(
                    self.tables, torch.from_numpy(buf).to(self.device),
                    packed).cpu().numpy()
            for (bucket, part, x, wl), ops in zip(segs, packed.split(flat)):
                if trace is not None:
                    trace.append((bucket, x, wl, [uwords[u] for u in part]))
                st.rows[bucket] += len(part)
                st.launches[bucket] += 1
                with metrics.stage("unpack", c):
                    for k, u in enumerate(part.tolist()):
                        results[u] = ops[k, : wl[k]].tolist()
        with metrics.stage("scatter", c):
            for i, u in enumerate(inst):
                if u >= 0:
                    out[i] = results[u]
        return out
