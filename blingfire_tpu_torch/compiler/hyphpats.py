# Copy of blingfire_tpu/compiler/hyphpats.py, kept here so that this package imports nothing of the JAX package.
"""W2H hyphenation-pattern induction, selection, and model build.

Offline equivalent of the reference's syllabification toolchain
(`scripts/fa_build_pats`, driven by `ldbsrc/Makefile.gnu:453-468`):

  1. annotated dictionary entries -> Iw/Ow chains
     (``FATrWordIOTools_utf8::Str2IwOw``, FATrWordIOTools_utf8.cpp:101-186)
  2. all bounded-length suffixes, counted
     (``fa_hyph2chains`` + ``sort | uniq -c``, fa_hyph2chains.cpp:131-151)
  3. pattern induction over suffix tries with a precision threshold
     (``FAIwOwSuffArr2Patterns``, FAIwOwSuffArr2Patterns.cpp:233-467;
     "don't care" position splitting: fa_iwowsuff2pats.cpp:330-360)
  4. MPH-dict merge of same-key patterns
     (``FADictSplit`` DM_HYPH, FADictSplit.cpp:199-306)
  5. minimal sufficient subset selection over the training dictionary
     (``FASelectTrPatterns``, FASelectTrPatterns.cpp:79-360)
  6. final model: pattern keys -> Moore DFA + info multimap, packed into a
     loadable ``[w2h]`` LDB (``fa_build_dict --type=moore --raw`` pipeline,
     scripts/fa_build_dict:237-258, + Makefile.gnu:166-173 packing)

The result loads in BOTH this framework and the original reference runtime.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats.consts import Func, Param
from ..runtime.casefold import to_lower
from .mindfa import build_min_dfa
from .packers import pack_ldb, pack_moore_dfa, pack_multimap, pack_multimap_fixed

# hyphenation op codes (FAFsmConst.h:345-357)
HYPH_NO_HYPH = 0
HYPH_SIMPLE_HYPH = 1
HYPH_ADD_BEFORE = 2
HYPH_CHANGE_BEFORE = 3
HYPH_DELETE_BEFORE = 4
HYPH_CHANGE_AFTER = 5
HYPH_DEL_AND_CHANGE = 6
HYPH_DONT_CARE = 7

_INFO_BASE = 65536  # --info-base / --ow-base (scripts/fa_build_dict:252-257)


# ---------------------------------------------------------------------------
# 1. annotated entry parsing (Str2IwOw)
# ---------------------------------------------------------------------------


def _parse_action(act: str) -> int:
    """``[XX]`` action group -> op code (FATrWordIOTools_utf8.cpp:20-97)."""
    if act == "?":
        return HYPH_DONT_CARE
    symbol = 0
    is_x1 = is_x2 = is_after = False
    i = 0
    while i < len(act):
        c = act[i]
        if c == "=" and not is_after:
            is_after = True
            while i + 1 < len(act) and act[i + 1].isdigit():
                i += 1  # priority digits ignored
        elif c == "X" and symbol == 0:
            if not is_after:
                is_x1 = True
            else:
                is_x2 = True
        else:
            if symbol != 0:
                raise ValueError(f"bad action format: {act!r}")
            symbol = ord(c)
        i += 1
    if not is_x1 and not is_x2:
        if symbol == 0:
            return HYPH_SIMPLE_HYPH
        return (symbol << 4) | HYPH_ADD_BEFORE
    if is_x1 and not is_x2:
        if symbol == 0:
            return HYPH_DELETE_BEFORE
        return (symbol << 4) | HYPH_CHANGE_BEFORE
    if not is_x1 and is_x2 and symbol:
        return (symbol << 4) | HYPH_CHANGE_AFTER
    if is_x1 and is_x2 and symbol:
        return (symbol << 4) | HYPH_DEL_AND_CHANGE
    raise ValueError(f"bad action format: {act!r}")


def parse_tr_word(
    line: str,
    ignore_case: bool = False,
    charmap: dict[int, list[int]] | None = None,
) -> tuple[list[int], list[int]]:
    """``a[XX]b[YY]..c`` -> (iws, ows) (FATrWordIOTools_utf8.cpp:101-186)."""
    iws: list[int] = []
    ows: list[int] = []
    act_start = -1
    cps = [ord(c) for c in line]
    i = 0
    while i < len(cps):
        c = cps[i]
        if c == ord("[") and act_start == -1:
            act_start = i + 1
        elif c == ord("]") and act_start != -1:
            if not iws:
                raise ValueError("action group with no preceding symbol")
            if ows[-1] != HYPH_NO_HYPH:
                raise ValueError("adjacent action groups")
            ows[-1] = _parse_action("".join(chr(x) for x in cps[act_start:i]))
            act_start = -1
        elif act_start == -1:
            if ignore_case:
                c = to_lower(c)
            if charmap is not None:
                v = charmap.get(c)
                if v is not None and len(v) == 1:  # 1:1 mappings only
                    c = int(v[0])
            iws.append(c)
            ows.append(HYPH_NO_HYPH)
        i += 1
    return iws, ows


# ---------------------------------------------------------------------------
# 2. suffix chains (fa_hyph2chains semantics)
# ---------------------------------------------------------------------------


def suffix_chains(
    entries: list[tuple[list[int], list[int]]],
    min_len: int = 3,
    max_len: int = 8,
    l_anchor: int = 94,
    r_anchor: int = 94,
) -> dict[tuple[tuple[int, ...], tuple[int, ...]], int]:
    """Anchored bounded suffixes with counts (fa_hyph2chains.cpp:131-151
    + the ``sort | uniq -c`` stage). One window per start position."""
    counts: dict[tuple[tuple[int, ...], tuple[int, ...]], int] = {}
    for iws, ows in entries:
        seq = [l_anchor] + iws + [r_anchor]
        oseq = [HYPH_NO_HYPH] + ows + [HYPH_NO_HYPH]
        count = len(seq)
        for i in range(0, count - min_len + 1):
            ln = min(max_len, count - i)
            key = (tuple(seq[i : i + ln]), tuple(oseq[i : i + ln]))
            counts[key] = counts.get(key, 0) + 1
    return counts


def _chain_sort_key(iws: tuple[int, ...], ows: tuple[int, ...]) -> str:
    """The textual sort order of the reference pipeline: iws printed as
    0-padded 4-hex, ows as bare hex (fa_hyph2chains PrintSuffs +
    FAPrintUtils.cpp:580-616), sorted as byte strings."""
    return " ".join(f"{v:04x}" for v in iws) + " " + " ".join(f"{v:x}" for v in ows)


# ---------------------------------------------------------------------------
# 3. induction (FAIwOwSuffArr2Patterns)
# ---------------------------------------------------------------------------


class _Inducer:
    """Suffix-trie pattern inducer for one chunk stream.

    Faithful to FAIwOwSuffArr2Patterns.cpp: two tries grown in input order
    (iwow over interleaved symbols, iw over inputs only with a running
    best-iwow-state candidate), flushed whenever the first ``min_len``
    input weights change (HasPrefChanged, :110-132)."""

    def __init__(self, min_len: int, min_prec: float, sink):
        self.min_len = min_len
        self.min_prec = min_prec
        self.sink = sink  # callable(iws, ows, freq)
        self._clear()

    def _clear(self):
        # tries as parallel arrays: children dict per node, freq per node
        self.iwow_kids: list[dict[int, int]] = [{}]
        self.iwow_freq: list[int] = [0]
        self.iw_kids: list[dict[int, int]] = [{}]
        self.iw_freq: list[int] = [0]
        self.iw_best: list[int] = [-1]  # iw node -> best iwow node
        self.prev: tuple[int, ...] | None = None
        self.iws_alpha: set[int] = set()
        self.ows_alpha: set[int] = set()

    def _pref_changed(self, chain: tuple[int, ...]) -> bool:
        if self.prev is None:
            return False
        for i in range(0, min(2 * self.min_len, len(chain)), 2):
            if i >= len(self.prev) or chain[i] != self.prev[i]:
                return True
        return False

    def add_chain(self, chain: tuple[int, ...], freq: int) -> None:
        if self._pref_changed(chain):
            self.flush()
        # interleaved iwow trie
        node = 0
        for c in chain:
            nxt = self.iwow_kids[node].get(c)
            if nxt is None:
                nxt = len(self.iwow_kids)
                self.iwow_kids.append({})
                self.iwow_freq.append(0)
                self.iwow_kids[node][c] = nxt
            self.iwow_freq[nxt] += freq
            node = nxt
        # iw trie with best-candidate tracking (AddChain_int, :233-310)
        n1 = 0  # iwow node
        n2 = 0  # iw node
        for i in range(0, len(chain), 2):
            iw, ow = chain[i], chain[i + 1]
            n1 = self.iwow_kids[self.iwow_kids[n1][iw]][ow]
            nxt2 = self.iw_kids[n2].get(iw)
            if nxt2 is None:
                nxt2 = len(self.iw_kids)
                self.iw_kids.append({})
                self.iw_freq.append(0)
                self.iw_best.append(n1)
                self.iw_kids[n2][iw] = nxt2
                self.iw_freq[nxt2] = freq
            else:
                self.iw_freq[nxt2] += freq
                if self.iwow_freq[self.iw_best[nxt2]] < self.iwow_freq[n1]:
                    self.iw_best[nxt2] = n1
            n2 = nxt2
        self.prev = chain
        self.iws_alpha.update(chain[0::2])
        self.ows_alpha.update(chain[1::2])

    def flush(self) -> None:
        """BuildPatterns (:380-467): DFS, emit at the smallest depth where
        the best continuation meets the precision bar."""
        iws = sorted(self.iws_alpha)
        ows = sorted(self.ows_alpha)
        pat: list[tuple[int, int]] = []

        def dfs(state: int, q: int, depth: int):
            for iw in iws:
                dst = self.iwow_kids[state].get(iw)
                if dst is None:
                    continue
                p = self.iw_kids[q][iw]
                if depth + 1 >= self.min_len:
                    best = self.iw_best[p]
                    best_freq = self.iwow_freq[best]
                    all_freq = self.iw_freq[p]
                    best_ow = -1
                    if all_freq == best_freq or self.min_prec <= 100.0 * float(
                        best_freq
                    ) / float(all_freq):
                        for ow in ows:
                            if self.iwow_kids[dst].get(ow) == best:
                                best_ow = ow
                                break
                    if best_ow != -1:
                        seq = pat + [(iw, best_ow)]
                        self.sink(
                            tuple(x for x, _ in seq),
                            tuple(y for _, y in seq),
                            self.iwow_freq[best],
                        )
                        continue
                for ow in ows:
                    dd = self.iwow_kids[dst].get(ow)
                    if dd is not None:
                        pat.append((iw, ow))
                        dfs(dd, p, depth + 1)
                        pat.pop()

        dfs(0, 0, 0)
        self._clear()


def induce_patterns(
    counts: dict[tuple[tuple[int, ...], tuple[int, ...]], int],
    min_len: int = 3,
    min_prec: float = 100.0,
    min_freq: int = 1,
    no_empty: bool = False,
    dont_care: bool = False,
    max_context: int = 4,
) -> list[tuple[tuple[int, ...], tuple[int, ...], int]]:
    """Run induction over the counted suffix stream in reference order
    (fa_iwowsuff2pats.cpp:146-206 output filters, :246-391 driving)."""
    out: list[tuple[tuple[int, ...], tuple[int, ...], int]] = []

    def sink(piws, pows, freq):
        if freq < min_freq:
            return
        if dont_care and all(o == HYPH_DONT_CARE for o in pows):
            return
        if no_empty and all(o in (HYPH_NO_HYPH, HYPH_DONT_CARE) for o in pows):
            return
        out.append((piws, pows, freq))

    ordered = sorted(counts.items(), key=lambda kv: _chain_sort_key(*kv[0]))
    if dont_care:
        inducers = [
            _Inducer(max(min_len, pos + 1), min_prec, sink)
            for pos in range(max_context)
        ]
        for (iws, ows), freq in ordered:
            half = len(iws)
            for pos in range(min(max_context, half)):
                o2 = [HYPH_DONT_CARE] * half
                o2[pos] = ows[pos]
                chain = tuple(
                    x for pair in zip(iws, o2) for x in pair
                )
                inducers[pos].add_chain(chain, freq)
        for ind in inducers:
            ind.flush()
    else:
        ind = _Inducer(min_len, min_prec, sink)
        for (iws, ows), freq in ordered:
            chain = tuple(x for pair in zip(iws, ows) for x in pair)
            ind.add_chain(chain, freq)
        ind.flush()
    return out


# ---------------------------------------------------------------------------
# 4. MPH-dict merge of same-key patterns (FADictSplit DM_HYPH)
# ---------------------------------------------------------------------------


@dataclass
class PatternDict:
    """keys sorted (= MPH id order), k2i, deduplicated infos [freq, ows...]"""

    keys: list[tuple[int, ...]]
    k2i: list[int]
    infos: list[tuple[int, ...]]
    key2id: dict[tuple[int, ...], int]


def build_pattern_dict(
    pats: list[tuple[tuple[int, ...], tuple[int, ...], int]]
) -> PatternDict:
    """Merge patterns sharing an input key (FADictSplit.cpp:199-306): ows
    united per position (later entries in sorted order win on conflicts),
    frequency of the last duplicate kept, infos deduplicated."""
    by_key: dict[tuple[int, ...], list[tuple[int, ...]]] = {}
    for iws, ows, freq in pats:
        # digitized line order: key, 0, freq, ows (all fixed-width hex)
        by_key.setdefault(iws, []).append((freq,) + ows)
    keys = sorted(by_key)
    k2i: list[int] = []
    infos: list[tuple[int, ...]] = []
    info_ids: dict[tuple[int, ...], int] = {}
    for key in keys:
        entries = sorted(set(by_key[key]))
        max_pos = max(len(e) - 2 for e in entries)
        tags = [HYPH_DONT_CARE] * (max_pos + 1)
        freq = 0
        for e in entries:
            freq = e[0]
            for pos, h in enumerate(e[1:]):
                if h != HYPH_DONT_CARE:
                    tags[pos] = h
        info = (freq,) + tuple(tags)
        idx = info_ids.get(info)
        if idx is None:
            idx = len(infos)
            infos.append(info)
            info_ids[info] = idx
        k2i.append(idx)
    return PatternDict(
        keys=keys,
        k2i=k2i,
        infos=infos,
        key2id={k: i for i, k in enumerate(keys)},
    )


# ---------------------------------------------------------------------------
# 5. subset selection (FASelectTrPatterns)
# ---------------------------------------------------------------------------


def _better(pd: PatternDict, id1: int, id2: int) -> bool:
    """Pattern preference order (FASelectTrPatterns.cpp:180-230)."""
    i1 = pd.infos[pd.k2i[id1]]
    i2 = pd.infos[pd.k2i[id2]]
    f1, o1 = i1[0], i1[1:]
    f2, o2 = i2[0], i2[1:]
    if f1 > f2:
        return True
    if f1 == f2 and len(o1) < len(o2):
        return True
    if f1 == f2 and len(o1) == len(o2):
        d1 = sum(1 for o in o1 if o == HYPH_DONT_CARE)
        d2 = sum(1 for o in o2 if o == HYPH_DONT_CARE)
        if d1 < d2:
            return True
        if d1 == d2 and id1 < id2:
            return True
    return False


def select_patterns(
    entries: list[tuple[list[int], list[int]]],
    pd: PatternDict,
    no_empty: bool = False,
    take_all: bool = False,
    l_anchor: int = 94,
    r_anchor: int = 94,
):
    """Greedy sufficient-subset selection over the training dictionary.

    Returns (selected patterns [(iws, ows)], unsolved entries, conflicts);
    FASelectTrPatterns.cpp:79-360 + fa_pats_select.cpp:420-503."""
    if take_all:
        sel = [
            (k, pd.infos[pd.k2i[i]][1:]) for i, k in enumerate(pd.keys)
        ]
        return sel, [], []

    max_key_len = max((len(k) for k in pd.keys), default=0)
    used: set[int] = set()
    unsolved: list[tuple[list[int], list[int]]] = []
    conflicts: list[tuple[list[int], int]] = []

    for iws, ows in entries:
        seq = [l_anchor] + iws + [r_anchor]
        oseq = [HYPH_NO_HYPH] + ows + [HYPH_NO_HYPH]
        count = len(seq)
        # all pattern occurrences, keyed by end position (AddIwsOws :296-333)
        ends: dict[int, set[int]] = {}
        for frm in range(count):
            for ln in range(1, min(max_key_len, count - frm) + 1):
                pid = pd.key2id.get(tuple(seq[frm : frm + ln]))
                if pid is not None:
                    ends.setdefault(frm + ln - 1, set()).add(pid)
        # CalcCover (:79-163)
        tmp = [-(o + 1) for o in oseq]
        cover: dict[int, set[int]] = {}
        for i in range(count):
            for pid in sorted(ends.get(i, ())):
                pat_ows = pd.infos[pd.k2i[pid]][1:]
                align = i + 1 - len(pat_ows)
                assert align >= 0
                for k in range(align, i + 1):
                    pow_ = pat_ows[k - align]
                    if pow_ == HYPH_DONT_CARE:
                        continue
                    cover.setdefault(k, set()).add(pid)
                    if pow_ + 1 == tmp[k]:
                        pass
                    elif -(pow_ + 1) == tmp[k]:
                        tmp[k] = pow_ + 1
                    else:
                        conflicts.append((iws, k))
        if any(tmp[i] < -1 for i in range(1, count - 1)):
            unsolved.append((iws, [t for t in tmp[1:-1]]))
        # UpdateBest (:233-296)
        new_sel: list[int] = []
        for i in range(count):
            if no_empty and oseq[i] == HYPH_NO_HYPH:
                continue
            ids = cover.get(i)
            if not ids:
                continue
            if ids & used or any(x in ids for x in new_sel):
                continue
            sids = sorted(ids)
            best = sids[0]
            for pid in sids[1:]:
                if _better(pd, pid, best):
                    best = pid
            new_sel.append(best)
        used.update(new_sel)

    sel = [
        (pd.keys[i], pd.infos[pd.k2i[i]][1:]) for i in sorted(used)
    ]
    return sel, unsolved, conflicts


# ---------------------------------------------------------------------------
# 6. final model build (fa_build_dict --type=moore --raw + packing + conf)
# ---------------------------------------------------------------------------


def build_w2h_ldb(
    patterns: list[tuple[tuple[int, ...], tuple[int, ...]]],
    min_len: int = 2,
    l_anchor: int = 94,
    r_anchor: int = 94,
    charmap: dict[int, list[int]] | None = None,
    ignore_case: bool = False,
    no_hyph_len: int | None = None,
    validate: bool = True,
) -> bytes:
    """Selected patterns -> packed ``[w2h]`` LDB loadable by both runtimes.

    Keys become a Moore DFA (reaction = info id), ow chains the info
    multimap — the structures FAHyphConfKeeper binds and
    FAHyphInterpreter_core_t walks."""
    assert patterns, "no patterns to build"
    # dedup infos in first-use order over sorted keys (fa_dict_split --raw)
    patterns = sorted(set(patterns))
    infos: list[tuple[int, ...]] = []
    info_ids: dict[tuple[int, ...], int] = {}
    chains: list[tuple[int, ...]] = []
    for iws, ows in patterns:
        idx = info_ids.get(ows)
        if idx is None:
            idx = len(infos)
            infos.append(ows)
            info_ids[ows] = idx
        chains.append(iws + (_INFO_BASE + idx,))
    n_states, final_rs, edges_rs = build_min_dfa(sorted(chains))

    # rs-dfa -> moore-dfa with --ow-base (scripts/fa_build_dict:256-258):
    # a transition on iw >= base becomes "source is final, Ow = iw - base"
    state_ow = np.full(n_states, -1, np.int64)
    final = np.zeros(n_states, bool)
    edges: dict[int, list[tuple[int, int]]] = {}
    for src, es in edges_rs.items():
        for iw, dst in es:
            if iw >= _INFO_BASE:
                final[src] = True
                assert state_ow[src] in (-1, iw - _INFO_BASE)
                state_ow[src] = iw - _INFO_BASE
            else:
                edges.setdefault(src, []).append((iw, dst))

    # dense internal alphabet (--remap-iws)
    all_iws = sorted({iw for es in edges.values() for iw, _d in es})
    iw2int = {iw: k for k, iw in enumerate(all_iws)}
    edges_int = {
        s: [(iw2int[iw], d) for iw, d in es] for s, es in edges.items()
    }
    alpha: list[tuple[int, int]] = []
    for iw in all_iws:
        if alpha and iw == alpha[-1][1] + 1:
            alpha[-1] = (alpha[-1][0], iw)
        else:
            alpha.append((iw, iw))
    fsm_dump = pack_moore_dfa(
        n_states,
        final,
        edges_int,
        state_ow,
        alpha,
        [(iw, k) for iw, k in iw2int.items()],
    )
    i2h_dump = pack_multimap({i: list(ows) for i, ows in enumerate(infos)})

    stream: list[int | None] = []
    if ignore_case:
        stream += [int(Param.IGNORE_CASE)]
    stream += [int(Param.MIN_LEN), min_len]
    if no_hyph_len is not None:
        stream += [int(Param.MIN_LEN2), no_hyph_len]
    stream += [int(Param.LEFT_ANCHOR), l_anchor]
    stream += [int(Param.RIGHT_ANCHOR), r_anchor]
    stream += [int(Param.FSM), 1, int(Param.MULTI_MAP), 2]
    if charmap is not None:
        stream += [int(Param.CHARMAP), 3]
    conf = {int(Func.W2H): stream}
    if validate:
        conf[int(Func.GLOBAL)] = [int(Param.VERIFY_LDB_BIN)]
    dumps = [pack_multimap(conf), fsm_dump, i2h_dump]
    if charmap is not None:
        dumps.append(pack_multimap_fixed(charmap, size_of_value=4))
    return pack_ldb(dumps, validate=validate)


def compile_w2h_model(
    dict_lines: list[str],
    min_pat_len: int = 3,
    max_pat_len: int = 8,
    min_prec: float = 100.0,
    min_freq: int = 1,
    no_empty: bool = False,
    dont_care: bool = True,
    max_context: int = 4,
    take_all: bool = False,
    runtime_min_len: int = 2,
    l_anchor: int = 94,
    r_anchor: int = 94,
    ignore_case: bool = False,
    charmap: dict[int, list[int]] | None = None,
    validate: bool = True,
):
    """End-to-end: annotated hyphenation dictionary -> ``.bin`` bytes.

    Returns (ldb_bytes, selected_patterns, unsolved_entries)."""
    entries = [
        parse_tr_word(ln, ignore_case, charmap)
        for ln in dict_lines
        if ln.strip()
    ]
    counts = suffix_chains(entries, min_pat_len, max_pat_len, l_anchor, r_anchor)
    pats = induce_patterns(
        counts, min_pat_len, min_prec, min_freq, no_empty, dont_care, max_context
    )
    pd = build_pattern_dict(pats)
    selected, unsolved, _conf = select_patterns(
        entries, pd, no_empty, take_all, l_anchor, r_anchor
    )
    blob = build_w2h_ldb(
        selected,
        min_len=runtime_min_len,
        l_anchor=l_anchor,
        r_anchor=r_anchor,
        charmap=charmap,
        ignore_case=ignore_case,
        validate=validate,
    )
    return blob, selected, unsolved
