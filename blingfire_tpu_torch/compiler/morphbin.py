# Copy of blingfire_tpu/compiler/morphbin.py, kept here so that this package imports nothing of the JAX package.
"""Morphology model compiler: build [w2t]/[t2p]/[tt2p]/[w2b]/[tag-dict]/
[w2p]/[trs]/[wre]-style LDB sections into one .bin.

Replaces the reference's offline morphology pipeline (fa_build_dict /
fa_build_wft / fa_build_w2tp / fa_fsm2fsm_pack / fa_merge_dumps driven by
ldbsrc/Makefile.gnu) with host-side builders.  The emitted container is
readable both by this framework's ``runtime.morph.MorphLdb`` and by the
original client library keepers (FAWgConfKeeper.cpp, FATsConfKeeper.cpp,
FAWftConfKeeper.cpp, FADictConfKeeper.cpp, FAW2PConfKeeper.cpp,
FATrsConfKeeper_t.h, FAParserConfKeeper.cpp, FAWREConf_pack.cpp).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..formats.consts import (
    WRE_CONF_COUNT,
    WRE_CONF_DCT_DIG,
    WRE_CONF_FSM1,
    WRE_CONF_FSM2,
    WRE_CONF_TAG_OW_BASE,
    WRE_CONF_TOKEN_TYPE,
    WRE_CONF_TRBR,
    WRE_CONF_TXT_DIG,
    WRE_CONF_WRE_TYPE,
    WRE_TYPE_MOORE,
    Dir,
    FsmType,
    Func,
    MapMode,
    MAX_WORD_LEN,
    Param,
)
from .mindfa import assign_mph_ows, build_min_dfa
from .packers import (
    pack_array_flat,
    pack_ldb,
    pack_mealy_dfa,
    pack_moore_dfa,
    pack_moore_mdfa,
    pack_multimap,
    pack_multimap_fixed,
)


# ---------------------------------------------------------------------------
# generic automaton construction
# ---------------------------------------------------------------------------


def build_trie_mdfa(entries: dict[tuple[int, ...], list[int]]):
    """Trie over int sequences with an Ows set at each accepting state.

    Returns (n_states, final(bool[n]), edges {src: [(iw, dst)]},
    state_ows {sid: sorted ows}) in ``pack_moore_mdfa`` shape."""
    children: list[dict[int, int]] = [{}]
    final: list[bool] = [False]
    ows: dict[int, list[int]] = {}
    for seq in sorted(entries):
        s = 0
        for c in seq:
            nxt = children[s].get(int(c))
            if nxt is None:
                nxt = len(children)
                children[s][int(c)] = nxt
                children.append({})
                final.append(False)
            s = nxt
        final[s] = True
        ows[s] = sorted(int(t) for t in entries[seq])
    n = len(children)
    edges = {s: sorted(children[s].items()) for s in range(n)}
    return n, np.array(final, bool), edges, ows


def build_trie_moore(entries: dict[tuple[int, ...], int]):
    """Trie with a single Ow per accepting state, in ``pack_moore_dfa``
    shape: (n, final, edges {src: [(iw, dst)]}, state_ow int32[n])."""
    children: list[dict[int, int]] = [{}]
    final: list[bool] = [False]
    ow: list[int] = [-1]
    for seq in sorted(entries):
        s = 0
        for c in seq:
            nxt = children[s].get(int(c))
            if nxt is None:
                nxt = len(children)
                children[s][int(c)] = nxt
                children.append({})
                final.append(False)
                ow.append(-1)
            s = nxt
        final[s] = True
        ow[s] = int(entries[seq])
    n = len(children)
    edges = {s: sorted(children[s].items()) for s in range(n)}
    return n, np.array(final, bool), edges, np.array(ow, np.int32)


def _identity_alphabet(edges: dict[int, list[tuple[int, int]]]):
    """Alphabet ranges + identity iw map covering every iw used."""
    iws = sorted({iw for lst in edges.values() for iw, _ in lst})
    if not iws:
        iws = [0]
    ranges: list[tuple[int, int]] = []
    for iw in iws:
        if ranges and iw == ranges[-1][1] + 1:
            ranges[-1] = (ranges[-1][0], iw)
        else:
            ranges.append((iw, iw))
    return ranges


def _pack_mdfa(n, final, edges, ows) -> bytes:
    return pack_moore_mdfa(n, 0, final, edges, ows)


def _pack_moore(n, final, edges, state_ow) -> bytes:
    ranges = _identity_alphabet(edges)
    iws = sorted({iw for lst in edges.values() for iw, _ in lst})
    identity = [(iw, iw) for iw in iws] or [(0, 0)]
    return pack_moore_dfa(n, final, edges, state_ow, ranges, identity)


def _float_array_dump(values) -> bytes:
    arr = np.asarray(values, np.float32)
    return struct.pack("<i", len(arr)) + arr.tobytes()


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------


@dataclass
class MorphSpec:
    """Sections to compile; any subset may be present."""

    # word guessers: word -> tags (plain) or word -> (tags, int probs)
    w2t: "WgSpec | None" = None
    b2t: "WgSpec | None" = None
    w2tp: "WgSpec | None" = None
    # tag-prob tables
    t2p: list[float] | None = None  # ln P(T), indexed by tag-1
    tt2p: "TsSpec | None" = None
    # word-form transformations (suffix rules)
    w2b: "WftSpec | None" = None
    b2w: "WftSpec | None" = None
    wt2b: "WftSpec | None" = None
    b2wt: "WftSpec | None" = None
    # tag dictionary
    tag_dict: "TagDictSpec | None" = None
    # word -> prob
    w2p: "W2PSpec | None" = None
    # transformations
    trs: "TrsSpec | None" = None
    # WRE rules parser
    wre: "WreSpec | None" = None
    validate: bool = True


@dataclass
class WgSpec:
    """entries: word string/int-seq -> tag list; prob guessers append the
    quantized probs after the tags (Ows layout [tags..., iprobs...])."""

    entries: dict
    direction: int = Dir.L2R
    dict_mode: bool = False
    ignore_case: bool = False
    def_tag: int = -1
    max_len: int = -1
    no_tr: bool = False
    charmap: dict[int, list[int]] | None = None
    # prob-guesser extras
    max_prob: int = 0
    log_scale: bool = False
    prob_range: tuple[float, float] | None = None
    eos_tag: int = 0
    # append an IW_ANY delimiter arc after each word (suffix-pattern style)
    add_delim: bool = True


@dataclass
class TsSpec:
    max_tag: int
    # either dense float probs (len = max_tag**order)...
    float_probs: list[float] | None = None
    # ...or quantized ints + optional (min,max) float range
    int_probs: list[int] | None = None
    max_prob: int = 255
    prob_range: tuple[float, float] | None = None
    log_scale: bool = True


@dataclass
class WftSpec:
    """Suffix rules: list of (suffix, tags, pref_cut, pref_add, suff_cut,
    suff_add) — see SuffixRule."""

    rules: list["SuffixRule"]
    dict_mode: bool = False
    ignore_case: bool = False
    no_tr: bool = False
    charmap: dict[int, list[int]] | None = None


@dataclass
class SuffixRule:
    """One rewrite: words ending with `suffix` (the whole word when
    `whole_word`) lose suff_cut trailing and pref_cut leading characters and
    gain suff_add / pref_add (FASuffixInterpretTools_t action encoding,
    FASuffixRules2Chains.h syntax)."""

    suffix: str
    suff_cut: int
    suff_add: str = ""
    pref_cut: int = 0
    pref_add: str = ""
    tags: tuple[int, ...] = ()
    whole_word: bool = False

    def encode_action(self) -> list[int]:
        suff = [ord(c) for c in self.suff_add]
        pref = [ord(c) for c in self.pref_add]
        if not pref and not self.pref_cut:
            return [self.suff_cut] + suff
        skip = 2 + len(pref)
        return [MAX_WORD_LEN + skip, self.pref_cut] + pref + [self.suff_cut] + suff


@dataclass
class TagDictSpec:
    entries: dict  # word -> list[int] info
    ignore_case: bool = False
    no_tr: bool = False
    direction: int = Dir.L2R
    charmap: dict[int, list[int]] | None = None


@dataclass
class W2PSpec:
    entries: dict  # word -> int prob in [0, max_prob]
    max_prob: int = 255
    ignore_case: bool = False
    prob_range: tuple[float, float] = (-20.0, 0.0)
    charmap: dict[int, list[int]] | None = None


@dataclass
class TrsSpec:
    in_trs: list[int] = field(default_factory=list)  # Tr.* codes, in order
    out_trs: list[int] = field(default_factory=list)
    redup_delim: int = -1
    pref_delim: int = -1
    ucf_delim: int = -1
    prefixes: list[str] | None = None  # for Tr.PREFIX
    ignore_case: bool = False


@dataclass
class WreRule:
    """One WRE lex rule over (txt-ow, tag-ow, dct-ow) word tuples: a literal
    tuple sequence -> action (left_cx, right_cx, tag [, 0, fns...])."""

    tuples: list[tuple]
    action: list[int]
    fn_id: int | None = None  # body of _function FnId when set


@dataclass
class WreSpec:
    """Token-type-masked WRE rules; tuple elements are raw input weights fed
    per enabled channel (callers build them with tag_ow_base offsets)."""

    token_type: int
    tag_ow_base: int
    rules: list[WreRule]
    txt_dig: dict | None = None  # word-cp-seq trie -> ow (text digitizer)
    dct_arr: list[int] | None = None  # set-id -> ow
    max_depth: int = 2
    max_pass_count: int = 1
    ignore_case: bool = False


def _seq(word) -> tuple[int, ...]:
    if isinstance(word, str):
        return tuple(ord(c) for c in word)
    return tuple(int(c) for c in word)


class _Builder:
    def __init__(self):
        self.dumps: list[bytes] = [b""]  # slot 0 = conf, patched at the end
        self.conf: dict[int, list[int]] = {}

    def add_dump(self, data: bytes) -> int:
        self.dumps.append(data)
        return len(self.dumps) - 1

    def section(self, func: Func, stream: list[int]):
        self.conf[int(func)] = [int(x) for x in stream]

    def finish(self, validate: bool) -> bytes:
        if validate:
            self.conf[int(Func.GLOBAL)] = [int(Param.VERIFY_LDB_BIN)]
        self.dumps[0] = pack_multimap(self.conf)
        return pack_ldb(self.dumps, validate=validate)


def _wg_stream(b: _Builder, spec: WgSpec) -> list[int]:
    from ..formats.consts import Iw

    entries: dict[tuple[int, ...], list[int]] = {}
    for word, ows in spec.entries.items():
        seq = _seq(word)
        if spec.direction == Dir.R2L:
            seq = seq[::-1]
        if spec.add_delim:
            seq = seq + (int(Iw.ANY),)
        entries[seq] = list(ows)
    n, final, edges, ows = build_trie_mdfa(entries)
    fsm = b.add_dump(_pack_mdfa(n, final, edges, ows))

    s: list[int] = []
    if spec.no_tr:
        s += [Param.NO_TR]
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    if spec.dict_mode:
        s += [Param.DICT_MODE]
    if spec.log_scale:
        s += [Param.LOG_SCALE]
    if spec.eos_tag:
        s += [Param.EOS, spec.eos_tag]
    if spec.max_prob:
        s += [Param.MAX_PROB, spec.max_prob]
    if spec.max_len != -1:
        s += [Param.TRIM, spec.max_len]
    if spec.def_tag != -1:
        s += [Param.DEFAULT_TAG, spec.def_tag]
    if spec.direction != Dir.L2R:
        s += [Param.DIRECTION, int(spec.direction)]
    if spec.charmap is not None:
        s += [Param.CHARMAP, b.add_dump(pack_multimap_fixed(spec.charmap, 4))]
    s += [Param.FSM, fsm]
    if spec.prob_range is not None:
        s += [Param.FLOAT_ARRAY, b.add_dump(_float_array_dump(spec.prob_range))]
    return s


def _ts_stream(b: _Builder, spec: TsSpec) -> list[int]:
    s: list[int] = []
    if spec.log_scale:
        s += [Param.LOG_SCALE]
    s += [Param.MAX_PROB, spec.max_prob, Param.MAX_TAG, spec.max_tag]
    if spec.int_probs is not None:
        s += [Param.ARRAY, b.add_dump(pack_array_flat(np.asarray(spec.int_probs)))]
        if spec.prob_range is not None:
            s += [Param.FLOAT_ARRAY, b.add_dump(_float_array_dump(spec.prob_range))]
    else:
        s += [Param.FLOAT_ARRAY, b.add_dump(_float_array_dump(spec.float_probs))]
    return s


def _wft_stream(b: _Builder, spec: WftSpec) -> list[int]:
    entries: dict[tuple[int, ...], list[int]] = {}
    acts: dict[int, list[int]] = {}
    for act_id, rule in enumerate(spec.rules):
        acts[act_id] = rule.encode_action()
        key = tuple(rule.tags) + tuple(reversed(_seq(rule.suffix)))
        if rule.whole_word:
            key = key + (0,)  # the engine's delimiter Iw
        entries.setdefault(key, []).append(act_id)
    n, final, edges, ows = build_trie_mdfa(entries)
    fsm = b.add_dump(_pack_mdfa(n, final, edges, ows))
    acts_dump = b.add_dump(pack_multimap(acts))

    s: list[int] = []
    if spec.no_tr:
        s += [Param.NO_TR]
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    if spec.dict_mode:
        s += [Param.DICT_MODE]
    s += [Param.FSM, fsm, Param.MAP_MODE, int(MapMode.PACK_TRIV), Param.ACTS, acts_dump]
    if spec.charmap is not None:
        s += [Param.CHARMAP, b.add_dump(pack_multimap_fixed(spec.charmap, 4))]
    return s


def _tag_dict_stream(b: _Builder, spec: TagDictSpec) -> list[int]:
    entries = {_seq(w): list(v) for w, v in spec.entries.items()}
    chains = sorted(entries)
    n, final, edges = build_min_dfa(chains)
    mealy = assign_mph_ows(n, final, edges)
    fsm = b.add_dump(pack_mealy_dfa(n, 0, final, mealy))
    k2i = b.add_dump(pack_array_flat(np.arange(len(chains), dtype=np.int64)))
    i2info = {i: entries[c] for i, c in enumerate(chains)}
    mm = b.add_dump(pack_multimap(i2info))

    s: list[int] = []
    if spec.no_tr:
        s += [Param.NO_TR]
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    if spec.direction != Dir.L2R:
        s += [Param.DIRECTION, int(spec.direction)]
    s += [Param.FSM_TYPE, int(FsmType.MEALY_DFA), Param.FSM, fsm]
    s += [Param.ARRAY, k2i]
    s += [Param.MAP_MODE, int(MapMode.PACK_TRIV), Param.MULTI_MAP, mm]
    if spec.charmap is not None:
        s += [Param.CHARMAP, b.add_dump(pack_multimap_fixed(spec.charmap, 4))]
    return s


def _w2p_stream(b: _Builder, spec: W2PSpec) -> list[int]:
    entries = {_seq(w): int(p) for w, p in spec.entries.items()}
    n, final, edges, state_ow = build_trie_moore(entries)
    fsm = b.add_dump(_pack_moore(n, final, edges, state_ow))
    s: list[int] = []
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    s += [Param.MAX_PROB, spec.max_prob, Param.FSM, fsm]
    s += [Param.FLOAT_ARRAY, b.add_dump(_float_array_dump(spec.prob_range))]
    if spec.charmap is not None:
        s += [Param.CHARMAP, b.add_dump(pack_multimap_fixed(spec.charmap, 4))]
    return s


def _trs_stream(b: _Builder, spec: TrsSpec) -> list[int]:
    s: list[int] = []
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    if spec.redup_delim != -1:
        s += [Param.REDUP_DELIM, spec.redup_delim]
    if spec.pref_delim != -1:
        s += [Param.PREF_DELIM, spec.pref_delim]
    if spec.ucf_delim != -1:
        s += [Param.UCF_DELIM, spec.ucf_delim]
    if spec.prefixes:
        entries = {_seq(p): 0 for p in spec.prefixes}
        n, final, edges, state_ow = build_trie_moore(entries)
        s += [Param.PREF_FSM, b.add_dump(_pack_moore(n, final, edges, state_ow))]
    for t in spec.in_trs:
        s += [Param.IN_TR, int(t)]
    for t in spec.out_trs:
        s += [Param.OUT_TR, int(t)]
    return s


def _wre_conf_image(spec: WreSpec) -> tuple[bytes, dict[int, list[int]]]:
    """Pack the FAWREConf_pack image + the rule actions map."""
    from ..formats.consts import Iw

    # rules automaton: one entry per rule over per-channel iw tuples
    entries: dict[tuple[int, ...], list[int]] = {}
    acts: dict[int, list[int]] = {}
    channels = [bit for bit in (1, 2, 4) if spec.token_type & bit]
    for rid, rule in enumerate(spec.rules):
        acts[rid] = list(rule.action)
        key: list[int] = []
        if rule.fn_id is not None:
            # '$ FnId' prefix per FAParserConfKeeper::GetFnId2State
            for ch in channels:
                key.append(int(Iw.R_ANCHOR))
            for ch in channels:
                if ch == 2:
                    key.append(rule.fn_id + spec.tag_ow_base)
                else:
                    key.append(int(Iw.ANY))
        for tup in rule.tuples:
            vals = list(tup) if isinstance(tup, (tuple, list)) else [tup]
            if len(vals) != len(channels):
                raise ValueError("tuple arity must match enabled channels")
            key.extend(int(v) for v in vals)
        entries.setdefault(tuple(key), []).append(rid)
    n, final, edges, ows = build_trie_mdfa(entries)
    fsm1 = _pack_mdfa(n, final, edges, ows)

    txt_dig = b""
    if spec.txt_dig is not None:
        entries2 = {_seq(w): int(ow) for w, ow in spec.txt_dig.items()}
        n2, f2, e2, ow2 = build_trie_moore(entries2)
        txt_dig = _pack_moore(n2, f2, e2, ow2)
    dct = b""
    if spec.dct_arr is not None:
        dct = pack_array_flat(np.asarray(spec.dct_arr))

    header = [0] * WRE_CONF_COUNT
    header[WRE_CONF_WRE_TYPE] = WRE_TYPE_MOORE
    header[WRE_CONF_TOKEN_TYPE] = spec.token_type
    header[WRE_CONF_TAG_OW_BASE] = spec.tag_ow_base
    off = 4 * WRE_CONF_COUNT
    body = b""
    if txt_dig:
        header[WRE_CONF_TXT_DIG] = off + len(body)
        body += txt_dig
    if dct:
        header[WRE_CONF_DCT_DIG] = off + len(body)
        body += dct
    header[WRE_CONF_FSM1] = off + len(body)
    body += fsm1
    header[WRE_CONF_FSM2] = 0
    header[WRE_CONF_TRBR] = 0
    img = struct.pack(f"<{WRE_CONF_COUNT}i", *header) + body
    return img, acts


def _wre_stream(b: _Builder, spec: WreSpec) -> list[int]:
    img, acts = _wre_conf_image(spec)
    s: list[int] = [Param.DEPTH, spec.max_depth]
    if spec.max_pass_count != 1:
        s += [Param.MAX_PASS_COUNT, spec.max_pass_count]
    if spec.ignore_case:
        s += [Param.IGNORE_CASE]
    s += [Param.WRE_CONF, b.add_dump(img)]
    s += [Param.ACTS, b.add_dump(pack_multimap(acts))]
    return s


@dataclass
class RegexpTagsRule:
    """One all-match tagger rule: regexp (fa_lex symbol syntax, anchors ^/$
    allowed) scored (score, tag)."""

    regexp: str
    score: int
    tag: int


def compile_regexp_tags_model(
    rules: list[RegexpTagsRule],
    ignore_case: bool = False,
    validate: bool = True,
) -> bytes:
    """Build a [wbd]-section model for the all-match regexp tagger
    (FARegexpTags_t.h:25-357): multi-Moore DFA (every final keeps ALL
    matching rule ids) + 4-int actions (0, 0, score, tag), loadable by both
    ``runtime.morph.load_regexp_tags`` and the reference FAWbdConfKeeper +
    FARegexpTags_t (validated: act size == 4, 0 <= score, 0 <= tag <= MaxTag,
    contiguous act ids)."""
    from .lexfsm import ANY, build_lex_automaton
    from .lexrules import Group
    from .relex import parse_regexp

    if not rules:
        raise ValueError("no rules")
    groups = []
    for i, r in enumerate(rules):
        if r.score < 0 or r.tag < 0:
            raise ValueError("score and tag must be non-negative")
        groups.append(
            Group(key=str(i), action=[0, 0, int(r.score), int(r.tag)],
                  variants=[parse_regexp(r.regexp)])
        )
    aut = build_lex_automaton(groups, multi_ows=True)

    # original-iw alphabet + remap entries (same scheme as compile_lex_model)
    iw_entries: list[tuple[int, int]] = [(0, ANY)]
    alpha: list[tuple[int, int]] = [(0, 0)]
    for cid, ivs in enumerate(aut.class_ivs):
        if cid == ANY:
            continue
        for lo, hi in ivs:
            alpha.append((lo, hi))
            for k in range(lo, hi + 1):
                iw_entries.append((k, cid))
    alpha = sorted(alpha)
    merged: list[tuple[int, int]] = []
    for lo, hi in alpha:
        if merged and lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))

    fsm_dump = pack_moore_mdfa(
        aut.n_states,
        aut.initial,
        aut.final,
        aut.edges,
        aut.state_ows or {},
        alphabet_ranges=merged,
        iw_map_entries=iw_entries,
    )
    acts_dump = pack_multimap(
        {gid: g.action for gid, g in enumerate(groups)}
    )

    stream: list[int] = [
        Param.FSM_TYPE, int(FsmType.MOORE_MULTI_DFA),
        Param.FSM, 1,
        Param.MAP_MODE, int(MapMode.PACK_TRIV),
        Param.MULTI_MAP, 2,
        Param.MAX_TAG, max(r.tag for r in rules),
    ]
    if ignore_case:
        stream += [Param.IGNORE_CASE]
    conf = {int(Func.WBD): stream}
    if validate:
        conf[int(Func.GLOBAL)] = [int(Param.VERIFY_LDB_BIN)]
    dumps = [pack_multimap(conf), fsm_dump, acts_dump]
    return pack_ldb(dumps, validate=validate)


def compile_morph_model(spec: MorphSpec) -> bytes:
    """Build a morphology LDB .bin containing the spec's sections."""
    b = _Builder()
    if spec.trs is not None:
        b.section(Func.TRS, _trs_stream(b, spec.trs))
    for func, wg in (
        (Func.W2T, spec.w2t),
        (Func.B2T, spec.b2t),
        (Func.W2TP, spec.w2tp),
    ):
        if wg is not None:
            b.section(func, _wg_stream(b, wg))
    if spec.t2p is not None:
        b.section(
            Func.T2P,
            [Param.LOG_SCALE, Param.MAX_PROB, 255,
             Param.MAX_TAG, len(spec.t2p),
             Param.FLOAT_ARRAY, b.add_dump(_float_array_dump(spec.t2p))],
        )
    if spec.tt2p is not None:
        b.section(Func.TT2P, _ts_stream(b, spec.tt2p))
    for func, wft in (
        (Func.W2B, spec.w2b),
        (Func.B2W, spec.b2w),
        (Func.WT2B, spec.wt2b),
        (Func.B2WT, spec.b2wt),
    ):
        if wft is not None:
            b.section(func, _wft_stream(b, wft))
    if spec.tag_dict is not None:
        b.section(Func.TAG_DICT, _tag_dict_stream(b, spec.tag_dict))
    if spec.w2p is not None:
        b.section(Func.W2P, _w2p_stream(b, spec.w2p))
    if spec.wre is not None:
        b.section(Func.WRE, _wre_stream(b, spec.wre))
    return b.finish(spec.validate)
