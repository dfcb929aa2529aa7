# Copy of blingfire_tpu/runtime/morph.py, kept here so that this package imports nothing of the JAX package.
"""Morphology runtime: the reference client library's legacy engines.

Word guessers (P(T|W)), HMM POS tagging, tag dictionaries, word->prob,
regexp taggers, suffix-rule stemming, WRE parsing — everything
``FAMorphLDB_t_packaged`` exposes (reference headers:
blingfireclient.library/inc/FAWordGuesser_t.h, FAWordGuesser_prob_t.h,
FAHmmTagger_l1.{h,cpp}, FADictInterpreter_t.h, FAWordToProb_t.h,
FARegexpTags_t.h, FASuffixInterpretTools_t.h, FAStemmer_t.h,
FAWreLexTools_t.h, FADigitizer_t.h, FADigitizer_dct_t.h, FAT2PTable.h,
FATs2PTable.h, FAMorphLDB_t_packaged.h; conf keepers:
src/FAWgConfKeeper.cpp, FATsConfKeeper.cpp, FAW2PConfKeeper.cpp,
FAWftConfKeeper.cpp, FAParserConfKeeper.cpp, FAWREConf_pack.cpp,
FATrsConfKeeper_t.h).

These run host-side: the unit of work is one word or one tagged sentence,
the automata are kilobytes, and lookups happen at corpus-preparation
granularity — not in the device tokenization hot path.  All engines operate
on densified automata (flat NumPy tables), not on packed byte offsets.

Float scoring uses float32 throughout to stay bit-compatible with the
reference's ``float`` arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..formats.consts import (
    MAX_LOG_PROB,
    MIN_LOG_PROB,
    MAX_WORD_LEN,
    WRE_CONF_DCT_DIG,
    WRE_CONF_FSM1,
    WRE_CONF_FSM2,
    WRE_CONF_TAG_OW_BASE,
    WRE_CONF_TOKEN_TYPE,
    WRE_CONF_TRBR,
    WRE_CONF_TXT_DIG,
    WRE_CONF_WRE_TYPE,
    WRE_TT_DCTS,
    WRE_TT_TAGS,
    WRE_TT_TEXT,
    WRE_TYPE_MEALY,
    WRE_TYPE_MOORE,
    Dir,
    FsmType,
    Func,
    Iw,
    MapMode,
    Param,
    Tr,
)
from ..formats.dfa import DenseAutomaton, PackedDfaImage, densify_automaton
from ..formats.ldb import LdbContainer
from ..formats.packed import ArrayPack, MultiMapPack, read_i32
from ..models.loader import CharMap, _load_charmap
from .casefold import to_lower
from .oracle import normalize as _fa_normalize
from . import transforms as tr_mod

F32 = np.float32

_TMP_BUFF = 2 * MAX_WORD_LEN  # engines' on-stack scratch size (Ty[600])


# ---------------------------------------------------------------------------
# dense-automaton walker
# ---------------------------------------------------------------------------


class DfaWalker:
    """Scalar (state, iw) stepping over a DenseAutomaton, with the packed
    reader's iw-remap and reaction semantics."""

    def __init__(self, aut: DenseAutomaton):
        self.aut = aut
        order = np.lexsort((aut.edge_iw, aut.edge_src))
        self._src = aut.edge_src[order]
        self._iw = aut.edge_iw[order]
        self._dst = aut.edge_dst[order]
        self._ow = aut.edge_ow[order]
        self._row = np.searchsorted(self._src, np.arange(aut.n_states + 1))
        self.initial = aut.initial
        self._iw2iw = aut.iw2iw

    def get_dest(self, state: int, iw: int) -> int:
        if state < 0:
            return -1
        if self._iw2iw is not None:
            if iw < 0 or iw >= len(self._iw2iw):
                return -1
            iw = int(self._iw2iw[iw])
            if iw < 0:
                return -1
        lo, hi = self._row[state], self._row[state + 1]
        i = lo + int(np.searchsorted(self._iw[lo:hi], iw))
        if i < hi and self._iw[i] == iw:
            d = int(self._dst[i])
            return -1 if d < 0 else d
        return -1

    def get_dest_ow(self, state: int, iw: int) -> tuple[int, int]:
        if state < 0:
            return -1, 0
        lo, hi = self._row[state], self._row[state + 1]
        i = lo + int(np.searchsorted(self._iw[lo:hi], iw))
        if i < hi and self._iw[i] == iw:
            d = int(self._dst[i])
            if d < 0:
                return -1, 0
            return d, int(self._ow[i])
        return -1, 0

    def is_final(self, state: int) -> bool:
        return state >= 0 and bool(self.aut.final[state])

    def get_ow(self, state: int) -> int:
        if state < 0:
            return -1
        return int(self.aut.moore_ow[state])

    def get_ows(self, state: int) -> list[int]:
        if state < 0 or self.aut.ows_ptr is None:
            return []
        lo, hi = int(self.aut.ows_ptr[state]), int(self.aut.ows_ptr[state + 1])
        return [int(v) for v in self.aut.ows_val[lo:hi]]

    @property
    def max_ows_count(self) -> int:
        if self.aut.ows_ptr is None:
            return 0
        return int(np.max(np.diff(self.aut.ows_ptr))) if self.aut.n_states else 0


# ---------------------------------------------------------------------------
# shared word normalization (case fold -> charmap -> transform)
# ---------------------------------------------------------------------------


def _normalize_word(
    word: list[int],
    ignore_case: bool,
    charmap: CharMap | None,
    in_tr,
    max_buff: int = _TMP_BUFF,
) -> list[int]:
    """The engines' shared pre-walk pipeline (FAWordGuesser_t.h:201-225,
    FADictInterpreter_t.h:230-263, FASuffixInterpretTools_t.h:525-555).

    Buffer-limit semantics are preserved: charmap expansion overflowing the
    reference's fixed buffers yields an empty word (FANormalizeWord returns
    0); a transform result that overflows is ignored."""
    cur = word
    in_tmp = False
    if ignore_case:
        cur = [to_lower(c) for c in cur]
        in_tmp = True
    if charmap is not None:
        # FANormalizeWord: inputs longer than MaxWordLen fail; when applied
        # in-place (after case folding) the bounce buffer is MaxWordLen long
        limit = MAX_WORD_LEN if in_tmp else max_buff
        if 0 < len(cur) <= MAX_WORD_LEN:
            out, _ = _fa_normalize(cur, charmap)
            cur = out if len(out) <= limit else []
        else:
            cur = []
        in_tmp = True
    if in_tr is not None:
        out = in_tr(cur)
        if out is not None and 0 < len(out) <= max_buff:
            cur = out
    return cur


# ---------------------------------------------------------------------------
# conf keepers
# ---------------------------------------------------------------------------


def _dump_image(ldb: LdbContainer, num: int) -> PackedDfaImage:
    return PackedDfaImage(ldb.image, ldb.dump(num))


@dataclass
class WgConf:
    """[w2t]/[b2t]/[w2tp*] word-guesser section (FAWgConfKeeper.cpp:46-168)."""

    dfa: DfaWalker | None = None
    direction: int = Dir.L2R
    max_len: int = -1
    def_tag: int = -1
    no_tr: bool = False
    dict_mode: bool = False
    ignore_case: bool = False
    max_prob: int = 0
    charmap: CharMap | None = None
    min_prob_val: float = 0.0
    max_prob_val: float = 0.0
    log_scale: bool = False
    eos_tag: int = 0
    order: int = -1

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "WgConf":
        conf = cls()
        vals = list(values)
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.NO_TR:
                conf.no_tr = True
            elif p == Param.EOS:
                i += 1
                conf.eos_tag = int(vals[i])
            elif p == Param.ORDER:
                i += 1
                conf.order = int(vals[i])
            elif p == Param.LOG_SCALE:
                conf.log_scale = True
            elif p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.DICT_MODE:
                conf.dict_mode = True
            elif p == Param.MAX_PROB:
                i += 1
                conf.max_prob = int(vals[i])
            elif p == Param.TRIM:
                i += 1
                conf.max_len = int(vals[i])
            elif p == Param.DEFAULT_TAG:
                i += 1
                conf.def_tag = int(vals[i])
            elif p == Param.DIRECTION:
                i += 1
                conf.direction = int(vals[i])
            elif p == Param.CHARMAP:
                i += 1
                conf.charmap = _load_charmap(ldb, int(vals[i]))
            elif p == Param.FSM:
                i += 1
                img = _dump_image(ldb, int(vals[i]))
                conf.dfa = DfaWalker(densify_automaton(img, multi_moore=True))
            elif p == Param.FLOAT_ARRAY:
                i += 1
                off = ldb.dump(int(vals[i]))
                n = read_i32(ldb.image, off)
                arr = np.frombuffer(ldb.image, "<f4", n, off + 4)
                conf.min_prob_val = float(arr[0])
                conf.max_prob_val = float(arr[1])
            else:
                raise ValueError(f"unknown [wg] param {p}")
            i += 1
        return conf


@dataclass
class TsConf:
    """[t2p]/[tt2p]/[ttt2p] tag-prob section (FATsConfKeeper.cpp:37-100)."""

    log_scale: bool = False
    max_prob: int = 0
    max_tag: int = 0
    arr: np.ndarray | None = None  # quantized int probs (FAArray_pack)
    float_arr: np.ndarray | None = None

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "TsConf":
        conf = cls()
        vals = list(values)
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.LOG_SCALE:
                conf.log_scale = True
            elif p == Param.MAX_PROB:
                i += 1
                conf.max_prob = int(vals[i])
            elif p == Param.MAX_TAG:
                i += 1
                conf.max_tag = int(vals[i])
            elif p == Param.ARRAY:
                i += 1
                conf.arr = ArrayPack(ldb.image, ldb.dump(int(vals[i]))).densify()
            elif p == Param.FLOAT_ARRAY:
                i += 1
                off = ldb.dump(int(vals[i]))
                n = read_i32(ldb.image, off)
                conf.float_arr = np.frombuffer(ldb.image, "<f4", n, off + 4).copy()
            else:
                raise ValueError(f"unknown [ts] param {p}")
            i += 1
        return conf


@dataclass
class W2PConf:
    """[w2p] word-prob section (FAW2PConfKeeper.cpp:38-118)."""

    dfa: DfaWalker | None = None  # Moore DFA (trailing Ow = int prob)
    ignore_case: bool = False
    max_prob: int = 0
    charmap: CharMap | None = None
    min_prob_val: float = 0.0
    max_prob_val: float = 1.0

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "W2PConf":
        conf = cls()
        vals = list(values)
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.MAX_PROB:
                i += 1
                conf.max_prob = int(vals[i])
            elif p == Param.CHARMAP:
                i += 1
                conf.charmap = _load_charmap(ldb, int(vals[i]))
            elif p == Param.FSM:
                i += 1
                conf.dfa = DfaWalker(densify_automaton(_dump_image(ldb, int(vals[i]))))
            elif p == Param.FLOAT_ARRAY:
                i += 1
                off = ldb.dump(int(vals[i]))
                arr = np.frombuffer(ldb.image, "<f4", 2, off + 4)
                conf.min_prob_val = float(arr[0])
                conf.max_prob_val = float(arr[1])
            else:
                raise ValueError(f"unknown [w2p] param {p}")
            i += 1
        return conf


@dataclass
class WftConf:
    """[w2b]/[b2w]/[wt2b]/[b2wt]/[w2v] word-form-transformation section
    (FAWftConfKeeper.cpp:45-166)."""

    dfa: DfaWalker | None = None  # multi-Moore suffix DFA
    acts: MultiMapPack | None = None
    charmap: CharMap | None = None
    no_tr: bool = False
    dict_mode: bool = False
    ignore_case: bool = False
    use_nfst: bool = False

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "WftConf":
        conf = cls()
        vals = list(values)
        map_mode = MapMode.PACK_TRIV
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.NO_TR:
                conf.no_tr = True
            elif p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.USE_NFST:
                conf.use_nfst = True
            elif p == Param.DICT_MODE:
                conf.dict_mode = True
            elif p == Param.FSM:
                i += 1
                img = _dump_image(ldb, int(vals[i]))
                conf.dfa = DfaWalker(densify_automaton(img, multi_moore=True))
            elif p == Param.MAP_MODE:
                i += 1
                map_mode = int(vals[i])
                if map_mode != MapMode.PACK_TRIV:
                    raise NotImplementedError("MPH-packed action maps")
            elif p == Param.CHARMAP:
                i += 1
                conf.charmap = _load_charmap(ldb, int(vals[i]))
            elif p == Param.ACTS:
                i += 1
                conf.acts = MultiMapPack(ldb.image, ldb.dump(int(vals[i])))
            else:
                raise ValueError(f"unknown [wft] param {p}")
            i += 1
        return conf


@dataclass
class TrsConf:
    """[trs] transformations section (FATrsConfKeeper_t.h:219-365)."""

    in_tr: object | None = None
    out_tr: object | None = None
    ignore_case: bool = False

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "TrsConf":
        conf = cls()
        vals = list(values)
        redup_delim = pref_delim = ucf_delim = -1
        pref_dfa: DfaWalker | None = None
        in_types: list[int] = []
        out_types: list[int] = []
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.REDUP_DELIM:
                i += 1
                redup_delim = int(vals[i])
            elif p == Param.PREF_DELIM:
                i += 1
                pref_delim = int(vals[i])
            elif p == Param.UCF_DELIM:
                i += 1
                ucf_delim = int(vals[i])
            elif p == Param.PREF_FSM:
                i += 1
                pref_dfa = DfaWalker(densify_automaton(_dump_image(ldb, int(vals[i]))))
            elif p == Param.IN_TR:
                i += 1
                in_types.append(int(vals[i]))
            elif p == Param.OUT_TR:
                i += 1
                out_types.append(int(vals[i]))
            else:
                raise ValueError(f"unknown [trs] param {p}")
            i += 1

        def build(tr_type: int):
            if tr_type == Tr.HYPH_REDUP:
                return tr_mod.HyphRedup(
                    redup_delim if redup_delim != -1 else tr_mod.DEF_REDUP_DELIM
                )
            if tr_type == Tr.HYPH_REDUP_REV:
                return tr_mod.HyphRedupRev(
                    redup_delim if redup_delim != -1 else tr_mod.DEF_REDUP_DELIM
                )
            if tr_type == Tr.PREFIX:
                return tr_mod.Prefix(
                    pref_dfa, pref_delim if pref_delim != -1 else tr_mod.DEF_PREF_DELIM
                )
            if tr_type == Tr.PREFIX_REV:
                return tr_mod.PrefixRev(
                    pref_delim if pref_delim != -1 else tr_mod.DEF_PREF_DELIM
                )
            if tr_type == Tr.UCF:
                return tr_mod.Capital(
                    ucf_delim if ucf_delim != -1 else tr_mod.DEF_UCF_DELIM
                )
            if tr_type == Tr.UCF_REV:
                return tr_mod.CapitalRev(
                    ucf_delim if ucf_delim != -1 else tr_mod.DEF_UCF_DELIM
                )
            raise ValueError(f"unknown transformation type {tr_type}")

        if in_types:
            trs = [build(t) for t in in_types]
            conf.in_tr = trs[0] if len(trs) == 1 else tr_mod.Cascade(trs)
        if out_types:
            trs = [build(t) for t in out_types]
            conf.out_tr = trs[0] if len(trs) == 1 else tr_mod.Cascade(trs)
        return conf


@dataclass
class TagDictConf:
    """[tag-dict] section: the FADictConfKeeper fields the dictionary
    interpreter needs (FADictConfKeeper.cpp:59-230)."""

    fsm_type: int = FsmType.MEALY_DFA
    dfa: DfaWalker | None = None  # Mealy (MPH) or Moore
    k2i: np.ndarray | None = None
    i2info: MultiMapPack | None = None
    charmap: CharMap | None = None
    direction: int = Dir.L2R
    ignore_case: bool = False
    no_tr: bool = False

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "TagDictConf":
        from ..formats.packed import MultiMapPackFixed

        conf = cls()
        vals = list(values)
        fsm_dump = None
        mm_dump = None
        map_mode = MapMode.PACK_TRIV
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.FSM_TYPE:
                i += 1
                conf.fsm_type = int(vals[i])
            elif p == Param.FSM:
                i += 1
                fsm_dump = int(vals[i])
            elif p == Param.ARRAY:
                i += 1
                conf.k2i = ArrayPack(ldb.image, ldb.dump(int(vals[i]))).densify()
            elif p == Param.MULTI_MAP:
                i += 1
                mm_dump = int(vals[i])
            elif p == Param.MAP_MODE:
                i += 1
                map_mode = int(vals[i])
            elif p == Param.CHARMAP:
                i += 1
                conf.charmap = _load_charmap(ldb, int(vals[i]))
            elif p == Param.DIRECTION:
                i += 1
                conf.direction = int(vals[i])
            elif p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.NO_TR:
                conf.no_tr = True
            elif p in (Param.TOKENIZATION_TYPE, Param.ID_OFFSET):
                i += 1  # tokenizer-only parameters, value slot present
            elif p == Param.USE_BYTE_ENCODING or p == Param.NO_DUMMY_PREFIX:
                pass
            else:
                raise ValueError(f"unknown [tag-dict] param {p}")
            i += 1
        if mm_dump is not None:
            klass = MultiMapPackFixed if map_mode == MapMode.PACK_FIXED else MultiMapPack
            conf.i2info = klass(ldb.image, ldb.dump(mm_dump))
        if fsm_dump is not None:
            img = _dump_image(ldb, fsm_dump)
            conf.dfa = DfaWalker(
                densify_automaton(img, mealy=conf.fsm_type == FsmType.MEALY_DFA)
            )
        return conf


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


class WordGuesser:
    """Word -> tag set via the deepest suffix-automaton state
    (FAWordGuesser_t.h:188-331)."""

    def __init__(self, conf: WgConf, in_tr=None):
        self.conf = conf
        self.in_tr = None if conf.no_tr else in_tr
        self.max_len = conf.max_len if conf.max_len != -1 else MAX_WORD_LEN
        self.ready = conf.dfa is not None and conf.dfa.max_ows_count > 0

    def _deepest_state(self, word: list[int]) -> int:
        conf = self.conf
        dfa = conf.dfa
        cur = _normalize_word(word, conf.ignore_case, conf.charmap, self.in_tr)
        n = len(cur)
        size = min(n, self.max_len)
        state = dfa.initial
        if not conf.dict_mode:
            dst = state
            for pos in range(size):
                c = cur[n - pos - 1] if conf.direction == Dir.R2L else cur[pos]
                dst = dfa.get_dest(state, c)
                if dst == -1:
                    break
                state = dst
            if dst != -1:
                dst = dfa.get_dest(state, Iw.ANY)
            if dst != -1:
                state = dst
            return state
        for pos in range(size):
            if state == -1:
                break
            c = cur[n - pos - 1] if conf.direction == Dir.R2L else cur[pos]
            state = dfa.get_dest(state, c)
        if state != -1:
            state = dfa.get_dest(state, Iw.ANY)
        return state

    def process(self, word: list[int]) -> list[int] | None:
        """Tag array, or None on error (the reference's -1)."""
        if not self.ready:
            return None
        if len(word) != 0:
            state = self._deepest_state(word)
            if state != -1:
                ows = self.conf.dfa.get_ows(state)
                if ows:
                    return ows
        if self.conf.def_tag != -1:
            return [self.conf.def_tag]
        return None


class WordGuesserProb(WordGuesser):
    """Word -> (tags, ln P(T|W)) pairs (FAWordGuesser_prob_t.h:129-345).
    The guessed Ows array is [tags..., int-probs...] of even length."""

    def __init__(self, conf: WgConf, in_tr=None):
        super().__init__(conf, in_tr)
        self.i2p: np.ndarray | None = None
        m = conf.max_prob
        if m > 0:
            i2p = np.empty(m + 1, F32)
            mn, mx = F32(conf.min_prob_val), F32(conf.max_prob_val)
            if mx > mn:
                for i in range(m + 1):
                    v = (F32(i) / F32(m)) * (mx - mn) + mn
                    if not conf.log_scale:
                        v = F32(math.log(float(v))) if v > 0 else F32(MIN_LOG_PROB)
                    i2p[i] = v
            else:
                i2p[0] = F32(MIN_LOG_PROB)
                for i in range(1, m + 1):
                    i2p[i] = F32(math.log(float(F32(i) / F32(m))))
            self.i2p = i2p

    def process_probs(self, word: list[int]):
        """(tags, log-probs float32) or None; ([def_tag], [0.0]) fallback."""
        ows = super().process(word)
        if ows is None:
            return None
        if len(ows) >= 2:
            count = len(ows) >> 1
            tags = ows[:count]
            probs = np.array(
                [self.i2p[p] for p in ows[count:]], F32
            )
            return tags, probs
        return ows, np.array([MAX_LOG_PROB], F32)


class T2PTable:
    """ln P(T) lookup (FAT2PTable.{h,cpp})."""

    def __init__(self, conf: TsConf):
        if conf.float_arr is None or len(conf.float_arr) == 0:
            raise ValueError("[t2p] requires a float array")
        self.arr = conf.float_arr.astype(F32)

    def get_prob(self, tag: int) -> float:
        return float(self.arr[tag - 1])


class Ts2PTable:
    """ln P(T2|T1) / ln P(T3|T1,T2) lookup (FATs2PTable.{h,cpp})."""

    def __init__(self, conf: TsConf):
        self.max_tag = conf.max_tag
        self.arr = conf.arr
        self.float_arr = (
            conf.float_arr.astype(F32) if conf.float_arr is not None else None
        )
        self.i2p: np.ndarray | None = None
        if self.arr is not None:
            mn, mx = F32(MIN_LOG_PROB), F32(MAX_LOG_PROB)
            if not conf.log_scale:
                mn, mx = F32(0.0), F32(1.0)
            if self.float_arr is not None and len(self.float_arr) == 2:
                mn, mx = self.float_arr[0], self.float_arr[1]
            m = conf.max_prob
            i2p = np.empty(m + 1, F32)
            for i in range(m + 1):
                v = (F32(i) / F32(m)) * (mx - mn) + mn
                if not conf.log_scale:
                    v = F32(MIN_LOG_PROB) if v == 0.0 else F32(math.log(float(v)))
                i2p[i] = v
            self.i2p = i2p

    def _lookup(self, idx: int) -> float:
        if self.arr is None:
            fa = self.float_arr
            if fa is None or idx < 0 or idx >= len(fa):
                return float(F32(MIN_LOG_PROB))
            return float(fa[idx])
        if idx < 0 or idx >= len(self.arr):
            return float(F32(MIN_LOG_PROB))
        return float(self.i2p[int(self.arr[idx])])

    def get_prob2(self, t1: int, t2: int) -> float:
        return self._lookup(self.max_tag * (t1 - 1) + (t2 - 1))

    def get_prob3(self, t1: int, t2: int, t3: int) -> float:
        mt = self.max_tag
        return self._lookup(mt * mt * (t1 - 1) + mt * (t2 - 1) + (t3 - 1))


class HmmTaggerL1:
    """1-best first-order HMM POS tagger (FAHmmTagger_l1.cpp:44-344).

    Viterbi over per-word tag candidates from the P(T|W) guesser, with
    lexical scores rescaled by -ln P(T) and bigram transition scores."""

    def __init__(
        self,
        w2tp: WordGuesserProb,
        pt: T2PTable,
        ptt: Ts2PTable,
        eos_tag: int,
    ):
        self.w2tp = w2tp
        self.pt = pt
        self.ptt = ptt
        self.eos_tag = eos_tag
        self._reset()

    def _reset(self):
        self._tags: list[int] = [self.eos_tag]
        self._probs: list[F32] = [F32(0.0)]
        self._counts: list[int] = [1]

    def add_word(self, word: list[int]) -> None:
        got = self.w2tp.process_probs(word)
        if got is None:
            raise ValueError("guesser returned error for word")
        tags, probs = got
        for t, p in zip(tags, probs):
            self._tags.append(t)
            self._probs.append(F32(p) - F32(self.pt.get_prob(t)))
        self._counts.append(self._counts[-1] + len(tags))

    def process(self) -> list[int]:
        """Decode and reset; returns one tag per added word."""
        n_words = len(self._counts)
        if n_words <= 1:
            return []
        # EOS word
        self._tags.append(self.eos_tag)
        self._probs.append(F32(0.0))
        self._counts.append(self._counts[-1] + 1)
        n_words += 1

        tags, probs, counts = self._tags, self._probs, self._counts
        total = counts[-1]
        back = [0] * total
        back[0] = -1

        prev_lo, prev_hi = 0, 1
        for i in range(1, n_words):
            lo, hi = counts[i - 1], counts[i]
            for k in range(lo, hi):
                cur_tag = tags[k]
                best_j = prev_lo
                best = probs[prev_lo] + F32(
                    self.ptt.get_prob2(tags[prev_lo], cur_tag)
                )
                for j in range(prev_lo + 1, prev_hi):
                    pj = probs[j]
                    if best < pj:
                        cand = pj + F32(self.ptt.get_prob2(tags[j], cur_tag))
                        if best < cand:
                            best = cand
                            best_j = j
                probs[k] = probs[k] + best
                back[k] = best_j
            prev_lo, prev_hi = lo, hi

        out_size = n_words - 2
        out = [0] * out_size
        idx = back[total - 1]
        for j in range(out_size - 1, -1, -1):
            out[j] = tags[idx]
            idx = back[idx]
        self._reset()
        return out

    def tag(self, words: list[list[int]]) -> list[int]:
        for w in words:
            self.add_word(w)
        return self.process()


class DictInterpreter:
    """Word -> info-id -> info array (FADictInterpreter_t.h:155-426)."""

    def __init__(self, conf: TagDictConf, in_tr=None):
        self.conf = conf
        self.in_tr = None if conf.no_tr else in_tr
        if conf.fsm_type == FsmType.MEALY_DFA:
            self.ready = (
                conf.dfa is not None and conf.k2i is not None and conf.i2info is not None
            )
        else:
            self.ready = conf.dfa is not None and conf.i2info is not None
        self._no_norm = (
            self.in_tr is None
            and not conf.ignore_case
            and conf.direction == Dir.L2R
            and conf.charmap is None
        )

    def _normalize(self, word: list[int]) -> list[int]:
        conf = self.conf
        cur = _normalize_word(
            word, conf.ignore_case, conf.charmap, self.in_tr,
            max_buff=MAX_WORD_LEN + MAX_WORD_LEN,
        )
        if conf.direction == Dir.R2L:
            cur = cur[::-1]
        return cur

    def get_info_id(self, word: list[int]) -> int:
        conf = self.conf
        if not (0 < len(word) <= MAX_WORD_LEN) or not self.ready:
            return -1
        cur = word if self._no_norm else self._normalize(word)
        dfa = conf.dfa
        state = dfa.initial
        if conf.fsm_type == FsmType.MOORE_DFA:
            for c in cur:
                state = dfa.get_dest(state, c)
                if state == -1:
                    return -1
            return dfa.get_ow(state)
        k = 0
        for c in cur:
            state, ow = dfa.get_dest_ow(state, c)
            if state == -1:
                return -1
            k += ow
        if not dfa.is_final(state):
            return -1
        if k < 0 or k >= len(conf.k2i):
            return -1
        return int(conf.k2i[k])

    def get_info(self, word: list[int]) -> list[int] | None:
        info_id = self.get_info_id(word)
        if info_id == -1:
            return None
        return self.get_info_by_id(info_id)

    def get_info_by_id(self, info_id: int) -> list[int] | None:
        if not self.ready:
            return None
        vals = self.conf.i2info.get(info_id)
        return None if vals is None else [int(v) for v in vals]


class WordToProb:
    """Word -> ln P(W) via a Moore DFA with quantized probs
    (FAWordToProb_t.h:139-273)."""

    UNFOUND = 2.0 * MIN_LOG_PROB

    def __init__(self, conf: W2PConf, in_tr=None):
        self.conf = conf
        self.in_tr = in_tr
        self.i2p: np.ndarray | None = None
        m = conf.max_prob
        if m > 0:
            mn, mx = F32(conf.min_prob_val), F32(conf.max_prob_val)
            i2p = np.empty(m + 1, F32)
            for i in range(m + 1):
                i2p[i] = (F32(i) / F32(m)) * (mx - mn) + mn
            self.i2p = i2p
        self.ready = conf.dfa is not None and self.i2p is not None

    def get_int_prob(self, word: list[int]) -> int:
        if not self.ready:
            return -1
        conf = self.conf
        cur = _normalize_word(word, conf.ignore_case, conf.charmap, self.in_tr)
        dfa = conf.dfa
        state = dfa.initial
        for c in cur:
            state = dfa.get_dest(state, c)
            if state == -1:
                return -1
        return dfa.get_ow(state)

    def get_prob(self, word: list[int]) -> float:
        ip = self.get_int_prob(word)
        if ip != -1:
            return float(self.i2p[ip])
        return float(self.UNFOUND)


class RegexpTags:
    """All-match regexp tagger over a multi-Moore [wbd]-style section
    (FARegexpTags_t.h:142-357): every final state's actions contribute
    (tag, score); per tag the maximum score wins."""

    SUB_IW = Iw.EPSILON

    def __init__(self, dfa: DfaWalker, acts: dict[int, np.ndarray],
                 ignore_case: bool = False, max_tag: int | None = None):
        self.dfa = dfa
        self.acts = {k: [int(x) for x in v] for k, v in acts.items()}
        self.ignore_case = ignore_case
        for act_id in sorted(self.acts):
            act = self.acts[act_id]
            if len(act) != 4:
                raise ValueError("regexp-tags actions must be 4 ints")
            if act[2] < 0 or act[3] < 0:
                raise ValueError("negative score/tag")

    def process(self, text: list[int]) -> tuple[list[int], list[int]]:
        tag2score: dict[int, int] = {}
        order: list[int] = []
        prev_final = -1
        dfa = self.dfa
        initial = dfa.initial
        n = len(text)

        def add_tags(state: int):
            nonlocal prev_final
            for ow in dfa.get_ows(state):
                act = self.acts[ow]
                score, tag = act[2], act[3]
                old = tag2score.get(tag, -1)
                if old < score:
                    tag2score[tag] = score
                if old == -1:
                    order.append(tag)

        for from_pos in range(-1, n):
            state = initial
            j = from_pos
            bound = min(from_pos + MAX_WORD_LEN, n)
            if j == -1:
                state = dfa.get_dest(initial, Iw.L_ANCHOR)
                if state == -1:
                    state = dfa.get_dest(initial, Iw.ANY)
                    if state == -1:
                        continue
                j += 1
            while j < bound:
                iw = text[j]
                if iw < Iw.EPSILON:
                    iw = self.SUB_IW
                if self.ignore_case:
                    iw = to_lower(iw)
                dst = dfa.get_dest(state, iw)
                if dst == -1:
                    dst = dfa.get_dest(state, Iw.ANY)
                    if dst == -1:
                        break
                if dfa.is_final(dst) and prev_final != dst:
                    prev_final = dst
                    add_tags(dst)
                state = dst
                j += 1
            if j == n:
                dst = dfa.get_dest(state, Iw.R_ANCHOR)
                if dst == -1:
                    dst = dfa.get_dest(state, Iw.ANY)
                if dst != -1 and prev_final != dst and dfa.is_final(dst):
                    prev_final = dst
                    add_tags(dst)

        return order, [tag2score[t] for t in order]


class SuffixInterpreter:
    """Suffix-rule interpreter: word [+tags] -> 0-separated word list
    (FASuffixInterpretTools_t.h:150-689)."""

    DELIM_IW = 0

    def __init__(self, conf: WftConf, in_tr=None, out_tr=None):
        if conf.use_nfst:
            raise NotImplementedError("NFST-mode word-form transformations")
        self.conf = conf
        self.dfa = conf.dfa
        self.acts = conf.acts
        self.in_tr = in_tr
        self.out_tr = out_tr

    def _last_final(self, word: list[int], start: int) -> int:
        """Deepest final along the REVERSED word (suffix automaton)."""
        dfa = self.dfa
        last = -1
        state = start
        if not self.conf.dict_mode:
            for c in reversed(word):
                state = dfa.get_dest(state, c)
                if state == -1:
                    break
                if dfa.is_final(state):
                    last = state
            if state != -1:
                state = dfa.get_dest(state, self.DELIM_IW)
                if state != -1 and dfa.is_final(state):
                    last = state
            return last
        for c in reversed(word):
            state = dfa.get_dest(state, c)
            if state == -1:
                break
        if state != -1 and dfa.is_final(state):
            last = state
        return last

    def _apply_action(self, word: list[int], act: list[int]) -> list[int] | None:
        """One rule: cut prefix/suffix, add new ones
        (FASuffixInterpretTools_t.h:386-473).  Returns the generated word
        (without the terminating 0) or None when the rule yields nothing."""
        if act[0] <= MAX_WORD_LEN:
            pref: list[int] = []
            pref_cut = 0
            suff = act[1:]
            suff_cut = act[0]
        else:
            skip = act[0] - MAX_WORD_LEN
            pref = act[2:skip]
            pref_cut = act[1]
            suff = act[skip + 1 :]
            suff_cut = act[skip]
        common_len = len(word) - suff_cut - pref_cut
        if common_len < 0 or (common_len == 0 and not suff and not pref):
            return None
        out = pref + word[pref_cut : pref_cut + common_len] + suff
        if self.out_tr is not None:
            new = self.out_tr(out)
            if new is not None:
                out = new
        return out

    def _build(self, word: list[int], last_final: int) -> list[list[int]] | None:
        ows = self.dfa.get_ows(last_final)
        if not ows:
            return None
        results = []
        for act_num in ows:
            act = self.acts.get(act_num)
            if act is None:
                continue
            got = self._apply_action(word, [int(x) for x in act])
            if got is not None:
                results.append(got)
        return results

    def _normalize(self, word: list[int]) -> list[int]:
        return _normalize_word(
            word, self.conf.ignore_case, self.conf.charmap, self.in_tr
        )

    def process(self, word: list[int], tags: tuple[int, ...] = ()) -> list[list[int]] | None:
        """Tagless / one-tag / two-tag rule application
        (FASuffixInterpretTools_t.h:559-689)."""
        dfa = self.dfa
        cur = self._normalize(word)
        if not tags:
            last = self._last_final(cur, dfa.initial)
            return self._build(cur, last) if last != -1 else None
        if len(tags) == 1:
            state = dfa.get_dest(dfa.initial, tags[0])
            if state == -1:
                return None
            last = self._last_final(cur, state)
            if last == -1 and dfa.is_final(state):
                last = state
            return self._build(cur, last) if last != -1 else None
        if len(tags) == 2:
            last = -1
            state = dfa.get_dest(dfa.initial, tags[0])
            if state == -1:
                return None
            if dfa.is_final(state):
                last = state
            state = dfa.get_dest(state, tags[1])
            if state != -1:
                new_last = self._last_final(cur, state)
                if new_last != -1:
                    last = new_last
                elif dfa.is_final(state):
                    last = state
            return self._build(cur, last) if last != -1 else None
        raise ValueError("at most two tags")


class Stemmer:
    """PRM stemmer over the suffix-rule interpreters (FAStemmer_t.h:175-630)."""

    def __init__(self, ldb: "MorphLdb"):
        trs = ldb.trs
        in_tr = trs.in_tr if trs else None
        out_tr = trs.out_tr if trs else None

        def make(conf: WftConf | None):
            if conf is None or conf.dfa is None or conf.acts is None:
                return None
            return SuffixInterpreter(
                conf,
                in_tr=None if conf.no_tr else in_tr,
                out_tr=out_tr,
            )

        self.w2b = make(ldb.w2b)
        self.b2w = make(ldb.b2w)
        self.wt2b = make(ldb.wt2b)
        self.b2wt = make(ldb.b2wt)

    def process_w2b(self, word: list[int]) -> list[list[int]] | None:
        if self.w2b is None or not 0 < len(word) <= MAX_WORD_LEN:
            return None
        return self.w2b.process(word)

    def process_b2w(self, base: list[int]) -> list[list[int]] | None:
        if self.b2w is None or not 0 < len(base) <= MAX_WORD_LEN:
            return None
        return self.b2w.process(base)

    def process_w2w(self, word: list[int]) -> list[list[int]] | None:
        bases = self.process_w2b(word)
        if bases is None:
            return None
        out: list[list[int]] = []
        for b in bases:
            forms = self.b2w.process(b)
            if forms:
                out.extend(forms)
        return out

    def process_wt2b(self, word: list[int], from_tag: int) -> list[list[int]] | None:
        if self.wt2b is None or not 0 < len(word) <= MAX_WORD_LEN:
            return None
        got = self.wt2b.process(word, (from_tag,))
        return got if got else None

    def process_b2wt(self, base: list[int], to_tag: int) -> list[list[int]] | None:
        if self.b2wt is None or not 0 < len(base) <= MAX_WORD_LEN:
            return None
        got = self.b2wt.process(base, (to_tag,))
        return got if got else None

    def process_wtt2w(
        self, word: list[int], from_tag: int, to_tag: int
    ) -> list[list[int]] | None:
        bases = self.process_wt2b(word, from_tag)
        if bases is None:
            return None
        out: list[list[int]] = []
        for b in bases:
            forms = self.b2wt.process(b, (to_tag,))
            if forms:
                out.extend(forms)
        return out if out else None


# ---------------------------------------------------------------------------
# WRE parsing (digitizers + parse tree + rules automaton)
# ---------------------------------------------------------------------------


class Digitizer:
    """Text digitizer: word -> Ow via a Moore DFA over a reduced alphabet
    (FADigitizer_t.h:92-216)."""

    def __init__(self, dfa: DfaWalker, any_iw: int = 0, any_ow: int = 0,
                 ignore_case: bool = False):
        self.dfa = dfa
        self.any_iw = any_iw
        self.any_ow = any_ow
        self.ignore_case = ignore_case
        iws = np.unique(dfa.aut.edge_iw)
        self.max_iw = int(iws.max()) if len(iws) else 0
        self.sym2iw = np.full(self.max_iw + 1, any_iw, np.int32)
        self.sym2iw[iws] = iws

    def process(self, word: list[int]) -> int:
        state = self.dfa.initial
        for c in word:
            if self.ignore_case:
                c = to_lower(c)
            iw = int(self.sym2iw[c]) if 0 <= c <= self.max_iw else self.any_iw
            state = self.dfa.get_dest(state, iw)
            if state == -1:
                return self.any_ow
        ow = self.dfa.get_ow(state)
        return ow if ow != -1 else self.any_ow


class DigitizerDct:
    """Dict digitizer: tag-dict set id -> Ow (FADigitizer_dct_t.h:49-119)."""

    def __init__(self, tag_dict: DictInterpreter | None, set2ow: np.ndarray,
                 any_ow: int = Iw.ANY):
        self.tag_dict = tag_dict
        self.set2ow = set2ow
        self.any_ow = any_ow

    def process_word(self, word: list[int]) -> int:
        set_id = self.tag_dict.get_info_id(word) if self.tag_dict else -1
        return self.process(set_id)

    def process(self, set_id: int) -> int:
        if set_id < 0 or set_id >= len(self.set2ow):
            return self.any_ow
        return int(self.set2ow[set_id])


class ParseTree:
    """Parse-tree container, bit-compatible with the reference FAParseTree
    (blingfirecompile.library/src/FAParseTree.cpp:32-134): AddNode wraps the
    node at FromPos by COPYING its contents into a fresh node and turning the
    original index into the constituent, so node 0 always heads the upper
    chain; position/label maps refresh only at Update()."""

    def __init__(self, count: int):
        self.init(count)

    def init(self, count: int):
        # node: [next, child, label]
        self.nodes: list[list[int]] = [
            [i + 1 if i + 1 < count else -1, -1, i] for i in range(count)
        ]
        self.p2i: list[int] = list(range(count))
        self.p2l: list[int] = list(range(count))

    def get_upper_nodes(self) -> list[int]:
        return self.p2i

    def get_upper_labels(self) -> list[int]:
        return self.p2l

    def get_next(self, node: int) -> int:
        return self.nodes[node][0]

    def get_child(self, node: int) -> int:
        return self.nodes[node][1]

    def get_label(self, node: int) -> int:
        return self.nodes[node][2]

    def add_node(self, label: int, from_pos: int, to_pos: int) -> None:
        new_id = len(self.nodes)
        to_node = self.p2i[to_pos]
        from_node = self.p2i[from_pos]
        self.p2i[from_pos] = new_id
        self.nodes.append(list(self.nodes[from_node]))  # copy contents
        fn = self.nodes[from_node]
        fn[2] = label
        fn[0] = self.nodes[to_node][0]
        fn[1] = new_id
        if from_pos != to_pos:
            self.nodes[to_node][0] = -1
        else:
            self.nodes[new_id][0] = -1

    def update(self) -> None:
        """Rebuild position maps by walking the chain from node 0."""
        p2i: list[int] = []
        p2l: list[int] = []
        idx = 0
        while idx != -1:
            p2i.append(idx)
            p2l.append(self.nodes[idx][2])
            idx = self.nodes[idx][0]
        self.p2i = p2i
        self.p2l = p2l


@dataclass
class WreConf:
    """Packed WRE configuration (FAWREConf_pack.cpp:83-179)."""

    wre_type: int
    token_type: int
    tag_ow_base: int
    dfa1: DfaWalker | None = None  # rules automaton (multi-Moore)
    txt_dig_dfa: DfaWalker | None = None  # text digitizer (Moore)
    dct_arr: np.ndarray | None = None  # dict digitizer set->Ow array
    trbr: MultiMapPack | None = None

    @classmethod
    def from_image(cls, buf: bytes, base: int) -> "WreConf":
        ints = np.frombuffer(buf, "<i4", 8, base)
        conf = cls(
            wre_type=int(ints[WRE_CONF_WRE_TYPE]),
            token_type=int(ints[WRE_CONF_TOKEN_TYPE]),
            tag_ow_base=int(ints[WRE_CONF_TAG_OW_BASE]),
        )
        if ints[WRE_CONF_TXT_DIG] > 0:
            img = PackedDfaImage(buf, base + int(ints[WRE_CONF_TXT_DIG]))
            conf.txt_dig_dfa = DfaWalker(densify_automaton(img))
        if ints[WRE_CONF_DCT_DIG] > 0:
            conf.dct_arr = ArrayPack(buf, base + int(ints[WRE_CONF_DCT_DIG])).densify()
        if ints[WRE_CONF_FSM1] > 0:
            img = PackedDfaImage(buf, base + int(ints[WRE_CONF_FSM1]))
            if conf.wre_type == WRE_TYPE_MOORE:
                conf.dfa1 = DfaWalker(densify_automaton(img, multi_moore=True))
            elif conf.wre_type == WRE_TYPE_MEALY:
                conf.dfa1 = DfaWalker(densify_automaton(img, mealy=True))
            else:
                conf.dfa1 = DfaWalker(densify_automaton(img))
        if ints[WRE_CONF_FSM2] > 0 or ints[WRE_CONF_TRBR] > 0:
            if ints[WRE_CONF_TRBR] > 0:
                conf.trbr = MultiMapPack(buf, base + int(ints[WRE_CONF_TRBR]))
        return conf


@dataclass
class ParserConf:
    """[wre]-rules parser section (FAParserConfKeeper.cpp:42-125)."""

    wre: WreConf | None = None
    acts: dict[int, list[int]] = field(default_factory=dict)
    act_data: MultiMapPack | None = None
    ignore_case: bool = False
    max_depth: int = 2
    max_pass_count: int = 1
    fn2ini: list[int] = field(default_factory=list)

    MIN_ACT_SIZE = 3

    @classmethod
    def from_params(cls, ldb: LdbContainer, values) -> "ParserConf":
        conf = cls()
        vals = list(values)
        i = 0
        while i < len(vals):
            p = int(vals[i])
            if p == Param.DEPTH:
                i += 1
                conf.max_depth = int(vals[i])
            elif p == Param.MAX_PASS_COUNT:
                i += 1
                conf.max_pass_count = int(vals[i])
            elif p == Param.IGNORE_CASE:
                conf.ignore_case = True
            elif p == Param.WRE_CONF:
                i += 1
                conf.wre = WreConf.from_image(ldb.image, ldb.dump(int(vals[i])))
            elif p == Param.ACTS:
                i += 1
                mm = MultiMapPack(ldb.image, ldb.dump(int(vals[i])))
                conf.acts = {k: [int(x) for x in v] for k, v in mm.to_dict().items()}
            elif p == Param.ACT_DATA:
                i += 1
                conf.act_data = MultiMapPack(ldb.image, ldb.dump(int(vals[i])))
            else:
                raise ValueError(f"unknown [wre-rules] param {p}")
            i += 1
        if conf.wre is None or not conf.acts:
            raise ValueError("[wre-rules] needs a WRE conf and actions")
        conf._calc_fn_ini()
        return conf

    def _calc_fn_ini(self) -> None:
        """Probe '$ FnId' paths for function entry states
        (FAParserConfKeeper.cpp:138-260)."""
        wre = self.wre
        dfa = wre.dfa1
        if dfa is None:
            return
        max_fn = -1
        for act in self.acts.values():
            m = self.MIN_ACT_SIZE
            if len(act) == m and act[m - 1] != 0:
                continue
            if len(act) > m and act[m - 1] == 0:
                i = m
            elif len(act) > m + 1 and act[m] == 0:
                i = m + 1
            else:
                raise ValueError("invalid WRE action")
            for fn in act[i:]:
                if fn < 0:
                    raise ValueError("bad function id")
                max_fn = max(max_fn, fn)
        if max_fn == -1:
            return
        tt, base = wre.token_type, wre.tag_ow_base
        self.fn2ini = [-1] * (max_fn + 1)
        for fn in range(max_fn + 1):
            state = dfa.initial
            # '$' step per enabled digitizer
            if tt & WRE_TT_TEXT and state != -1:
                state = dfa.get_dest(state, Iw.R_ANCHOR)
            if tt & WRE_TT_TAGS and state != -1:
                state = dfa.get_dest(state, Iw.R_ANCHOR)
            if tt & WRE_TT_DCTS and state != -1:
                state = dfa.get_dest(state, Iw.R_ANCHOR)
            if state == -1:
                continue
            # FnId step
            if tt & WRE_TT_TEXT and state != -1:
                state = dfa.get_dest(state, Iw.ANY)
            if tt & WRE_TT_TAGS and state != -1:
                state = dfa.get_dest(state, fn + base)
            if tt & WRE_TT_DCTS and state != -1:
                state = dfa.get_dest(state, Iw.ANY)
            self.fn2ini[fn] = state


class WreLexTools:
    """WRE bottom-up parser (FAWreLexTools_t.h:204-627): words are digitized
    into (text-Ow, tag-Ow, dict-Ow) tuples; the rules automaton matches over
    the parse tree's upper level, adding constituents."""

    MIN_ACT_SIZE = 3

    def __init__(self, conf: ParserConf, tag_dict: DictInterpreter | None = None):
        self.conf = conf
        wre = conf.wre
        self.dfa = wre.dfa1
        self.acts = conf.acts
        self.tt = wre.token_type
        self.tag_ow_base = wre.tag_ow_base
        self.w2ow = (
            Digitizer(wre.txt_dig_dfa, any_iw=0, any_ow=0,
                      ignore_case=conf.ignore_case)
            if wre.txt_dig_dfa is not None
            else None
        )
        self.w2ow_dct = (
            DigitizerDct(tag_dict, wre.dct_arr)
            if wre.dct_arr is not None
            else None
        )
        self._reset(0)

    def _reset(self, max_words: int):
        self._txt: list[int] = []
        self._tag: list[int] = []
        self._dct: list[int] = []
        self._tree: ParseTree | None = None
        self._last_to = 0
        self._labels: list[int] = []
        self._upper = 0

    def reset(self, max_words: int):
        self._reset(max_words)

    def add_word(self, word: list[int], tag: int, dct_set_id: int = -1):
        if self.tt & WRE_TT_TEXT:
            self._txt.append(self.w2ow.process(word))
        if self.tt & WRE_TT_TAGS:
            self._tag.append(tag + self.tag_ow_base)
        if self.tt & WRE_TT_DCTS:
            if dct_set_id == -1:
                self._dct.append(self.w2ow_dct.process_word(word))
            else:
                self._dct.append(self.w2ow_dct.process(dct_set_id))

    def set_parse_tree(self, tree: ParseTree):
        self._tree = tree

    def _next_state(self, state: int, i: int) -> int:
        dfa = self.dfa
        tt = self.tt
        if 0 <= i < self._upper:
            lab = self._labels[i]
            if lab < 0:  # constituent
                if tt & WRE_TT_TEXT and state != -1:
                    state = dfa.get_dest(state, Iw.ANY)
                if tt & WRE_TT_TAGS and state != -1:
                    state = dfa.get_dest(state, -lab + self.tag_ow_base)
                if tt & WRE_TT_DCTS and state != -1:
                    state = dfa.get_dest(state, Iw.ANY)
            else:  # word index
                if tt & WRE_TT_TEXT and state != -1:
                    state = dfa.get_dest(state, self._txt[lab])
                if tt & WRE_TT_TAGS and state != -1:
                    state = dfa.get_dest(state, self._tag[lab])
                if tt & WRE_TT_DCTS and state != -1:
                    state = dfa.get_dest(state, self._dct[lab])
        elif i == -1:
            for _ in range(bin(tt & 7).count("1")):
                if state == -1:
                    break
                state = dfa.get_dest(state, Iw.L_ANCHOR)
        else:
            for _ in range(bin(tt & 7).count("1")):
                if state == -1:
                    break
                state = dfa.get_dest(state, Iw.R_ANCHOR)
        return state

    def _process_0_n(self, initial: int, offset: int, in_size: int,
                     depth: int, once: bool = False) -> int:
        if depth > self.conf.max_depth:
            return 0
        out = 0
        dfa = self.dfa
        from_pos = -1
        while from_pos < in_size:
            state = initial
            final_state = final_pos = -1
            j = from_pos
            if j == -1:
                state = self._next_state(initial, -1)
                if state == -1:
                    from_pos += 1
                    continue
                j += 1
            while j < in_size:
                dst = self._next_state(state, j + offset)
                if dst == -1:
                    break
                if dfa.is_final(dst):
                    final_state, final_pos = dst, j
                state = dst
                j += 1
            if j == in_size:
                dst = self._next_state(state, self._upper)
                if dst != -1 and dfa.is_final(dst):
                    final_state, final_pos = dst, j
            if final_pos != -1:
                ows = dfa.get_ows(final_state)
                ow = ows[0]
                act = self.acts[ow]
                left_cx, right_cx, tag = act[0], act[1], act[2]
                from2 = min(max(from_pos + left_cx, 0), in_size - 1)
                to2 = min(max(final_pos - right_cx, 0), in_size - 1)
                fn_idx = self.MIN_ACT_SIZE
                if tag != 0:
                    self._tree.add_node(-tag, from2 + offset, to2 + offset)
                    self._last_to = to2 + offset
                    out += 1
                    fn_idx = self.MIN_ACT_SIZE + 1
                fn_once = (len(act) - fn_idx) > 1
                fn_from = from2
                for k in range(fn_idx, len(act)):
                    fn_id = act[k]
                    fn_ini = self.conf.fn2ini[fn_id]
                    fn_in_size = to2 - fn_from + 1
                    got = self._process_0_n(
                        fn_ini, fn_from + offset, fn_in_size, depth + 1,
                        False if fn_id == 0 else fn_once,
                    )
                    if got > 0:
                        out += got
                        fn_from = self._last_to + 1 - offset
                        if fn_from > to2:
                            break
                if once:
                    return out
                if final_pos - right_cx > from_pos:
                    from_pos = final_pos - right_cx
            from_pos += 1
        return out

    def process(self) -> int:
        if self._tree is None or self.dfa is None:
            return -1
        out = 0
        for _ in range(self.conf.max_pass_count):
            initial = self.dfa.initial
            self._labels = self._tree.get_upper_labels()
            self._upper = len(self._labels)
            got = self._process_0_n(initial, 0, self._upper, 1)
            if got == 0:
                break
            out += got
            self._tree.update()
        return out


# ---------------------------------------------------------------------------
# the morphology LDB: probe every section, wire every engine
# ---------------------------------------------------------------------------


class MorphLdb:
    """FAMorphLDB_t_packaged equivalent: one .bin containing any subset of
    the morphology sections (FAMorphLDB_t_packaged.h:253-403)."""

    def __init__(self, image: bytes, validate: bool = True):
        ldb = LdbContainer.from_bytes(image, validate=validate)
        self.ldb = ldb

        def sec(func: Func):
            return ldb.section(func)

        got = sec(Func.TRS)
        self.trs = TrsConf.from_params(ldb, got) if got is not None else None

        def wg(func: Func):
            got = sec(func)
            return WgConf.from_params(ldb, got) if got is not None else None

        self.w2t = wg(Func.W2T)
        self.b2t = wg(Func.B2T)
        self.w2tp = wg(Func.W2TP)
        self.w2tpl = wg(Func.W2TPL)
        self.w2tpr = wg(Func.W2TPR)

        def wft(func: Func):
            got = sec(func)
            return WftConf.from_params(ldb, got) if got is not None else None

        self.w2b = wft(Func.W2B)
        self.b2w = wft(Func.B2W)
        self.wt2b = wft(Func.WT2B)
        self.b2wt = wft(Func.B2WT)
        self.w2v = wft(Func.W2V)

        def ts(func: Func):
            got = sec(func)
            return TsConf.from_params(ldb, got) if got is not None else None

        self.t2p = ts(Func.T2P)
        self.tt2p = ts(Func.TT2P)
        self.ttt2p = ts(Func.TTT2P)

        got = sec(Func.TAG_DICT)
        self.tag_dict = TagDictConf.from_params(ldb, got) if got is not None else None
        got = sec(Func.W2P)
        self.w2p = W2PConf.from_params(ldb, got) if got is not None else None
        got = sec(Func.WRE)
        self.wre_rules = ParserConf.from_params(ldb, got) if got is not None else None

    # engine factories -------------------------------------------------------

    def _in_tr(self):
        return self.trs.in_tr if self.trs else None

    def word_guesser(self, which: str = "w2t") -> WordGuesser | None:
        conf = getattr(self, which)
        return WordGuesser(conf, self._in_tr()) if conf else None

    def word_guesser_prob(self, which: str = "w2tp") -> WordGuesserProb | None:
        conf = getattr(self, which)
        return WordGuesserProb(conf, self._in_tr()) if conf else None

    def dict_interpreter(self) -> DictInterpreter | None:
        if self.tag_dict is None:
            return None
        return DictInterpreter(self.tag_dict, self._in_tr())

    def word_to_prob(self) -> WordToProb | None:
        if self.w2p is None:
            return None
        return WordToProb(self.w2p, self._in_tr())

    def stemmer(self) -> Stemmer:
        return Stemmer(self)

    def hmm_tagger(self, max_tags: int = 64) -> HmmTaggerL1 | None:
        if self.w2tp is None or self.t2p is None or self.tt2p is None:
            return None
        return HmmTaggerL1(
            WordGuesserProb(self.w2tp, self._in_tr()),
            T2PTable(self.t2p),
            Ts2PTable(self.tt2p),
            eos_tag=self.w2tp.eos_tag,
        )

    def wre_parser(self) -> WreLexTools | None:
        if self.wre_rules is None:
            return None
        return WreLexTools(self.wre_rules, self.dict_interpreter())


def load_morph(path: str) -> MorphLdb:
    with open(path, "rb") as f:
        return MorphLdb(f.read())


def load_regexp_tags(image: bytes, validate: bool = True) -> RegexpTags:
    """Load an all-match tagger from a [wbd]-section model (the FAWbdConfKeeper
    params FARegexpTags_t::Initialize consumes: FSM_TYPE moore-mdfa, FSM,
    MULTI_MAP, IGNORE_CASE, MAX_TAG — FAWbdConfKeeper.cpp:66-232)."""
    ldb = LdbContainer.from_bytes(image, validate=validate)
    vals = ldb.section(Func.WBD)
    if vals is None:
        raise ValueError("no [wbd] section")
    fsm = mmap = None
    ignore_case = False
    max_tag = None
    i = 0
    n = len(vals)
    while i < n:
        p = int(vals[i])
        if p == Param.IGNORE_CASE:
            ignore_case = True
        elif p == Param.FSM:
            i += 1
            fsm = int(vals[i])
        elif p == Param.MULTI_MAP:
            i += 1
            mmap = int(vals[i])
        elif p == Param.MAX_TAG:
            i += 1
            max_tag = int(vals[i])
        elif p in (Param.FSM_TYPE, Param.MAP_MODE, Param.DEPTH,
                   Param.MAX_LENGTH, Param.CHARMAP, Param.ACT_DATA,
                   Param.PUNKT, Param.EOS, Param.EOP, Param.WORD,
                   Param.XWORD, Param.SEG, Param.IGNORE):
            i += 1
        else:
            raise ValueError(f"unknown [wbd] param {p}")
        i += 1
    if fsm is None or mmap is None:
        raise ValueError("[wbd] needs an FSM and an actions multimap")
    img = PackedDfaImage(ldb.image, ldb.dump(fsm))
    dfa = DfaWalker(densify_automaton(img, multi_moore=True))
    acts = MultiMapPack(ldb.image, ldb.dump(mmap)).to_dict()
    return RegexpTags(dfa, acts, ignore_case=ignore_case, max_tag=max_tag)
