# Copy of blingfire_tpu/compiler/lexbin.py, kept here so that this package imports nothing of the JAX package.
"""End-to-end [wbd] grammar model builder: .lex sources -> .bin.

Equivalent of `fa_build_lex ... --build-dump` + conf + fa_merge_dumps
(ldbsrc/Makefile.gnu:232-236,526-532)."""

from __future__ import annotations

import numpy as np

from ..formats.consts import Func, Param
from .lexfsm import ANY, IW_LA, IW_RA, build_lex_automaton
from .lexrules import build_groups, load_tagset, preprocess
from .packers import pack_ldb, pack_moore_dfa, pack_multimap, pack_multimap_fixed


def compile_lex_model(
    lex_text: str,
    tagset: dict[str, int],
    dict_root: str = ".",
    max_depth: int = 4,
    charmap: dict[int, list[int]] | None = None,
    extra_params: dict[int, int] | None = None,
    validate: bool = True,
) -> bytes:
    """Compile lexer rules into a loadable [wbd] LDB image."""
    rules = preprocess(lex_text, dict_root)
    groups = build_groups(rules, dict(tagset))
    aut = build_lex_automaton(groups)

    # original-iw alphabet ranges + iw map entries (original -> internal)
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
    # merge adjacent alphabet ranges
    merged: list[tuple[int, int]] = []
    for lo, hi in alpha:
        if merged and lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))

    fsm_dump = pack_moore_dfa(
        aut.n_states,
        aut.final,
        aut.edges,
        aut.state_ow,
        merged,
        iw_entries,
    )

    acts = {gid: g.action for gid, g in enumerate(groups)}
    acts_dump = pack_multimap(acts)

    stream: list[int] = [Param.DEPTH, max_depth]
    for name, pid in (
        ("XWORD", Param.XWORD),
        ("SEG", Param.SEG),
        ("IGNORE", Param.IGNORE),
    ):
        if name in tagset:
            stream += [pid, tagset[name]]
    stream += [Param.FSM, 1, Param.MAP_MODE, 1, Param.MULTI_MAP, 2]
    if charmap is not None:
        stream += [Param.CHARMAP, 3]
    if extra_params:
        # valueless flag params (e.g. ignore-case) are key-only in the conf
        # stream (FAWbdConfKeeper.cpp:90-93); pass value None for those
        for k, v in extra_params.items():
            stream += [k] if v is None else [k, v]
    conf = {int(Func.WBD): stream}
    if validate:
        conf[int(Func.GLOBAL)] = [int(Param.VERIFY_LDB_BIN)]
    dumps = [pack_multimap(conf), fsm_dump, acts_dump]
    if charmap is not None:
        dumps.append(pack_multimap_fixed(charmap, size_of_value=4))
    return pack_ldb(dumps, validate=validate)
