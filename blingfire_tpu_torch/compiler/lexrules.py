# Copy of blingfire_tpu/compiler/lexrules.py, kept here so that this package imports nothing of the JAX package.
"""Lex-rules grammar compiler: .lex sources -> Moore DFA + action map.

Pipeline equivalent of fa_preproc | fa_pr2wre | fa_re2nfa | fa_nfalist2nfa |
fa_fsm2fsm_iwec | fa_nfa2dfa | fa_dfa2mindfa | fa_fsm2fsm(moore)
(scripts/fa_build_lex:199-236, scripts/fa_preproc,
blingfirecompile.library/src/FAParser2WRE.cpp:393-803):

  1. preprocess: _include, comment strip, _define fixpoint substitution over
     identifier tokens, ' --> ' action split, _function scoping
  2. per rule: parse `Lc < B > Rc`, enumerate fixed-length context paths,
     emit one sub-rule per (|Lc|, |Rc|) combination; rules with identical
     action strings are merged; groups are ordered by the reference's action
     string sort; function bodies get the `$ \\xFnTag` entry prefix
  3. Glushkov position NFA per group over interval character classes;
     global alphabet partition; subset construction with IW_ANY-as-other;
     Moore minimization (lowest group id wins on conflicts)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .relex import MAX_CP, Node, iv_norm, parse_regexp

# -- preprocessing (scripts/fa_preproc semantics) ---------------------------


def _is_name_char(c: str) -> bool:
    return c.isascii() and (c.isalnum() or c == "_")


def _substitute(line: str, defines: dict[str, str]) -> str:
    prev = line
    for _ in range(100):
        out = []
        i = 0
        n = len(prev)
        while i < n:
            if _is_name_char(prev[i]):
                j = i
                while j < n and _is_name_char(prev[j]):
                    j += 1
                name = prev[i:j]
                out.append(defines.get(name, name))
                i = j
            else:
                out.append(prev[i])
                i += 1
        res = "".join(out)
        if res == prev:
            return res
        prev = res
    raise ValueError(f"recursive define in: {line[:60]!r}")


def read_lex_source(path: str) -> str:
    """Read a .lex/.def source leniently: some shipped sources contain raw
    8-bit bytes inside comments (e.g. ldbsrc/sbd/wbd.lex.utf8)."""
    with open(path, "rb") as f:
        return f.read().decode("utf-8", errors="surrogateescape")


def preprocess(text: str, dict_root: str) -> list[tuple[str, str]]:
    """Returns [(rule_text, action_text)] with _function/_end lines kept as
    ("_function NAME", "") / ("_end", "")."""
    # 1. includes
    lines: list[str] = []
    for ln in text.splitlines():
        ln = ln.rstrip("\r\n")
        parts = ln.split()
        if parts and parts[0] == "_include":
            inc = read_lex_source(os.path.join(dict_root, parts[1]))
            for il in inc.lstrip("﻿").splitlines():
                lines.append(il.rstrip("\r\n"))
            continue
        lines.append(ln)
    # 2. comments / empties
    lines = [l for l in lines if l.strip() and not l.lstrip(" \t").startswith("#")]
    # 3. defines
    defines: dict[str, str] = {}
    out_lines: list[str] = []
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if parts and parts[0] == "_define":
            if len(parts) > 2:
                defines[parts[1]] = " ".join(parts[2:])
                i += 1
            else:
                name = parts[1]
                body = []
                i += 1
                while i < len(lines) and lines[i].strip() != "_end":
                    body.append(lines[i])
                    i += 1
                i += 1  # skip _end
                defines[name] = "\n".join(body)
            continue
        out_lines.append(_substitute(lines[i], defines))
        i += 1
    # 4. split actions
    rules: list[tuple[str, str]] = []
    for ln in out_lines:
        if " --> " in ln:
            left, right = ln.split(" --> ", 1)
            rules.append((left, right))
        else:
            rules.append((ln, ""))
    return rules


# -- tagset -----------------------------------------------------------------


def parse_charmap(text: str) -> dict[int, list[int]]:
    """Parse a charmap.utf8 source: `\\xFROM \\xTO...` per line
    (ldbsrc/*/charmap.utf8, generated by gen_charmap.py)."""
    out: dict[int, list[int]] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        parts = ln.split()
        vals = []
        for p in parts:
            if p.startswith("\\x") or p.startswith("\\X"):
                vals.append(int(p[2:], 16))
            elif len(p) == 1:
                vals.append(ord(p))
            else:
                raise ValueError(f"bad charmap entry {p!r}")
        if len(vals) >= 1:
            out[vals[0]] = vals[1:]
    return out


def load_tagset(path_or_text: str, is_text: bool = False) -> dict[str, int]:
    text = path_or_text if is_text else open(path_or_text, encoding="utf-8").read()
    out: dict[str, int] = {}
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) >= 2 and not ln.lstrip().startswith("#"):
            out[parts[0]] = int(parts[1])
    return out


# -- context path enumeration ----------------------------------------------


def _paths(node: Node) -> list[tuple[Node, ...]]:
    """All leaf-sequences accepted by an acyclic context sub-AST."""
    if node.kind in ("sym", "any", "la", "ra"):
        return [(node,)]
    if node.kind == "cat":
        acc: list[tuple[Node, ...]] = [()]
        for ch in node.children:
            acc = [a + b for a in acc for b in _paths(ch)]
            if len(acc) > 100000:
                raise ValueError("context path explosion")
        return acc
    if node.kind == "alt":
        out = []
        for ch in node.children:
            out.extend(_paths(ch))
        return out
    if node.kind == "opt":
        return [()] + _paths(node.children[0])
    if node.kind == "trbr":
        return _paths(node.children[0])
    raise ValueError(f"cyclic/unsupported context: {node.kind}")


# -- rule/group assembly ----------------------------------------------------


@dataclass
class Group:
    key: str
    action: list[int]
    variants: list[Node] = field(default_factory=list)  # alternatives


def _find_trbr_split(root: Node):
    """Split the rule AST into (Lc-nodes, body, Rc-nodes); the trbr must be a
    top-level concatenation element (as in every shipped grammar)."""
    if root.kind == "trbr":
        return [], root.children[0], []
    if root.kind == "cat":
        idx = [i for i, ch in enumerate(root.children) if ch.kind == "trbr"]
        if len(idx) == 1:
            k = idx[0]
            lc = root.children[:k]
            rc = root.children[k + 1 :]
            return lc, root.children[k].children[0], rc
    raise ValueError("rule must have exactly one top-level < > body")


def _act_key_and_array(
    lcs: int, rcs: int, act_text: str, tagset: dict[str, int]
) -> tuple[str, list[int]]:
    """Action string exactly as FAParser2WRE builds it (AddRule:412-480) —
    the string IS the group sort key."""
    parts = []
    arr = [lcs, rcs]
    for tok in act_text.split():
        if tok == "_call" or tok == "_main":
            parts.append(f"\t{0:5d}")
            arr.append(0)
        elif (tok.startswith("<") or tok.startswith(">")) and len(tok) >= 3:
            raise NotImplementedError("bracket context adjustments")
        else:
            tag = tagset.get(tok)
            if tag is None:
                raise ValueError(f"unknown action tag {tok!r}")
            parts.append(f"\t{tag:5d}")
            arr.append(tag)
    return f"{lcs:03d}\t{rcs:03d}" + "".join(parts), arr


def build_groups(
    rules: list[tuple[str, str]], tagset: dict[str, int]
) -> list[Group]:
    groups: dict[str, Group] = {}
    fn_prefix: Node | None = None
    # ext tags: base = max input tag + 1; unknown action names are numbered
    # in order of appearance in the ACTIONS stream first (ProcessRight,
    # FAParser2WRE.cpp:843-866), then unknown _function names (ProcessLeft)
    ext_tag = max(tagset.values(), default=0) + 1
    for _left, act in rules:
        for tok in act.split():
            if tok == "_call" or tok in tagset:
                continue
            tagset[tok] = ext_tag
            ext_tag += 1

    for left, act in rules:
        ls = left.strip()
        if ls.startswith("_function"):
            name = ls.split(None, 1)[1].strip()
            tag = tagset.get(name)
            if tag is None:
                tag = ext_tag
                tagset[name] = tag
                ext_tag += 1
            # "$ \xNNNNN" prefix (FAParser2WRE.cpp:668-682)
            fn_prefix = Node(
                "cat",
                children=[Node("ra"), Node("sym", ivs=((tag, tag),))],
            )
            continue
        if ls == "_end":
            fn_prefix = None
            continue

        root = parse_regexp(left)
        lc_nodes, body, rc_nodes = _find_trbr_split(root)
        lc_paths = _paths(Node("cat", children=lc_nodes)) if lc_nodes else [()]
        rc_paths = _paths(Node("cat", children=rc_nodes)) if rc_nodes else [()]
        by_len_lc: dict[int, list[tuple[Node, ...]]] = {}
        for p in lc_paths:
            by_len_lc.setdefault(len(p), []).append(p)
        by_len_rc: dict[int, list[tuple[Node, ...]]] = {}
        for p in rc_paths:
            by_len_rc.setdefault(len(p), []).append(p)

        for lcs, lps in by_len_lc.items():
            for rcs, rps in by_len_rc.items():
                key, arr = _act_key_and_array(lcs, rcs, act, tagset)
                variant_parts: list[Node] = []
                if fn_prefix is not None:
                    variant_parts.append(fn_prefix)
                if lps != [()]:
                    variant_parts.append(
                        Node("alt", children=[Node("cat", children=list(p)) for p in lps])
                    )
                variant_parts.append(body)
                if rps != [()]:
                    variant_parts.append(
                        Node("alt", children=[Node("cat", children=list(p)) for p in rps])
                    )
                variant = Node("cat", children=variant_parts)
                g = groups.get(key)
                if g is None:
                    g = groups[key] = Group(key, arr)
                g.variants.append(variant)

    return [groups[k] for k in sorted(groups)]
