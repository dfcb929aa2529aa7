# Copy of blingfire_tpu/compiler/fsmio.py, kept here so that this package imports nothing of the JAX package.
"""Textual FSM interchange — the ascii automata/map format every reference
fa_* build tool speaks on stdin/stdout.

Format (reference: blingfirecompile.library/src/FAAutIOTools.cpp,
FAMapIOTools.cpp):

RS DFA::

    MaxState: <n>
    MaxIw: <m>
    initial: <q0>
    final: <qf>          (one line per final state)
    <src> <dst> <iw>     (one line per transition; Mealy adds a 4th column
                          with the arc's output weight, -1 = none)
    <blank line>

Moore machines append a ``<state> -> <ow>`` block (single output) or a
``<state> -> <count> <ow...>`` block (multiple outputs) after the DFA's
terminating blank line.  RS NFAs differ only in allowing several
``initial:`` lines and several destination lines per (src, iw).

Maps::

    <key> -> <val>                  plain map
    <key> -> <count> <val...>       multi-map
    <count> <chain...> -> <val>     chain2num
    <val>                           int/float array (one per line)

All blocks are terminated by one empty line.

These readers/printers let this framework's compiler stages interoperate
with reference pipelines: a DFA minimized here can be packed by the
reference fa_fsm2fsm_pack, and automata printed by reference tools load
here.  Parity is proven in tests/test_fsmio.py by round-tripping through
the reference FAAutIOTools compiled into tests/refshim.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TextDfa:
    """A textual-format DFA (optionally Mealy / Moore / multi-Moore)."""

    max_state: int
    max_iw: int
    initial: int
    finals: list[int]
    trans: dict[tuple[int, int], int]  # (src, iw) -> dst
    arc_ow: dict[tuple[int, int], int] = field(default_factory=dict)  # Mealy
    state_ow: dict[int, int] = field(default_factory=dict)  # Moore single
    state_ows: dict[int, list[int]] = field(default_factory=dict)  # Moore multi


@dataclass
class TextNfa:
    max_state: int
    max_iw: int
    initials: list[int]
    finals: list[int]
    trans: dict[tuple[int, int], list[int]]  # (src, iw) -> [dst...]
    arc_ow: dict[tuple[int, int, int], int] = field(default_factory=dict)


# NFA dead-state marker (FAFsmConst::NFA_DEAD_STATE)
NFA_DEAD_STATE = -2


# ---------------------------------------------------------------------------
# printers
# ---------------------------------------------------------------------------


def print_dfa(d: TextDfa, mode: str = "rs") -> str:
    """mode: 'rs' | 'mealy' | 'moore' | 'moore-mult'."""
    out = [f"MaxState: {d.max_state}", f"MaxIw: {d.max_iw}",
           f"initial: {d.initial}"]
    for f in sorted(set(d.finals)):
        out.append(f"final: {f}")
    # reference order: states ascending, iws in alphabet order (ascending)
    for (src, iw) in sorted(d.trans):
        dst = d.trans[(src, iw)]
        if mode == "mealy":
            ow = d.arc_ow.get((src, iw), -1)
            out.append(f"{src} {dst} {iw} {ow}")
        else:
            out.append(f"{src} {dst} {iw}")
    out.append("")
    if mode == "moore":
        for s in sorted(d.state_ow):
            if d.state_ow[s] != -1:
                out.append(f"{s} -> {d.state_ow[s]}")
        out.append("")
    elif mode == "moore-mult":
        for s in sorted(d.state_ows):
            ows = d.state_ows[s]
            if ows:
                out.append(f"{s} -> {len(ows)} " + " ".join(map(str, ows)))
        out.append("")
    return "\n".join(out) + "\n"


def print_nfa(n: TextNfa, mealy: bool = False) -> str:
    out = [f"MaxState: {n.max_state}", f"MaxIw: {n.max_iw}"]
    for i in n.initials:
        out.append(f"initial: {i}")
    for f in n.finals:
        out.append(f"final: {f}")
    for (src, iw) in sorted(n.trans):
        dsts = n.trans[(src, iw)]
        if not dsts:  # explicit dead-state transition
            line = f"{src} {NFA_DEAD_STATE} {iw}"
            out.append(line + " -1" if mealy else line)
            continue
        for dst in dsts:
            if mealy:
                ow = n.arc_ow.get((src, iw, dst), -1)
                out.append(f"{src} {dst} {iw} {ow}")
            else:
                out.append(f"{src} {dst} {iw}")
    out.append("")
    return "\n".join(out) + "\n"


def print_map(m: dict[int, int]) -> str:
    return "".join(f"{k} -> {m[k]}\n" for k in sorted(m)) + "\n"


def print_multimap(m: dict[int, list[int]]) -> str:
    out = []
    for k in sorted(m):
        vals = m[k]
        out.append(f"{k} -> {len(vals)}" + "".join(f" {v}" for v in vals))
    return "\n".join(out) + ("\n\n" if out else "\n")


def print_chain2num(chains: list[tuple[tuple[int, ...], int]]) -> str:
    out = []
    for chain, val in chains:
        out.append(f"{len(chain)} " + " ".join(map(str, chain)) + f" -> {val}")
    return "\n".join(out) + ("\n\n" if out else "\n")


def print_int_array(arr: list[int]) -> str:
    return "".join(f"{v}\n" for v in arr) + "\n"


def print_str2int(pairs: list[tuple[str, int]]) -> str:
    return "".join(f"{s} {v}\n" for s, v in pairs) + "\n"


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def _line_blocks(text: str):
    """Yield lists of lines, splitting on empty lines (block terminator)."""
    block: list[str] = []
    for line in text.splitlines():
        if line.strip() == "":
            yield block
            block = []
        else:
            block.append(line)
    if block:
        yield block


def read_dfa(text: str, mode: str = "rs") -> TextDfa:
    blocks = list(_line_blocks(text))
    lines = blocks[0] if blocks else []
    d = TextDfa(0, 0, -1, [], {})
    for line in lines:
        parts = line.split()
        if parts[0] == "MaxState:":
            d.max_state = int(parts[1])
        elif parts[0] == "MaxIw:":
            d.max_iw = int(parts[1])
        elif parts[0] == "initial:":
            d.initial = int(parts[1])
        elif parts[0] == "final:":
            d.finals.append(int(parts[1]))
        else:
            src, dst, iw = int(parts[0]), int(parts[1]), int(parts[2])
            d.trans[(src, iw)] = dst
            if mode == "mealy":
                ow = int(parts[3])
                if ow != -1:
                    d.arc_ow[(src, iw)] = ow
    d.finals = sorted(set(d.finals))
    if mode == "moore" and len(blocks) > 1:
        for line in blocks[1]:
            s, arrow, ow = line.split()
            assert arrow == "->", line
            d.state_ow[int(s)] = int(ow)
    elif mode == "moore-mult" and len(blocks) > 1:
        for line in blocks[1]:
            parts = line.split()
            assert parts[1] == "->", line
            cnt = int(parts[2])
            d.state_ows[int(parts[0])] = [int(v) for v in parts[3:3 + cnt]]
    return d


def read_nfa(text: str, mealy: bool = False) -> TextNfa:
    blocks = list(_line_blocks(text))
    lines = blocks[0] if blocks else []
    n = TextNfa(0, 0, [], [], {})
    for line in lines:
        parts = line.split()
        if parts[0] == "MaxState:":
            n.max_state = int(parts[1])
        elif parts[0] == "MaxIw:":
            n.max_iw = int(parts[1])
        elif parts[0] == "initial:":
            n.initials.append(int(parts[1]))
        elif parts[0] == "final:":
            n.finals.append(int(parts[1]))
        else:
            src, dst, iw = int(parts[0]), int(parts[1]), int(parts[2])
            lst = n.trans.setdefault((src, iw), [])
            if dst != NFA_DEAD_STATE:
                lst.append(dst)
                if mealy and len(parts) > 3 and int(parts[3]) != -1:
                    n.arc_ow[(src, iw, dst)] = int(parts[3])
    return n


def read_map(text: str) -> dict[int, int]:
    m: dict[int, int] = {}
    for block in _line_blocks(text):
        for line in block:
            k, arrow, v = line.split()
            assert arrow == "->", line
            m[int(k)] = int(v)
        break
    return m


def read_multimap(text: str) -> dict[int, list[int]]:
    m: dict[int, list[int]] = {}
    for block in _line_blocks(text):
        for line in block:
            parts = line.split()
            assert parts[1] == "->", line
            cnt = int(parts[2])
            m[int(parts[0])] = [int(v) for v in parts[3:3 + cnt]]
        break
    return m


def read_chain2num(text: str) -> list[tuple[tuple[int, ...], int]]:
    out: list[tuple[tuple[int, ...], int]] = []
    for block in _line_blocks(text):
        for line in block:
            parts = line.split()
            size = int(parts[0])
            chain = tuple(int(v) for v in parts[1:1 + size])
            assert parts[1 + size] == "->", line
            out.append((chain, int(parts[2 + size])))
        break
    return out


def read_int_array(text: str) -> list[int]:
    for block in _line_blocks(text):
        return [int(line.split()[0]) for line in block]
    return []


def read_str2int(text: str) -> list[tuple[str, int]]:
    out: list[tuple[str, int]] = []
    for block in _line_blocks(text):
        for line in block:
            s, v = line.rsplit(None, 1)
            out.append((s, int(v)))
        break
    return out


# ---------------------------------------------------------------------------
# bridges to this framework's compiler structures
# ---------------------------------------------------------------------------


def from_lex_automaton(aut) -> TextDfa:
    """compiler.lexfsm.LexAutomaton -> TextDfa (class-iw alphabet).

    Moore outputs come across as state_ow / state_ows, matching what
    fa_fsm2fsm --out-type=moore-dfa would print for the same machine."""
    trans = {
        (src, iw): dst
        for src, arcs in aut.edges.items()
        for (iw, dst) in arcs
    }
    max_iw = max((iw for (_s, iw) in trans), default=0)
    d = TextDfa(
        max_state=aut.n_states - 1,
        max_iw=max_iw,
        initial=aut.initial,
        finals=[s for s in range(aut.n_states) if aut.final[s]],
        trans=trans,
    )
    for s in range(aut.n_states):
        if aut.state_ow[s] != -1:
            d.state_ow[s] = int(aut.state_ow[s])
    if aut.state_ows is not None:
        d.state_ows = {s: list(v) for s, v in aut.state_ows.items() if v}
    return d


def from_min_dfa(n_states: int, final, edges: dict,
                 mph_ows: dict | None = None) -> TextDfa:
    """compiler.mindfa (Daciuk builder) output -> TextDfa (initial = 0).

    edges: {src: [(iw, dst)]};  mph_ows: assign_mph_ows' {src: [(iw, dst,
    ow)]} for the Mealy MPH."""
    trans = {
        (src, iw): dst
        for src, arcs in edges.items()
        for (iw, dst) in arcs
    }
    d = TextDfa(
        max_state=n_states - 1,
        max_iw=max((iw for (_s, iw) in trans), default=0),
        initial=0,
        finals=[s for s in range(n_states) if final[s]],
        trans=trans,
    )
    if mph_ows:
        d.arc_ow = {
            (src, iw): ow
            for src, row in mph_ows.items()
            for (iw, _dst, ow) in row
            if ow != -1
        }
    return d
