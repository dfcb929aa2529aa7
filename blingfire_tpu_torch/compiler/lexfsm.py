# Copy of blingfire_tpu/compiler/lexfsm.py, kept here so that this package imports nothing of the JAX package.
"""Position-NFA construction, alphabet classing and Moore DFA for lex rules.

Implements the automata algebra of the reference pipeline
(FARegexp2Nfa --keep-pos, fa_fsm2fsm_iwec, fa_nfa2dfa --spec-any=0,
fa_dfa2mindfa, fa_fsm2fsm --out-type=moore-dfa) directly over interval
character classes:

  - Glushkov position NFA per rule group; group finals carry the group id
  - global alphabet partition: atomic intervals by leaf-set signature
  - subset construction where IW_ANY edges mean "any other": dest(S, c) =
    move_c(S) | move_any(S); runtime exact-then-ANY lookup reproduces this
  - Moore minimization with initial partition by state Ow (min group id on
    conflicts — the reference encodes group ids as special input weights and
    takes the smallest, FANfas2CommonENfa.cpp:231-275)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .relex import MAX_CP, Node, iv_norm

ANY = 0
IW_LA = 1
IW_RA = 2


@dataclass
class Leaf:
    pid: int
    ivs: tuple  # interval set (empty for ANY)
    is_any: bool = False
    neg: bool = False


def _glushkov(node: Node, leaves: list[Leaf]):
    """Returns (nullable, first, last, follow-updates applied via closure)."""
    k = node.kind
    if k in ("sym", "any", "la", "ra"):
        if k == "sym":
            leaf = Leaf(len(leaves), node.ivs, neg=node.neg)
        elif k == "any":
            leaf = Leaf(len(leaves), (), is_any=True)
        elif k == "la":
            leaf = Leaf(len(leaves), ((IW_LA, IW_LA),))
        else:
            leaf = Leaf(len(leaves), ((IW_RA, IW_RA),))
        leaves.append(leaf)
        p = {leaf.pid}
        return False, p, p, []
    if k in ("cat",):
        nullable = True
        first: set[int] = set()
        last: set[int] = set()
        follows = []
        for ch in node.children:
            n2, f2, l2, fo2 = _glushkov(ch, leaves)
            follows.extend(fo2)
            follows.extend((lp, fp) for lp in last for fp in f2)
            if nullable:
                first |= f2
            if n2:
                last |= l2
            else:
                last = l2
            nullable = nullable and n2
        return nullable, first, last, follows
    if k == "alt":
        nullable = False
        first = set()
        last = set()
        follows = []
        for ch in node.children:
            n2, f2, l2, fo2 = _glushkov(ch, leaves)
            nullable = nullable or n2
            first |= f2
            last |= l2
            follows.extend(fo2)
        return nullable, first, last, follows
    if k in ("star", "plus", "opt"):
        n2, f2, l2, fo2 = _glushkov(node.children[0], leaves)
        follows = list(fo2)
        if k in ("star", "plus"):
            follows.extend((lp, fp) for lp in l2 for fp in f2)
        nullable = n2 or k in ("star", "opt")
        return nullable, f2, l2, follows
    if k == "trbr":
        return _glushkov(node.children[0], leaves)
    raise ValueError(f"bad node {k}")


@dataclass
class LexAutomaton:
    n_states: int
    initial: int
    final: np.ndarray  # bool
    state_ow: np.ndarray  # int32, -1 none (group/action id)
    edges: dict[int, list[tuple[int, int]]]  # src -> [(class_iw, dst)]
    class_ivs: list[tuple]  # class_iw -> interval set of ORIGINAL iws
    n_classes: int
    # full reaction sets per state (multi_ows mode only; else None) — the
    # reference keeps ALL matched rule ids for multi-Moore automata
    # (fa_fsm2fsm --out-type=moore-mdfa path) instead of min-resolution
    state_ows: dict[int, list[int]] | None = None


def build_lex_automaton(groups, multi_ows: bool = False) -> LexAutomaton:
    # 1. Glushkov over combined root: alt over groups with distinct finals.
    # Each group keeps its OWN initial (fa_nfalist2nfa merges rule NFAs with
    # one initial state per rule, doc/tools.txt:240-262 sample 5), so the
    # spec-any "explicit entry shadows my ANY route" rule applies per RULE at
    # the start state, not across rules (FANfa2Dfa_t.h:555-635 appends a
    # state's AnyDst for exactly the iws THAT state lacks).
    leaves: list[Leaf] = []
    first_all: set[int] = set()
    group_firsts: list[set[int]] = []
    follow: dict[int, set[int]] = {}
    leaf_group: dict[int, int] = {}  # last-positions -> group id
    group_final_leaves: list[tuple[int, int]] = []  # (leaf, group)

    for gid, g in enumerate(groups):
        root = Node("alt", children=g.variants) if len(g.variants) > 1 else g.variants[0]
        base = len(leaves)
        nullable, first, last, follows = _glushkov(root, leaves)
        if nullable:
            raise ValueError(f"group {gid} accepts the empty string")
        first_all |= first
        group_firsts.append(first)
        for a, b in follows:
            follow.setdefault(a, set()).add(b)
        for lp in last:
            group_final_leaves.append((lp, gid))

    n_pos = len(leaves)
    final_of_leaf = np.full(n_pos, -1, np.int64)
    for lp, gid in group_final_leaves:
        if final_of_leaf[lp] == -1 or gid < final_of_leaf[lp]:
            final_of_leaf[lp] = gid

    # 2. alphabet partition: atomize interval boundaries by signature
    # only codepoints >= 3 participate in classing (iw 0/1/2 are special)
    pts = set()
    for lf in leaves:
        for lo, hi in lf.ivs:
            pts.add(lo)
            pts.add(hi + 1)
    pts |= {0, 1, 2, 3, MAX_CP + 1}
    bounds = sorted(pts)
    atoms = [
        (bounds[i], bounds[i + 1] - 1)
        for i in range(len(bounds) - 1)
        if bounds[i] <= MAX_CP
    ]
    # signature per atom = frozenset of leaf pids covering it
    cover: dict[tuple[int, int], list[int]] = {a: [] for a in atoms}
    import bisect

    atom_starts = [a[0] for a in atoms]
    for lf in leaves:
        for lo, hi in lf.ivs:
            i0 = bisect.bisect_left(atom_starts, lo)
            i = i0
            while i < len(atoms) and atoms[i][0] <= hi:
                cover[atoms[i]].append(lf.pid)
                i += 1
    # the anchor weights always get dedicated classes (negated ranges must be
    # able to block them even when no rule references ^/$ directly)
    if (1, 1) in cover:
        cover[(1, 1)].append(-101)
    if (2, 2) in cover:
        cover[(2, 2)].append(-102)
    sig2class: dict[frozenset, int] = {}
    class_ivs: list[list[tuple[int, int]]] = [[]]  # class 0 = ANY (chars with no explicit leaf)
    atom_class: dict[tuple[int, int], int] = {}
    for a in atoms:
        sig = frozenset(cover[a])
        if not sig:
            atom_class[a] = ANY  # unseen chars: no explicit mapping
            continue
        c = sig2class.get(sig)
        if c is None:
            c = len(class_ivs)
            sig2class[sig] = c
            class_ivs.append([])
        class_ivs[c].append(a)
        atom_class[a] = c
    n_classes = len(class_ivs)

    # leaf -> list of class ids (ANY leaves handled separately)
    leaf_classes: dict[int, list[int]] = {}
    for lf in leaves:
        cs = set()
        for lo, hi in lf.ivs:
            i0 = bisect.bisect_left(atom_starts, lo)
            i = i0
            while i < len(atoms) and atoms[i][0] <= hi:
                cs.add(atom_class[atoms[i]])
                i += 1
        leaf_classes[lf.pid] = sorted(cs)

    # 3. subset construction with per-position IW_ANY-as-other semantics:
    # from position p, input class c reaches p's explicitly-c-labeled
    # successors when any exist (the explicit entry SHADOWS p's ANY route,
    # which is how `.` means "any OTHER" and how negated classes block,
    # FANfaCreator_char.cpp:170-186 + the runtime exact-then-ANY lookup)
    la_class = atom_class.get((1, 1), ANY)
    ra_class = atom_class.get((2, 2), ANY)

    def targets(pset: frozenset):
        """Returns ({class: destset} for every class any position explicitly
        mentions or blocks, plus the pure-ANY destset).  Explicit entries
        shadow that position's ANY route; blocked (negated) entries kill it
        (FANfaCreator_char.cpp:170-186 + runtime exact-then-ANY lookup)."""
        per_p = []
        classes = set()
        any_all = set()
        for p in pset:
            # negative = virtual per-group initial marker (-1 - gid)
            succ = group_firsts[-1 - p] if p < 0 else follow.get(p, set())
            expl = {}
            blocked = set()
            any_t = set()
            for q in succ:
                lf = leaves[q]
                if lf.is_any:
                    any_t.add(q)
                elif lf.neg:
                    any_t.add(q)
                    blocked |= set(leaf_classes[q])
                    blocked.add(la_class)
                    blocked.add(ra_class)
                else:
                    for c in leaf_classes[q]:
                        expl.setdefault(c, set()).add(q)
            per_p.append((expl, blocked, any_t))
            classes |= set(expl) | blocked
            any_all |= any_t
        by_c = {}
        for c in classes:
            dst = set()
            for expl, blocked, any_t in per_p:
                if c in expl:
                    dst |= expl[c]
                elif c in blocked:
                    pass
                else:
                    dst |= any_t
            by_c[c] = dst
        return by_c, any_all

    state_of: dict[frozenset, int] = {}
    edges: dict[int, list[tuple[int, int]]] = {}
    ows: list[int] = []
    ows_sets: list[tuple[int, ...]] = []
    finals: list[bool] = []
    order: list[frozenset] = []

    # multi_ows keeps EVERY group id ending at a position, not just the min
    leaf_groups: dict[int, set[int]] = {}
    if multi_ows:
        for lp, gid in group_final_leaves:
            leaf_groups.setdefault(lp, set()).add(gid)

    def intern(pset: frozenset) -> int:
        s = state_of.get(pset)
        if s is None:
            s = len(order)
            state_of[pset] = s
            order.append(pset)
            gids = [int(final_of_leaf[p]) for p in pset if p >= 0 and final_of_leaf[p] != -1]
            ows.append(min(gids) if gids else -1)
            finals.append(bool(gids))
            if multi_ows:
                gs: set[int] = set()
                for p in pset:
                    if p >= 0:
                        gs |= leaf_groups.get(p, set())
                ows_sets.append(tuple(sorted(gs)))
        return s

    # virtual start: one marker per group = one NFA initial per rule
    start = intern(frozenset(-1 - gid for gid in range(len(groups))))

    qi = 0
    while qi < len(order):
        pset = order[qi]
        sid = qi
        qi += 1
        by_c, any_t = targets(pset)
        es = []
        if any_t:
            es.append((ANY, intern(frozenset(any_t))))
        for c, tset in sorted(by_c.items()):
            if not tset:
                continue  # fully blocked class with no targets: no edge,
                # but ANY fallback must ALSO not fire — needs a dead edge
            dst = intern(frozenset(tset))
            es.append((c, dst))
        # fully-blocked empty classes: explicit dead transition so the
        # runtime ANY fallback does not resurrect them
        for c, tset in sorted(by_c.items()):
            if not tset and any_t:
                es.append((c, -2))
        if es:
            edges[sid] = es

    n = len(order)
    final = np.array(finals)
    state_ow = np.array(ows, np.int32)

    # 4. Moore minimization (partition refinement over full class alphabet)
    sows = (
        {s: list(t) for s, t in enumerate(ows_sets) if t} if multi_ows else None
    )
    aut = LexAutomaton(
        n, start, final, state_ow, edges,
        [iv_norm(c) for c in class_ivs], n_classes, state_ows=sows,
    )
    return _minimize(aut)


def _minimize(aut: LexAutomaton) -> LexAutomaton:
    """Moore partition refinement with sparse signatures.

    A state's behavior is the total map class -> destination with the ANY
    edge as default; per round, explicit edges whose destination block equals
    the ANY block are dropped from the signature, making sparse signature
    equality equivalent to total-function equality."""
    n = aut.n_states

    def blk(part, d):
        if d >= 0:
            return part[d]
        return -1000 + d  # dead (-2) / none (-1) sentinels

    if aut.state_ows is not None:
        # partition by the FULL reaction set, not the min-resolved Ow
        key2id: dict[tuple, int] = {}
        part = np.zeros(n, np.int64)
        for s in range(n):
            key = tuple(aut.state_ows.get(s, ()))
            part[s] = key2id.setdefault(key, len(key2id))
    else:
        part = np.unique(aut.state_ow, return_inverse=True)[1].astype(np.int64)
    while True:
        sigs = {}
        new_part = np.zeros(n, np.int64)
        for s in range(n):
            es = aut.edges.get(s, ())
            any_b = -1001  # no ANY edge = no transition
            for c, d in es:
                if c == ANY:
                    any_b = blk(part, d)
            items = []
            for c, d in es:
                if c == ANY:
                    continue
                b = blk(part, d)
                if b != any_b:
                    items.append((c, b))
            items.sort()
            key = (int(part[s]), any_b, tuple(items))
            b = sigs.get(key)
            if b is None:
                b = len(sigs)
                sigs[key] = b
            new_part[s] = b
        if (new_part == part).all():
            break
        part = new_part

    # rebuild with representative states; keep initial as state 0
    n_blocks = int(part.max()) + 1
    remap = np.full(n_blocks, -1, np.int64)
    # choose representatives (first state of each block)
    reps = np.zeros(n_blocks, np.int64)
    seen = np.zeros(n_blocks, bool)
    for s in range(n):
        b = part[s]
        if not seen[b]:
            seen[b] = True
            reps[b] = s
    # block renumber: initial block = 0, then BFS for stable layout
    init_b = part[aut.initial]
    new_ids = {int(init_b): 0}
    bfs = [int(init_b)]
    i = 0
    while i < len(bfs):
        b = bfs[i]
        i += 1
        s = reps[b]
        for c, d in sorted(aut.edges.get(int(s), [])):
            if d < 0:
                continue
            db = int(part[d])
            if db not in new_ids:
                new_ids[db] = len(new_ids)
                bfs.append(db)
    n2 = len(new_ids)
    final2 = np.zeros(n2, bool)
    ow2 = np.full(n2, -1, np.int32)
    edges2: dict[int, list[tuple[int, int]]] = {}
    sows2: dict[int, list[int]] | None = (
        {} if aut.state_ows is not None else None
    )
    for b, nid in new_ids.items():
        s = int(reps[b])
        final2[nid] = aut.final[s]
        ow2[nid] = aut.state_ow[s]
        if sows2 is not None and s in aut.state_ows:
            sows2[nid] = aut.state_ows[s]
        es = []
        for c, d in sorted(aut.edges.get(s, [])):
            es.append((c, d if d < 0 else new_ids[int(part[d])]))
        if es:
            edges2[nid] = es
    return LexAutomaton(
        n2, 0, final2, ow2, edges2, aut.class_ivs, aut.n_classes,
        state_ows=sows2,
    )
