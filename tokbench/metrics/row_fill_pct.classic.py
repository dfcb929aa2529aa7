"""Symbols over lanes of the classic rows launched
(Counters.classic_symbols over Counters.classic_lanes, a row's lanes its
width), %: the share of K1's and K2's lanes that hold a symbol."""

from tb import stages


def read(rec):
    lanes = stages.counter(rec, "corpus", "classic_lanes")
    syms = stages.counter(rec, "corpus", "classic_symbols")
    if not lanes or syms is None:
        return None
    return 100.0 * syms / lanes
