"""Units the native stitch sent to the fallback a flagged device row
(Counters.fallback_units over Counters.flagged_rows): 1 where the card
flags the unit that overflowed, the units of a row where it flags the
whole row; None where no row was flagged, or the program does not count
its fallback units."""

from tb import stages


def read(rec):
    rows = stages.counter(rec, "corpus", "flagged_rows")
    units = stages.counter(rec, "corpus", "fallback_units")
    if not rows or units is None:
        return None
    return units / rows
