"""Share of the traced window with no kernel or copy on the card, %."""

from tb.readers import idle_pct


def read(rec):
    return idle_pct(rec, "corpus")
