"""Share of the documents sent that took the fallback patch
(Counters.fallback_docs), %."""

from tb.readers import fallback_pct


def read(rec):
    return fallback_pct(rec, "corpus")
