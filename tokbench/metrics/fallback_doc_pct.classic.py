"""Share of the documents sent that took the native fallback
(Counters.fallback_docs), %, on the classic doc rows."""

from tb.readers import fallback_pct


def read(rec):
    return fallback_pct(rec, "corpus")
