"""Share of the window's input bytes that the fallback re-tokenized, one
document at a time (Counters.fallback_bytes), %."""

from tb import stages


def read(rec):
    b = stages.counter(rec, "corpus", "fallback_bytes")
    return None if b is None else 100.0 * b / rec["bytes"]
