"""Host ms a MiB of the stage "chunk": the documents past the window,
prepped whole, split at a ▁ that no match crosses and run as chunk rows
(Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "chunk")
