"""Host ms a MiB of the stages "call.split" (the bytes conversion and the
batching by bytes) and "call.join" (the joining of the batches' ids and
bounds) of the corpus call (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "call.split", "call.join")
