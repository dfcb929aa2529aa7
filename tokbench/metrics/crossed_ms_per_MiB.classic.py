"""Host ms a MiB of the stage "chunk.crossed": the NumPy walk that finds
the ▁ no vocabulary match crosses in the documents past the window, inside
"chunk" (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "chunk.crossed")
