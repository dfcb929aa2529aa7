"""Host ms a MiB of "fallback.native": the native TextToIds calls (or the
scalar oracle) of the fallback documents, each timed alone and summed a
batch, inside the stage "fallback" (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "fallback.native")
