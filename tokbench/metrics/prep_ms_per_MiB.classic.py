"""Host ms a MiB of the classic doc rows' stage "dispatch.prep": native
prep of a batch's documents into rows of symbol weights, inside
"dispatch" (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "dispatch.prep")
