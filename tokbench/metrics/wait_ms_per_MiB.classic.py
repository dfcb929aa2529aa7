"""Host ms a MiB of the classic doc rows' stage "collect.wait": the host
blocked on a batch's event, waiting for the card (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "collect.wait")
