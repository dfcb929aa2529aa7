"""The card's time a MiB of input: profiled device ms of every kernel of
the window (all parts of an untraced run) over the MiB the window's calls
sent.  What the tokenizer takes from a card it shares with a model."""

from tb.readers import kernel_ms_per_mib


def read(rec):
    return kernel_ms_per_mib(rec, "corpus")
