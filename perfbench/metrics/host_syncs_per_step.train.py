"""CUDA runtime calls that block the host (``perfbench.spans.is_sync``) per
train step, inside the ``ud.train.step`` spans of the light traced window."""

from perfbench.spans import span_stat


def read(rec):
    syncs = span_stat(rec, "ud.train.step", "syncs")
    steps = span_stat(rec, "ud.train.step", "count")
    if rec["kind"] != "train" or syncs is None:
        return None
    return syncs / steps
