"""Host ms per train step in span ``ud.train.backward``, the backwards of
both passes: its wall time in the light traced window over the
``ud.train.step`` spans."""

from perfbench.spans import span_stat


def read(rec):
    ms = span_stat(rec, "ud.train.backward", "wall_ms")
    steps = span_stat(rec, "ud.train.step", "count")
    if rec["kind"] != "train" or ms is None or not steps:
        return None
    return ms / steps
