"""Host ms per served batch in span ``ud.serve.stage``, the padded index
and the host copy to the card: its wall time in the light traced window
over its count, one a batch."""

from perfbench.spans import span_stat


def read(rec):
    ms = span_stat(rec, "ud.serve.stage", "wall_ms")
    if rec["kind"] != "serve" or ms is None:
        return None
    return ms / span_stat(rec, "ud.serve.stage", "count")
