"""Host ms per served batch in span ``ud.serve.forward``, the eval step's
launches (K1 and the forward): its wall time in the light traced window
over its count, one a batch."""

from perfbench.spans import span_stat


def read(rec):
    ms = span_stat(rec, "ud.serve.forward", "wall_ms")
    if rec["kind"] != "serve" or ms is None:
        return None
    return ms / span_stat(rec, "ud.serve.forward", "count")
