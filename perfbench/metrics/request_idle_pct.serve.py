"""Share of the program's requests (span ``ud.serve.request``, one
``Predictor.predict_frames`` call) in which the card ran no kernel, copy
or memset, in the light traced window."""

from perfbench.spans import span_stat


def read(rec):
    idle = span_stat(rec, "ud.serve.request", "idle_ms")
    wall = span_stat(rec, "ud.serve.request", "wall_ms")
    if rec["kind"] != "serve" or not wall:
        return None
    return 100.0 * idle / wall
