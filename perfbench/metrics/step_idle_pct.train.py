"""Share of the program's train steps (span ``ud.train.step``) in which the
card ran no kernel, copy or memset, in the light traced window."""

from perfbench.spans import span_stat


def read(rec):
    idle = span_stat(rec, "ud.train.step", "idle_ms")
    wall = span_stat(rec, "ud.train.step", "wall_ms")
    if rec["kind"] != "train" or not wall:
        return None
    return 100.0 * idle / wall
