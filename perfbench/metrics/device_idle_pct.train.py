"""Share of the traced window in which no kernel, copy or memset ran on the
card (rank 0), the union of their intervals taken, in training."""

KIND = "train"


def read(rec):
    t = rec["trace"]
    if rec["kind"] != KIND or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
