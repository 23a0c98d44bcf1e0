"""Device ms per training step of the optimizer's multi-tensor kernels
(``train/optim``, two updates a step)."""

KIND = "train"
GROUP = "optimizer (multi-tensor)"


def read(rec):
    t = rec["trace"]
    if rec["kind"] != KIND or not t.get("units"):
        return None
    ms = t["groups_ms"].get(GROUP, 0.0)
    return ms / t["units"] if ms else None
