"""Device ms per served batch in kernels that no group of the frozen
``KERNEL_GROUPS`` names: the eager glue of ``models/*``."""

KIND = "serve"
GROUP = "elementwise and other"


def read(rec):
    t = rec["trace"]
    if rec["kind"] != KIND or not t.get("units"):
        return None
    ms = t["groups_ms"].get(GROUP, 0.0)
    return ms / t["units"] if ms else None
