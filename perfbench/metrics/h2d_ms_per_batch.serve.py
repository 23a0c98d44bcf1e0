"""Device time of host-to-device copies per served batch, in the traced
cycle."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "serve" or not t.get("units") or not t.get("h2d_ms"):
        return None
    return t["h2d_ms"] / t["units"]
