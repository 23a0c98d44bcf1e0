"""K2's share of its roofline in serving: the least time of every K2
launch of the traced batches (one a SFConv and batch) over the device time
of the groups "K2 channel mix" and "Hilbert rows"."""

KIND = "serve"
BOUND = "k2_bound_ms_per_unit"
GROUPS = ("K2 channel mix", "Hilbert rows (all SFConv kernels)")


def read(rec):
    t = rec["trace"]
    if rec["kind"] != KIND or not t.get("units"):
        return None
    ms = sum(t["groups_ms"].get(g, 0.0) for g in GROUPS)
    if not ms:
        return None
    return 100.0 * rec[BOUND] * t["units"] / ms
