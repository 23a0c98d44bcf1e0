"""K2's share of its roofline in training: the least time of every K2
launch of the traced steps (four a SFConv and step: two forwards, two x̄;
``roofline.k2_bound_ms`` at the SFConv shapes of the reference model) over
the device time of the groups "K2 channel mix" and "Hilbert rows"."""

KIND = "train"
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
