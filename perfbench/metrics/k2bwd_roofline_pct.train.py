"""K2-bwd's share of its roofline in training: the least time of every
weight-sums launch of the traced steps (two a SFConv and step;
``roofline.k2bwd_bound_ms``) over the device time of the group "weight
sums"."""

KIND = "train"
BOUND = "k2bwd_bound_ms_per_unit"
GROUPS = ("weight sums (K2-bwd, K3-bwd, K4-bwd)",)


def read(rec):
    t = rec["trace"]
    if rec["kind"] != KIND or not t.get("units"):
        return None
    ms = sum(t["groups_ms"].get(g, 0.0) for g in GROUPS)
    if not ms:
        return None
    return 100.0 * rec[BOUND] * t["units"] / ms
