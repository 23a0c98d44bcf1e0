"""Model FLOPs utilisation of serving: the forward FLOPs of every frame
asked for in the window (padding not counted; convolutions and matrix
products only) over the seconds the card spent serving them (each request
from the start of its service to its score, its wait left out) and one
card's bf16 peak."""


def read(rec):
    if rec["kind"] != "serve" or not rec["window"]["service_s"]:
        return None
    w = rec["window"]
    return 100.0 * rec["flops_per_unit"] * w["frames"] / w["service_s"] / rec["peak_flops"]
