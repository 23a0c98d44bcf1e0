"""Model FLOPs utilisation of the training window: the FLOPs of the steps
completed (6 forwards of the reference model per step and rank, convolutions
and matrix products only, ``roofline.model_work``) over the window's seconds
and the bf16 peak of the cards."""


def read(rec):
    if rec["kind"] != "train" or not rec["window"]["seconds"]:
        return None
    w = rec["window"]
    flops = rec["flops_per_unit"] * w["steps"] * rec["chips"]
    return 100.0 * flops / w["seconds"] / (rec["peak_flops"] * rec["chips"])
