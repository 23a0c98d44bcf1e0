"""Share of the batch slots that the program ran padded, over the timed
window: 100 (slots - frames) / slots of ``Predictor.counts``."""


def read(rec):
    counts = rec.get("counts")
    if rec["kind"] != "serve" or not counts or not counts.get("slots"):
        return None
    return 100.0 * (counts["slots"] - counts["frames"]) / counts["slots"]
