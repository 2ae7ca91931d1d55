"""The share of the traced window in which no operation ran on the device
(CUPTI, through ``torch.profiler``)."""


def compute(rec):
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
