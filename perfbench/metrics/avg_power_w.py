"""The card's NVML energy over the window's seconds."""


def compute(rec):
    return rec["joules"] / rec["window_s"]
