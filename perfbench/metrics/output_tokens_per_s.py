"""Every output token delivered in the window over the window's seconds."""


def compute(rec):
    return rec["work"].tokens / rec["window_s"]
