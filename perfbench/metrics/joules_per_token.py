"""The card's NVML energy counter over the window, per output token
delivered in it."""


def compute(rec):
    return rec["joules"] / rec["work"].tokens if rec["work"].tokens else None
