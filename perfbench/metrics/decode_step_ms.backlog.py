"""Decode step time from the engine's counters over the window:
``(device_s - prefill_s) / decode_steps``."""
from perfbench.lib import readers


def compute(rec):
    return readers.decode_step_ms(rec)
