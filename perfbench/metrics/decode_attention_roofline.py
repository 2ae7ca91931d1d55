"""Decode attention's share of its roofline in the traced window: the least
time to read the valid K/V rows of the active slots, their queries and
write their outputs, once each (or their operations, if more), over the
decode-attention kernels' profiler time."""
from perfbench.lib import flops, readers


def compute(rec):
    z, w = rec["config"], rec["work"]
    least = readers.least_s(flops.attention_flops(z, w.decode_pairs),
                            flops.decode_attention_bytes(z, w.kv_rows, w.decode_tokens))
    return readers.roofline_pct(rec, readers.DECODE_KERNELS, least)
