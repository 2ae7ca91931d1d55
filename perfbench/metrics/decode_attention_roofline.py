"""Decode attention's share of its roofline in the traced window: the least
time to read the valid cached rows of the active slots, their queries and
write their outputs, once each (or their operations, if more), as the
configuration's reference module counts them, over the decode-attention
kernels' profiler time."""
from perfbench.lib import readers


def compute(rec):
    ref, z, w = rec["ref"], rec["config"], rec["work"]
    least = readers.least_s(ref.attention_flops(z, w.decode_pairs),
                            ref.decode_attention_bytes(z, w.kv_rows, w.decode_tokens))
    return readers.roofline_pct(rec, readers.DECODE_KERNELS, least)
