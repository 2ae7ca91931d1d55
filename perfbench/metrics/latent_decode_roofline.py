"""The MLA latent decode's share of its roofline in the traced window: the
least time to read the valid latent rows of the active slots, their
queries and write their outputs, once each (or their operations, if
more), as the configuration's reference module counts them, over the
latent decode kernels' profiler time.  A program without those kernels
(one that decodes MLA in einsum) reads nothing."""
from perfbench.lib import readers

LATENT_KERNELS = ("latent_attn_kernel", "latent_merge_kernel")


def compute(rec):
    ref, z, w = rec["ref"], rec["config"], rec["work"]
    least = readers.least_s(ref.attention_flops(z, w.decode_pairs),
                            ref.decode_attention_bytes(z, w.kv_rows, w.decode_tokens))
    return readers.roofline_pct(rec, LATENT_KERNELS, least)
