"""Arithmetic that several metric readers share."""
from perfbench.lib import peaks, profile

DECODE_KERNELS = ("decode_kernel", "decode_wide_kernel", "combine_kernel")


def decode_step_ms(rec):
    """``(device_s - prefill_s) / decode_steps`` of the engine's counters
    over the window."""
    c = rec["counters"]
    if not c["decode_steps"]:
        return None
    return (c["device_s"] - c["prefill_s"]) / c["decode_steps"] * 1e3


def model_flops(ref, z, prompt_tokens, prompt_pairs, decode_tokens, decode_pairs):
    """2 x the parameters a token multiplies through x the tokens
    processed, plus attention at the lengths served, by the
    configuration's reference module ``ref``."""
    return (2 * ref.matmul_params(z) * (prompt_tokens + decode_tokens)
            + ref.attention_flops(z, prompt_pairs + decode_pairs))


def roofline_pct(rec, needles, least_s):
    """The least time over the traced kernels' own time, in percent; None
    where the trace holds none of them or no work was counted."""
    t = rec.get("trace")
    if not t:
        return None
    ks = profile.kernel_seconds(t, needles)
    if ks <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / ks


def least_s(flop, byte):
    return max(flop / peaks.BF16_FLOPS, byte / peaks.HBM_BYTES)
