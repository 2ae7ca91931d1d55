"""Model FLOP/s over the window against the H100's dense bf16 peak: 2 x
the parameters a token multiplies through x (prompt + output tokens
processed), plus attention at the lengths served."""
from perfbench.lib import peaks, readers


def compute(rec):
    w = rec["work"]
    f = readers.model_flops(rec["ref"], rec["config"], w.prompt_tokens,
                            w.prompt_pairs, w.decode_tokens, w.decode_pairs)
    return 100.0 * f / rec["window_s"] / peaks.BF16_FLOPS
