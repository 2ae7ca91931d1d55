"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Every roofline share and MFU is
stated against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12      # dense bf16 / fp16 tensor-core FLOP/s
HBM_BYTES = 3.35e12      # HBM3 bytes/s
