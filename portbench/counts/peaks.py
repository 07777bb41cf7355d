"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit): the denominators of every roofline and peak share."""

BF16_FLOP_PER_S = 989e12  # tensor cores, bf16 / fp16
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
