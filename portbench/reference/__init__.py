"""The benchmark's plain reference: float32 PyTorch, TF32 off, nothing of the
measured package. ``strict()`` turns TF32 off for matrix products and cuDNN."""

import torch


def strict() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
