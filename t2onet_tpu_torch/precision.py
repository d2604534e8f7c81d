"""The port's one precision switch for the card."""

import torch


def set_cuda_precision():
    """f32 means f32 on the card: TF32 off for matmuls and for cuDNN's
    convolutions (PyTorch's default runs those in TF32), so that what an
    entry point computes on the card is what the CPU computes and the
    tests check. Process-wide, like the flags it sets."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
