"""Float32 matmuls at full precision: TF32 off for the reference's
lifetime (the card would otherwise round matmul inputs to TF32)."""
from contextlib import contextmanager

import torch


@contextmanager
def tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
