"""fp32 products for bundle adjustment.

The JAX package pins matmul precision to "highest" inside every dense BA
entry point, because TPU matmuls with bf16 inputs turned convergence into
divergence. The counterpart on an NVIDIA card is TF32, which torch may use
for fp32 matmuls and cuDNN convolutions: `fp32_matmuls` turns it off for
the duration of a call and restores the caller's settings after.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmuls():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
