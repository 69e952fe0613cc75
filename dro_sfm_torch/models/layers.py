"""Convolution and BatchNorm layers with the JAX package's dtype policy.

A flax ``nn.Conv(dtype=...)`` keeps fp32 parameters and casts its input,
kernel and bias to the compute dtype on every call; `Conv2d` does the same.
`BatchNorm2d` follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
it normalises in fp32 and returns the input's dtype, with the running
statistics in eval mode and the batch's in train mode. Weights are drawn
from a ``torch.Generator``: He-normal (truncated at two standard deviations,
flax's ``he_normal``) for convolutions, zeros for biases.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's truncated normal scales by 1/std of a unit normal cut at +-2.
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in ``dtype`` (default padding k // 2)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=None, bias: bool = True, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype
        fan_in = cin * kernel[0] * kernel[1]
        std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5) in fp32, returning the input dtype, with flax's
    train-mode semantics.

    Train mode takes the batch mean and the *biased* variance over N, H and
    W in fp32, as flax does (``E[x^2] - E[x]^2`` clipped at 0), normalises
    with them, and updates ``running = 0.9 * running + 0.1 * batch``. Torch's
    own ``F.batch_norm(training=True)`` would put the unbiased variance into
    ``running_var``, so the update is written out here.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum               # flax's momentum 0.9
            self.running_mean.copy_(keep * self.running_mean
                                    + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
