"""Convolution and BatchNorm layers with the JAX package's dtype policy.

A flax ``nn.Conv(dtype=...)`` keeps fp32 parameters and casts its input,
kernel and bias to the compute dtype on every call; `Conv2d` does the same.
`BatchNorm2d` normalises with its fp32 statistics and returns the input's
dtype. Weights are drawn from a ``torch.Generator``: He-normal (truncated at
two standard deviations, flax's ``he_normal``) for convolutions, zeros for
biases.
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
    """Eval-mode BatchNorm (eps 1e-5) in fp32, returning the input dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet (see ROADMAP.md)")
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            self.eps).to(x.dtype)
