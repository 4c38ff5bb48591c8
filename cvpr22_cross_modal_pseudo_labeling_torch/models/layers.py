"""Conv, transposed conv and dense layers that compute in a set dtype.

Flax's ``nn.Conv``/``nn.ConvTranspose``/``nn.Dense`` with
``dtype=bfloat16`` keep float32 parameters and cast the input, kernel
and bias to bfloat16 for the computation.  These subclasses do the same,
so the port holds float32 weights (the JAX checkpoint's) and runs in the
config's ``TPU.COMPUTE_DTYPE``.
"""

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.conv_transpose2d(
            x.to(d), self.weight.to(d), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class Linear(nn.Linear):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))
