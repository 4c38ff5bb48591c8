"""Conv, transposed conv and dense layers that compute in a set dtype,
and flax's LayerNorm and GroupNorm.

Flax's ``nn.Conv``/``nn.ConvTranspose``/``nn.Dense``/``nn.DenseGeneral``
with ``dtype=bfloat16`` keep float32 parameters and cast the input,
kernel and bias to bfloat16 for the computation.  These subclasses do
the same, so the port holds float32 weights (the JAX checkpoint's) and
runs in the config's ``TPU.COMPUTE_DTYPE``.  A ``Linear`` with
``heads_out`` (or ``heads_in``) stands for a ``DenseGeneral`` whose
flax kernel splits its output (or input) into that many heads:
``[in, H, D]`` (or ``[H, D, out]``); ``bridge.py`` reshapes it.
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
    def __init__(self, *args, dtype: torch.dtype = torch.float32, heads_out: int = 0,
                 heads_in: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype
        self.heads_out = heads_out
        self.heads_in = heads_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class LayerNorm(nn.LayerNorm):
    """Flax's ``nn.LayerNorm`` with float32 ``scale`` and ``bias`` and no
    ``dtype``: the statistics and the result are float32 whatever the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """Flax's ``nn.GroupNorm`` (32 groups of contiguous channels) with
    float32 ``scale`` and ``bias`` and no ``dtype``: the statistics and
    the result are float32 whatever the input's dtype.  NCHW input."""

    def __init__(self, num_channels: int, eps: float = 1e-6, num_groups: int = 32):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias, self.eps)
