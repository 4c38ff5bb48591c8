"""Feature Pyramid Network neck.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/fpn.py::
FPN`` (:21-85): lateral 1x1 convs, the nearest-2x top-down merge (cropped
to the lateral's size for odd inputs), 3x3 output convs, and a top block:
``"maxpool"`` adds P6 as the kernel-1 stride-2 max pool of P5 (the
R-50-FPN detectors), ``"p6p7"`` adds P6 and P7 as stride-2 3x3 convs on
C5 (or on P5) and on relu(P6) (the RetinaNet body).  Module names are the flax scopes (``fpn_inner{i}``,
``fpn_layer{i}``, ``fpn_p6``, ``fpn_p7``), so ``bridge.py`` maps the
parameters by path.  ``use_gn`` (``MODEL.FPN.USE_GN``) follows each
lateral and output conv, which then has no bias, with a GroupNorm
(``fpn_inner{i}_gn``, ``fpn_layer{i}_gn``; 32 groups, flax's eps 1e-6,
float32 result) and ``use_relu`` (``USE_RELU``) with a ReLU; the top
block's convs take neither.  Only ``models/backbone.py::build_backbone``
passes them: no JAX detector does.

Features are ``[B, H, W, C]`` at the module's edges and run as NCHW
channels-last views inside, as ``models/resnet.py`` does.
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm

TOP_BLOCKS = ("maxpool", "p6p7")


class FPN(nn.Module):
    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256,
                 top_block: str = "maxpool", p6p7_on_c5: bool = True, dtype=torch.float32,
                 use_gn: bool = False, use_relu: bool = False):
        super().__init__()
        if top_block not in TOP_BLOCKS:
            raise ValueError(f"FPN top block {top_block!r}: one of {TOP_BLOCKS}")
        self.in_channels_list = tuple(in_channels_list)
        self.top_block = top_block
        self.p6p7_on_c5 = p6p7_on_c5
        self.use_gn, self.use_relu = use_gn, use_relu
        for i, cin in enumerate(self.in_channels_list, start=1):
            self.add_module(f"fpn_inner{i}", Conv2d(cin, out_channels, 1, bias=not use_gn, dtype=dtype))
            self.add_module(f"fpn_layer{i}", Conv2d(out_channels, out_channels, 3, padding=1, bias=not use_gn,
                                                    dtype=dtype))
            if use_gn:
                self.add_module(f"fpn_inner{i}_gn", GroupNorm(out_channels))
                self.add_module(f"fpn_layer{i}_gn", GroupNorm(out_channels))
        if top_block == "p6p7":
            p6_in = self.in_channels_list[-1] if p6p7_on_c5 else out_channels
            self.fpn_p6 = Conv2d(p6_in, out_channels, 3, stride=2, padding=1, dtype=dtype)
            self.fpn_p7 = Conv2d(out_channels, out_channels, 3, stride=2, padding=1, dtype=dtype)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        if self.use_gn:
            x = getattr(self, name + "_gn")(x)
        return F.relu(x) if self.use_relu else x

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``[C2, C3, C4, C5]`` (coarsest last), each ``[B, H, W, C]`` ->
        ``[P2 .. P5]`` plus the top block's levels, each ``[B, h, w,
        out_channels]``."""
        x = [f.permute(0, 3, 1, 2) for f in features]
        n = len(x)
        last_inner = self._block(f"fpn_inner{n}", x[-1])
        results = [self._block(f"fpn_layer{n}", last_inner)]
        for idx in range(n - 2, -1, -1):
            lateral = self._block(f"fpn_inner{idx + 1}", x[idx])
            th, tw = lateral.shape[2:]
            # nearest 2x: output (y, x) reads input (y // 2, x // 2)
            top_down = F.interpolate(last_inner, scale_factor=2, mode="nearest")
            last_inner = lateral + top_down[:, :, :th, :tw]
            results.insert(0, self._block(f"fpn_layer{idx + 1}", last_inner))
        if self.top_block == "maxpool":
            results.append(F.max_pool2d(results[-1], 1, stride=2))
        else:
            p6 = self.fpn_p6(x[-1] if self.p6p7_on_c5 else results[-1])
            results.extend([p6, self.fpn_p7(F.relu(p6))])
        return [r.permute(0, 2, 3, 1) for r in results]
