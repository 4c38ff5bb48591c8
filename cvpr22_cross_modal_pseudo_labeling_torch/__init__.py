"""PyTorch/CUDA port of cvpr22_cross_modal_pseudo_labeling_tpu for NVIDIA
Hopper (sm_90a).

Mirrors the JAX package's module layout so each module's counterpart is
found at the same relative path.  Public functions keep the JAX layouts
(NHWC uint8 images, ``[B, H, W, C]`` features, xyxy boxes with the legacy
+1).  The hot ops that the JAX package ran as TPU kernels (NMS, RoIAlign)
are hand-written CUDA kernels under ``csrc/``; every kernel wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel for
CUDA tensors.

This package imports torch and numpy only, never jax or the JAX package.
"""

__version__ = "0.1.0"
