"""Environment report and the label dump.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
env_info.py`` (reference utils/collect_env.py, utils/miscellaneous.py):
:func:`collect_env_info` reports torch, CUDA, each device and whether
``nvcc`` (which builds the port's kernels) is found; :func:`save_labels`
is copied.
"""

import json
import os
import platform
import sys


def collect_env_info() -> str:
    import numpy as np
    import torch

    from ..ops.kernels import _nvcc
    from .native import get_lib

    lines = [
        f"python: {sys.version.split()[0]} ({platform.platform()})",
        f"torch: {torch.__version__}  cuda: {torch.version.cuda}",
        f"numpy: {np.__version__}",
    ]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            major, minor = torch.cuda.get_device_capability(i)
            lines.append(f"device {i}: {torch.cuda.get_device_name(i)} (sm_{major}{minor})")
    else:
        lines.append("devices: no CUDA device")
    try:
        lines.append(f"nvcc: {_nvcc()}")
    except RuntimeError:
        lines.append("nvcc: not found")
    lines.append(f"native maskops: {'loaded' if get_lib() else 'unavailable'}")
    return "\n".join(lines)


def mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def save_labels(class_names, output_dir: str):
    """Dumps the category mapping (miscellaneous.py:17 save_labels)."""
    mkdir(output_dir)
    with open(os.path.join(output_dir, "labels.json"), "w") as f:
        json.dump({i: n for i, n in enumerate(class_names)}, f, indent=2)
