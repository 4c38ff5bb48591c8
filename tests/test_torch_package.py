"""The port stands alone: it imports neither jax/flax, nor grain, nor the
JAX package, and its kernel wrappers know how they were built."""

import ast
import pathlib
import subprocess
import sys

import cvpr22_cross_modal_pseudo_labeling_torch as port
from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

ROOT = pathlib.Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "grain", "cvpr22_cross_modal_pseudo_labeling_tpu")


def _modules():
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_sources_import_nothing_of_jax_or_the_jax_package():
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = [m for _, m in _modules()]
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_each_kernel_has_its_source_and_a_launch_counter():
    for k in kernels.ALL:
        text = k.source.read_text()
        assert "Replaces:" in text and "bounds it on the H100" in text
        for fn in k.entry_points:
            assert f'extern "C" int {fn}(' in text
        # a library per source: the RoIAlign backward's count shares the
        # forward's csrc/roi_align.cu
        assert k.launches >= 0 and k.library_path().name.startswith(f"lib{k.source.stem}-")
        assert k.name.startswith(k.source.stem)
    assert "-gencode" in kernels.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_the_serving_and_ablation_tools_and_the_custom_ops_import_with_jax_blocked():
    """The serving export and the ablation tool, and ``ops`` alone, which
    registers the kernels' custom ops (what a serving process imports)."""
    mods = ["cvpr22_cross_modal_pseudo_labeling_torch.tools.export_serving",
            "cvpr22_cross_modal_pseudo_labeling_torch.tools.ablate_st_e2e"]
    assert set(mods) <= {m for _, m in _modules()}
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms, roi_align\n"
        "ops = [torch.ops.cmpl.nms, torch.ops.cmpl.roi_align, torch.ops.cmpl.roi_align_levels,\n"
        "       torch.ops.cmpl.roi_align_backward]\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(ops))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok 4")
