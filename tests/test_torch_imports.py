"""The port and chip_smoke.py import nothing of JAX, flax or the JAX package.

Read from the sources with ``ast``, not from ``sys.modules``: the
interpreter here may import jax at start-up.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffuvolume_tpu")
FILES = sorted((ROOT / "diffuvolume_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_an_import():
    src = "import jax.numpy as jnp\nfrom diffuvolume_tpu.models import acv\n"
    bad = [n for n in _imported(ast.parse(src)) if n.split(".")[0] in FORBIDDEN]
    assert bad == ["jax.numpy", "diffuvolume_tpu.models"]


@pytest.mark.parametrize("module", [
    "models/pcw.py", "models/pcw_fold.py", "ops/sampling.py", "ops/kernels/depthwise.py",
    "ops/kernels/gwc_volume.py", "ops/kernels/fused_head.py", "tools/weights.py",
    "tools/random_weights.py", "eval/pipeline.py",
])
def test_pcw_slice_modules_are_checked(module):
    """The PCW slice's modules are among the files checked above."""
    assert ROOT / "diffuvolume_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "models/igev/__init__.py", "models/igev/extractor.py", "models/igev/update.py",
    "models/igev/geometry.py", "models/igev/model.py", "models/igev/gev_fold.py",
    "ops/kernels/layout.py", "ops/kernels/conv3d_fold.py", "ops/kernels/conv3d_up.py",
    "diffusion/ddim.py", "tools/profile_acv.py",
])
def test_igev_slice_modules_are_checked(module):
    """The IGEV slice's modules are among the files checked above."""
    assert ROOT / "diffuvolume_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "ops/kernels/conv2d.py", "models/pcw_fold.py", "models/pcw.py", "models/layers.py",
    "ops/kernels/conv3d_fold.py", "eval/pipeline.py", "tools/profile_acv.py",
])
def test_row_15_and_18_modules_are_checked(module):
    """The modules of the refinement's and the packed conv's slice are among
    the files checked above."""
    assert ROOT / "diffuvolume_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", [
    "config.py", "train/__init__.py", "train/loss.py", "train/lr.py", "train/loop.py",
    "train/checkpoint.py", "cli/train.py", "utils/logger.py", "utils/visualization.py",
])
def test_training_slice_modules_are_checked(module):
    """The training slice's modules are among the files checked above."""
    assert ROOT / "diffuvolume_tpu_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_orbax_imports(path):
    """Nor orbax, the JAX package's checkpoint library: the port's
    checkpoints are ``torch.save`` files."""
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    assert not [n for n in names if n.split(".")[0] == "orbax"], path
