"""The port stands alone: no JAX, nothing of the JAX package, no library kernels.

An AST scan of ``src/repro_torch/**`` and ``chip_smoke.py`` finds no import of
``jax``, ``jaxlib`` or ``repro.*``, and no call into
``scaled_dot_product_attention`` or ``torch.compile``.  The chip smoke script
may time such a call as a yardstick, and is held to the import rule only.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"
BANNED_MODULES = ("jax", "jaxlib", "repro")
BANNED_CALLS = ("scaled_dot_product_attention", "torch.compile")


def _imports(tree: ast.AST) -> list[str]:
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _dotted_names(tree: ast.AST) -> set[str]:
    """Every name and attribute chain in the source, as ``a.b.c`` and its tail ``c``."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            parts = [node.attr]
            value = node.value
            while isinstance(value, ast.Attribute):
                parts.append(value.attr)
                value = value.value
            if isinstance(value, ast.Name):
                parts.append(value.id)
            names.add(".".join(reversed(parts)))
            names.add(node.attr)
    return names


def test_port_sources_found():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT}
    assert "repro_torch/models/lm.py" in names and "repro_torch/kernels/ops.py" in names
    for module in ("core/stripestore.py", "core/simclock.py", "fs/vfs.py", "fs/dataset.py",
                   "train/hoardckpt.py", "launch/mesh.py", "train/sync.py",
                   "serve/flash_decoding.py"):
        assert f"repro_torch/{module}" in names
    assert SMOKE.is_file()


@pytest.mark.parametrize("path", PORT + [SMOKE], ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imports(tree):
        top = mod.split(".")[0]
        assert top not in BANNED_MODULES, f"{path.name} imports {mod}"


@pytest.mark.parametrize("path", PORT, ids=lambda p: p.relative_to(ROOT / "src").as_posix())
def test_no_library_attention_or_compile(path):
    names = _dotted_names(ast.parse(path.read_text(), filename=str(path)))
    for banned in BANNED_CALLS:
        assert banned not in names, f"{path.name} uses {banned}"


def test_no_fallback_around_kernel_launches():
    """No ``try`` in the kernel package: a failed build or launch raises."""
    for path in (ROOT / "src" / "repro_torch" / "kernels").glob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path.name
