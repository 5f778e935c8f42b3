"""The port stands alone: importing spotter_tpu_torch pulls in neither jax
nor anything of the JAX package, and no module of it names either."""

import ast
import pathlib
import subprocess
import sys

import pytest

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "spotter_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PACKAGE.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "flax", "spotter_tpu")
# the serving slice's modules: each is imported (and scanned) below
SERVING_MODULES = (
    "spotter_tpu_torch.schemas",
    "spotter_tpu_torch.engine.errors",
    "spotter_tpu_torch.engine.metrics",
    "spotter_tpu_torch.engine.scheduler",
    "spotter_tpu_torch.engine.batcher",
    "spotter_tpu_torch.serving.resilience",
    "spotter_tpu_torch.serving.overload",
    "spotter_tpu_torch.serving.detector",
    "spotter_tpu_torch.serving.lifecycle",
    "spotter_tpu_torch.serving.app",
    "spotter_tpu_torch.serving.standalone",
)


# the YOLOS slice's modules: the model, and the attention kernel's wrapper
YOLOS_MODULES = (
    "spotter_tpu_torch.models.yolos",
    "spotter_tpu_torch.ops.attention",
)


def test_every_serving_module_is_covered():
    assert set(SERVING_MODULES) <= set(MODULES)


def test_every_yolos_module_is_covered():
    assert set(YOLOS_MODULES) <= set(MODULES)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True, text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_names_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_imports_no_jax():
    path = PACKAGE.parent / "chip_smoke.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"chip_smoke.py imports {name}"
