"""The port stands alone: importing spotter_tpu_torch pulls in neither jax
nor anything of the JAX package or of the repository's root `tools/` (the
JAX package's measurement tools), nor `transformers` or `safetensors` (the
card's machine has neither: the port reads checkpoints itself), and no
module of it names any of them."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "spotter_tpu", "tools", "transformers", "safetensors")
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


# the OWL slice's modules: the model, the class-logit kernel's wrapper, the
# token ids and the text cache
OWL_MODULES = (
    "spotter_tpu_torch.models.owlvit",
    "spotter_tpu_torch.ops.openvocab",
    "spotter_tpu_torch.convert.tokens",
    "spotter_tpu_torch.caching.keys",
    "spotter_tpu_torch.caching.text_cache",
)


# the Deformable-DETR slice's modules: the model (with the ResNet "v1"
# style and the shortest-edge preprocess in existing modules), and the
# sep and lane-gather kernels' wrappers in ops.msda
DEFORMABLE_MODULES = (
    "spotter_tpu_torch.models.deformable_detr",
    "spotter_tpu_torch.models.resnet",
    "spotter_tpu_torch.ops.msda",
    "spotter_tpu_torch.ops.preprocess",
)


# the DETR-lineage slice's modules: DETR with Table-Transformer,
# Conditional-DETR and DAB-DETR
DETR_LINEAGE_MODULES = (
    "spotter_tpu_torch.models.detr",
    "spotter_tpu_torch.models.conditional_detr",
    "spotter_tpu_torch.models.dab_detr",
)


# the checkpoint slice's modules: the weight-file reader and writer, the
# config.json view, the rule tables, the loader, and the fixture that
# writes a port model as a checkpoint
CONVERT_MODULES = (
    "spotter_tpu_torch.convert.checkpoint_io",
    "spotter_tpu_torch.convert.hf_config",
    "spotter_tpu_torch.convert.rules",
    "spotter_tpu_torch.convert.loader",
    "spotter_tpu_torch.convert.rtdetr_rules",
    "spotter_tpu_torch.convert.yolos_rules",
    "spotter_tpu_torch.convert.owlvit_rules",
    "spotter_tpu_torch.convert.deformable_detr_rules",
    "spotter_tpu_torch.convert.detr_rules",
    "spotter_tpu_torch.convert.conditional_detr_rules",
    "spotter_tpu_torch.convert.dab_detr_rules",
    "spotter_tpu_torch.tools.hf_checkpoint",
)


# the probes slice's modules: the three measurement tools with their
# kernels' wrappers, and the timing they share
PROBE_MODULES = (
    "spotter_tpu_torch.tools.timing",
    "spotter_tpu_torch.tools.bench_int8",
    "spotter_tpu_torch.tools.bench_pack_probe",
    "spotter_tpu_torch.tools.profile_r101",
)


# the int8 slice's modules: the knobs and plain versions, the kernels'
# wrappers, and the conv probe
INT8_MODULES = (
    "spotter_tpu_torch.utils.quant",
    "spotter_tpu_torch.ops.int8",
    "spotter_tpu_torch.tools.bench_int8_conv",
)


# the engine slice's modules: the CUDA graphs, the profiler and the perf
# ledger (the port's own copy of spotter_tpu/obs/perf.py, which is
# stdlib-only there and still not imported)
ENGINE_MODULES = (
    "spotter_tpu_torch.engine.graphs",
    "spotter_tpu_torch.engine.profiler",
    "spotter_tpu_torch.obs",
    "spotter_tpu_torch.obs.perf",
)


def test_every_int8_module_is_covered():
    assert set(INT8_MODULES) <= set(MODULES)


def test_every_engine_module_is_covered():
    assert set(ENGINE_MODULES) <= set(MODULES)


def test_every_probe_module_is_covered():
    assert set(PROBE_MODULES) <= set(MODULES)


def test_every_serving_module_is_covered():
    assert set(SERVING_MODULES) <= set(MODULES)


def test_every_yolos_module_is_covered():
    assert set(YOLOS_MODULES) <= set(MODULES)


def test_every_owl_module_is_covered():
    assert set(OWL_MODULES) <= set(MODULES)


def test_every_deformable_module_is_covered():
    assert set(DEFORMABLE_MODULES) <= set(MODULES)


def test_every_detr_lineage_module_is_covered():
    assert set(DETR_LINEAGE_MODULES) <= set(MODULES)


def test_every_convert_module_is_covered():
    assert set(CONVERT_MODULES) <= set(MODULES)


def test_msda_backend_kernels_run_only_on_cuda_tensors(monkeypatch):
    """On CPU tensors the sep and lane-gather wrappers compute their plain
    versions and neither build nor launch a kernel; other devices raise."""
    import torch

    from spotter_tpu_torch.ops import msda

    builds = []
    monkeypatch.setattr(msda, "build_msda_backends_kernel", lambda: builds.append(1))
    loc, attn = torch.full((1, 3, 1, 2, 2), 0.5), torch.full((1, 3, 1, 2), 0.5)
    ops, mask, r_band = msda.sep_level_operands(loc, attn, 4, 4)
    rows = torch.ones(1, 16, 8)
    out = msda.msda_sep_sum(rows, *ops, mask, (4, 4), r_band, 2)
    assert out.shape == (1, 64, 8) and torch.allclose(out[0, :3], torch.ones(3, 8))
    idx, w = msda.prepare_msda_gather_lanes(loc, attn, ((4, 4),), 2)
    value = torch.ones(1, 16, 1, 8)
    assert torch.allclose(msda.msda_hd_gather_sum(value, idx, w, 2, 3), torch.ones(1, 3, 1, 8))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        msda.msda_hd_gather_sum(value.to("meta"), idx.to("meta"), w.to("meta"), 2, 3)
    assert builds == []
    assert msda.msda_sep_sum.launches == msda.msda_hd_gather_sum.launches == 0


def test_class_logit_kernel_runs_only_on_cuda_tensors(monkeypatch):
    """On CPU tensors the wrapper computes the plain version and neither
    builds nor launches the kernel; any other device raises; mixed devices
    raise."""
    import torch

    from spotter_tpu_torch.ops import openvocab

    builds = []
    monkeypatch.setattr(openvocab, "build_class_logits_kernel", lambda: builds.append(1))
    args = (torch.ones(1, 2, 4), torch.ones(3, 4) / 2, torch.zeros(1, 2), torch.zeros(1, 2))
    before = openvocab.owl_class_logits.launches
    out = openvocab.owl_class_logits(*args)
    assert out.shape == (1, 2, 3) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        openvocab.owl_class_logits(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="queries is on meta"):
        openvocab.owl_class_logits(args[0], args[1].to("meta"), *args[2:])
    assert builds == [] and openvocab.owl_class_logits.launches == before


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
