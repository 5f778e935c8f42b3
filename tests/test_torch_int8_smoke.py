"""chip_smoke.py's `int8` phase and tools/bench_int8_conv.py, rehearsed on
the CPU at the tiny width. The card run takes the models at full width and
launches the kernels; here each int8 wrapper computes its plain version,
and counting shims stand in for the launch counts (the rows and heads
quantize wrappers count one amax and one quantize pass, as their kernels
launch, but a heads call whose group fits one block, `heads_one_launch`,
one quantize launch alone; the convolution's `amax_samples` and
`nhwc_codes` one each; a dequant of any layout on `dequant_s32`; the
convolution on `conv_s8`).
The floors are lowered so that the tiny models' layers quantize
(INT8_MIN_CH 8, INT8_ATTN_MIN_HD 4; the batch floor stays 8, so B = 1 runs
the float path). The conv probe runs at tiny shapes on the CPU, and the
stage profile, which needs CUDA events, is stubbed.
"""

import json

import numpy as np
import pytest

from spotter_tpu_torch.ops import int8 as tint8
from spotter_tpu_torch.tools import bench_int8_conv
from spotter_tpu_torch.utils import quant as tquant
from tests.test_torch_precision_smoke import cpu_rehearsal  # noqa: F401  (a fixture)

TINY_SHAPES = (("tiny3", 2, 9, 7, 16, 8, 3, 1), ("tiny1", 2, 6, 6, 24, 40, 1, 1))


@pytest.fixture
def tiny_tool(monkeypatch):
    monkeypatch.setattr(bench_int8_conv, "SHAPES", TINY_SHAPES)
    monkeypatch.setattr(bench_int8_conv, "MAIN_SHAPE", "tiny3")
    monkeypatch.setattr(bench_int8_conv, "DENSE_SHAPE", (2, 5, 32, 24))
    monkeypatch.setattr(bench_int8_conv, "ATTN_SHAPE", (2, 7, 2, 16))
    monkeypatch.setattr(bench_int8_conv, "SERVED_CONVS", ((16, 24, 3, 2, 1), (24, 40, 1, 1, 0)))
    monkeypatch.setattr(bench_int8_conv, "SERVED_HW", (2, 7, 5))
    return bench_int8_conv


def test_bench_int8_conv_runs_on_the_cpu(tiny_tool, tmp_path, capsys):
    """Every case exact against the plain versions (here the wrappers take
    them too); host-clock times under *_cpu_ms; the calls it made."""
    out = tmp_path / "bench_int8_conv.json"
    assert tiny_tool.main(["--device", "cpu", "--iters", "1", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    parts = [c["part"] for c in record["cases"]]
    n_coverage = 4 * len(tiny_tool.COVERAGE)  # fp32 and bf16, NCHW and channels-last
    n_served = 2 * len(tiny_tool.SERVED_CONVS)  # fp32 and bf16
    # fp32 and bf16, three views
    n_heads = 2 * len(tiny_tool.HEADS_COVERAGE) * len(tiny_tool.HEADS_VIEWS)
    assert parts == (["conv", "conv", "conv"] + ["coverage"] * n_coverage
                     + ["served"] * n_served + ["heads"] * n_heads + ["dense", "attention"])
    assert [c.get("dtype") for c in record["cases"][:3]] == ["bfloat16", "bfloat16", "float32"]
    assert record["cases"][2]["shape"] == "tiny3"  # MAIN_SHAPE in float32
    assert all(c["exact"] for c in record["cases"])
    conv = record["cases"][0]
    assert conv["c_pad"] == 16 and conv["conv_s8_tile_n"] == "plain"
    assert conv["conv_s8_bit_equal"] and conv["route_bit_equal"] and conv["nhwc_codes_exact"]
    assert {"amax_s8_cpu_ms", "path_cpu_ms", "quantize_nhwc_s8_cpu_ms", "conv_s8_cpu_ms",
            "plain_quantize_nhwc_s8_cpu_ms", "plain_conv_s8_cpu_ms",
            "library_cudnn_bf16_cpu_ms", "library_vector_norm_cpu_ms"} <= set(conv)
    assert conv["bounds"]["conv_s8"]["bound_by"] in ("bytes", "operations")
    assert conv["amax_exact"] and conv["bounds"]["amax_s8"]["bound_by"] == "bytes"
    assert conv["bounds"]["quantize_nhwc_s8"]["bound_by"] == "bytes"
    heads = [c for c in record["cases"] if c["part"] == "heads"]
    assert {c["one_launch"] for c in heads} == {True, False}  # both sides of the limit
    assert all(v > 0 for v in record["calls"].values())
    assert len(capsys.readouterr().out.splitlines()) == len(parts)


def _counted_kernel(kernel):
    """A shim that counts each call of a kernel's wrapper as its launch."""
    def shim(*args, **kwargs):
        shim.launches += 1
        return kernel(*args, **kwargs)

    shim.launches = 0
    return shim


def _counting_wrappers(monkeypatch):
    """Shims that count each int8 wrapper call (and the class-logit head's)
    as its kernel's launch."""
    def counted(fn, *holders):
        def shim(*args, **kwargs):
            for holder in holders:
                holder.launches += 1
            return fn(*args, **kwargs)

        return shim

    monkeypatch.setattr(tint8, "quantize_rows", counted(tint8.quantize_rows, tint8.amax_s8,
                                                        tint8.quantize_s8))
    heads = tint8.quantize_heads

    def heads_shim(x, transpose):
        one = tint8.heads_one_launch(x.shape[1], x.shape[3], x.dtype)
        tint8.amax_s8.launches += 0 if one else 1
        tint8.quantize_s8.launches += 1
        return heads(x, transpose)

    monkeypatch.setattr(tint8, "quantize_heads", heads_shim)
    monkeypatch.setattr(tint8, "amax_samples", counted(tint8.amax_samples, tint8.amax_s8))
    monkeypatch.setattr(tint8, "nhwc_codes", counted(tint8.nhwc_codes, tint8.quantize_nhwc_s8))
    for name in ("dequant_rows", "dequant_heads", "dequant_av"):
        monkeypatch.setattr(tint8, name, counted(getattr(tint8, name), tint8.dequant_s32))
    for name in ("int8_gemm_kmajor", "conv_s8"):
        monkeypatch.setattr(tint8, name, _counted_kernel(getattr(tint8, name)))
    # OWLv2's class-logit head, where the model and the counts look it up
    from spotter_tpu_torch.models import owlvit
    from spotter_tpu_torch.ops import openvocab

    head = openvocab.owl_class_logits

    def head_shim(*args, **kwargs):
        head_shim.launches += 1
        return head(*args, **kwargs)

    head_shim.launches = 0
    monkeypatch.setattr(openvocab, "owl_class_logits", head_shim)
    monkeypatch.setattr(owlvit, "owl_class_logits", head_shim)


def test_int8_phase_rehearses_on_the_cpu(cpu_rehearsal, monkeypatch, tiny_tool):  # noqa: F811
    """RT-DETR's three legs (the quantized calls equal the module tree's
    plan, the launches equal the calls, B = 8 within the "bfloat16" bounds
    of the float forward, B = 8 bit equal to the plain witness, B = 1 bit
    equal to the float forward; the engine and /detect in the throughput
    bucket under the first leg), the other families' B = 8 forwards (each
    bit equal to its witness), and the kernels line's four new rows."""
    chip_smoke = cpu_rehearsal
    monkeypatch.setattr(chip_smoke, "INT8_ROUNDS", 1)
    monkeypatch.setattr(tquant, "INT8_MIN_CH", 8)
    monkeypatch.setattr(tquant, "INT8_ATTN_MIN_HD", 4)
    monkeypatch.setattr(tquant, "INT8_MIN_BATCH", 8)
    _counting_wrappers(monkeypatch)
    tool_main = tiny_tool.main
    monkeypatch.setattr(tiny_tool, "main",
                        lambda argv: tool_main(["--device", "cpu", "--iters", "1", *argv]))
    log = []
    out = chip_smoke.phase_int8(log, 0, device="cpu")
    legs = out["rtdetr"]
    assert set(legs) == {"bfloat16_conv", "bfloat16_attn", "float32_conv"}
    for rec in legs.values():
        assert rec["calls_per_forward"] == rec["plan"] and rec["plan"]["conv"] > 0
        assert rec["b1_bit_equal"] and rec["plain_witness_b8"]["bit_equal"]
        launches = rec["launches_per_forward"]
        calls = rec["calls_per_forward"]
        # every heads call of RT-DETR's attention fits one block: no amax for it
        assert launches["amax_s8"] == launches["quantize_nhwc_s8"] + launches.get(
            "quantize_s8", 0) - 2 * calls["qk"] - calls["av"]
        assert launches["quantize_nhwc_s8"] == calls["conv"]
    assert legs["bfloat16_attn"]["plan"]["qk"] == legs["bfloat16_attn"]["plan"]["av"] > 0
    assert legs["bfloat16_conv"]["plan"]["dense"] == 0
    http = legs["bfloat16_conv"]["http"]
    assert http["forwards"] > 0 and http["launches"]["conv_s8"] > 0
    assert http["launches"]["int8_gemm_kmajor"] == http["launches"]["dequant_s32"] == 0
    assert legs["bfloat16_conv"]["engine_launches"]["quantize_nhwc_s8"] > 0
    assert legs["bfloat16_conv"]["engine_launches"]["quantize_s8"] == 0
    for rec in legs.values():  # one conv_s8 a quantized convolution
        assert rec["launches_per_forward"]["conv_s8"] == rec["calls_per_forward"]["conv"]
    all_knobs = legs["bfloat16_attn"]["launches_per_forward"]
    assert all_knobs["int8_gemm_kmajor"] == all_knobs["dequant_s32"] > 0
    assert set(out["families"]) == {name for name, *_ in chip_smoke.INT8_FAMILIES}
    assert all(rec["plain_witness_b8"]["bit_equal"] for rec in out["families"].values())
    yolos = out["families"][chip_smoke.YOLOS_NAME]
    assert yolos["calls_per_forward"]["dense"] > 0 and yolos["calls_per_forward"]["conv"] == 0
    rows = {c["kernel"]: c for c in out["kernel_cases"]}
    assert set(rows) == set(chip_smoke.INT8_KERNELS)
    assert rows["int8_gemm_kmajor"]["launches"] == all_knobs["int8_gemm_kmajor"]
    assert rows["conv_s8"]["launches"] == http["launches"]["conv_s8"]
    assert {"cudnn_bf16_ms", "path_ms"} <= set(rows["conv_s8"])
    assert rows["quantize_nhwc_s8"]["launches"] == http["launches"]["quantize_nhwc_s8"]
    assert rows["quantize_s8"]["launches"] == all_knobs["quantize_s8"] > 0
    summary = chip_smoke.kernel_summary(out["kernel_cases"],
                                        {c["kernel"]: c["launches"] for c in out["kernel_cases"]})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for row in summary["kernels"]:
        assert keys <= set(row) and row["replaces"].startswith("spotter_tpu/utils/quant.py:")
    cases = {row["name"]: row["case"] for row in summary["kernels"]}  # the function timed
    assert cases["quantize_nhwc_s8"] == f"nhwc_{bench_int8_conv.MAIN_SHAPE}_bfloat16"
    assert cases["quantize_s8"] == "rows_yolos_fc1"
    assert cases["dequant_s32"] == "rows_yolos_fc1"
    assert not (tquant.INT8 or tquant.INT8_DENSE or tquant.INT8_ATTN)
    assert np.isfinite(legs["float32_conv"]["vs_float_b8"]["logits_max_abs_err"])


@pytest.mark.parametrize("calls,heads,want", [
    # RT-DETRv2-R101 under `bfloat16` + INT8: three kernels a convolution
    ({"conv": 133, "dense": 0, "qk": 0, "av": 0}, [],
     {"amax_s8": 133, "quantize_s8": 0, "quantize_nhwc_s8": 133, "int8_gemm_kmajor": 0,
      "dequant_s32": 0, "conv_s8": 133}),
    # all knobs: 21 heads calls at (300 or 400, 32) fit one block each, no amax
    ({"conv": 133, "dense": 28, "qk": 7, "av": 7}, [(300, 32, "float32")] * 21,
     {"amax_s8": 168, "quantize_s8": 56, "quantize_nhwc_s8": 133, "int8_gemm_kmajor": 42,
      "dequant_s32": 42, "conv_s8": 133}),
    # a group past the limit (fp32 769 x 32): its amax pass comes back
    ({"conv": 0, "dense": 2, "qk": 1, "av": 1},
     [(769, 32, "float32"), (300, 32, "float32"), (769, 32, "bfloat16")],
     {"amax_s8": 4, "quantize_s8": 6, "quantize_nhwc_s8": 0, "int8_gemm_kmajor": 4,
      "dequant_s32": 4, "conv_s8": 0}),
])
def test_int8_launches_plan_with_the_heads_rule(calls, heads, want):
    """chip_smoke.int8_launches: the launches a forward's quantized calls
    make, a heads call one launch where `heads_one_launch` says so."""
    import torch

    import chip_smoke

    heads = [(t, hd, getattr(torch, dtype)) for t, hd, dtype in heads]
    assert chip_smoke.int8_launches(calls, heads) == want
    assert set(want) == set(chip_smoke.INT8_KERNELS)
