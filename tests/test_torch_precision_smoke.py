"""chip_smoke.py's `precision` phase and its one-pass kernel cases,
rehearsed on the CPU at the tiny width (the card run takes the models at
full width and launches the kernels; here each MSDA wrapper runs its plain
version and a counting shim stands in for its launch count).

The stage profile (tools/profile_forward.py) needs CUDA events, so it is
replaced by one that reports the backbone stage of a bf16 backbone as the
faster: the phase's no-fallback gate is only meaningful on the card.
"""

import os

import numpy as np
import pytest
import torch

from spotter_tpu_torch.models import registry
from spotter_tpu_torch.ops import msda

WRAPPERS = ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum", "msda_sep_sum",
            "msda_hd_gather_sum")


def _counting(fn):
    def shim(*args, **kwargs):
        shim.launches += 1
        return fn(*args, **kwargs)

    shim.launches = 0
    return shim


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    import chip_smoke
    from spotter_tpu_torch.tools import profile_forward, timing

    monkeypatch.setenv("SPOTTER_TPU_TINY", "1")  # the replica's own build (build_detector_app)
    # small photos: decoding, drawing and encoding full-size ones is the CPU's
    # cost here, not the path's
    monkeypatch.setattr(chip_smoke, "PHOTO_SIZES", [(48, 64), (64, 48)] * 4)
    build = registry.build_detector
    # tiny, but a checkpoint directory builds what it holds
    monkeypatch.setattr(registry, "build_detector", lambda name, **kw: build(
        name, **{**kw, "tiny": not os.path.isdir(name)}))
    # one untimed-warmup-free call: a host time of a tiny CPU forward measures nothing
    monkeypatch.setattr(timing, "cuda_time_ms",
                        lambda fn, iters, flush, warmup=3: timing.host_time_ms(fn, 1, warmup=0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in WRAPPERS:
        monkeypatch.setattr(msda, name, _counting(getattr(msda, name)))

    def stages(model_name, model, inputs):
        model(*inputs)
        bf16 = model.backbone.stem0.dtype == torch.bfloat16
        return {"stages_ms": {"backbone": 1.0 if bf16 else 2.0}, "forward_wall_ms_median": 3.0,
                "profiler": {"busy_share": 1.0, "top_kernels": [], "host_ms_per_forward": 0.0,
                             "top_host_ops": []}}

    monkeypatch.setattr(profile_forward, "profile_backend", stages)
    monkeypatch.setattr(msda, "MSDA_PRECISION", None)
    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    # one intra-op thread: the tensors are tiny, and beside the other test
    # workers a pool of spinning threads a worker made a rehearsal ~50x
    # slower than alone (340-490 s against ~8 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield chip_smoke
    torch.set_num_threads(threads)


def test_precision_phase_rehearses_on_the_cpu(cpu_rehearsal, monkeypatch):
    """Every leg runs: RT-DETR under "mixed", "bfloat16" and "bfloat16"
    unfused with the card-vs-CPU comparison (here CPU against CPU), 6
    one-pass launches a forward under each prep, the engine and /detect;
    Deformable-DETR and the lineage against their "float32" forwards with
    their launches; the checkpoint loaded under "mixed" bit equal."""
    chip_smoke = cpu_rehearsal
    # one timed round a leg: the path is the card run's, the drawing of
    # full-size photos on the CPU is what a round costs here
    monkeypatch.setattr(chip_smoke, "POLICY_ROUNDS", 1)
    log = []
    out = chip_smoke.phase_precision(log, 0, device="cpu")
    legs = out["rtdetr"]
    assert set(legs) == {"float32", "mixed", "bfloat16", "bfloat16_rep_fuse_0"}
    assert legs["mixed"]["compute_dtypes"] == {"backbone": "bfloat16", "encoder": "float32",
                                              "decoder": "float32"}
    assert legs["bfloat16"]["rep_fuse"] and not legs["bfloat16_rep_fuse_0"]["rep_fuse"]
    assert not legs["mixed"]["rep_fuse"]
    for label in ("mixed", "bfloat16", "bfloat16_rep_fuse_0"):
        assert legs[label]["msda_precision"] == "default"
        assert set(legs[label]["launches_per_forward_by_prep"].values()) == {2}  # tiny: 2 layers
    assert legs["mixed"]["card_vs_cpu_b1"]["logits_max_abs_err"] == 0.0
    assert legs["mixed"]["http_fused"]["launches"] > 0
    ddetr = out["families"]["SenseTime/deformable-detr"]
    assert ddetr["mixed"]["launches"] == {"msda_gather_sum": 3}  # 1 encoder + 2 decoder layers
    assert ddetr["mixed"]["pallas_sep_launches"] == 3 * 4  # once per level of each op
    assert not out["families"]["facebook/detr-resnet-50"]["bfloat16"]["launches"]
    for rec in out["families"].values():  # each served under both policies
        for policy in ("mixed", "bfloat16"):
            assert set(rec[policy]["http_ms"]) == {"policy:1", "policy:8"}
            assert rec[policy]["engine_batch8_ms"] > 0
    assert out["checkpoint_mixed"]["bit_equal"] and out["checkpoint_mixed"]["bf16_layers"] > 0
    assert not any(chip_smoke.read_counts().values())
    assert "SPOTTER_TPU_DTYPE" not in os.environ


@pytest.mark.parametrize("case", ["msda_case", "loc_case", "fused_case"])
def test_one_pass_kernel_cases_rehearse_on_the_cpu(cpu_rehearsal, monkeypatch, case):
    """The kernel phase's one-pass cases at a tiny decoder shape: the
    wrapper (its plain version here) against the plain version in
    "default" mode, recorded with its precision; embedding_bag is no
    yardstick of the rounded function, so the gather-sum's library time is
    none."""
    chip_smoke = cpu_rehearsal
    monkeypatch.setattr(chip_smoke, "QUERIES", 16)
    rec = getattr(chip_smoke, case)(1, torch.float32, "default", 0, None, device="cpu",
                                    precision="default")
    assert rec["precision"] == "default" and rec["max_abs_err"] == 0.0
    assert rec["library_ms"] is None and rec["sass"] is None
    assert chip_smoke.is_main_case({**rec, "batch": 8}, "default")
    assert not chip_smoke.is_main_case({**rec, "batch": 8})


def test_kernels_line_lists_the_one_pass_variants():
    """The `kernels` summary gives rows 1-4's one-pass mode rows of their
    own, with every key the line must carry."""
    import chip_smoke

    base = {"phase": "kernel", "batch": 8, "rows_dtype": "float32", "method": "default",
            "max_abs_err": 0.0, "kernel_ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
            "bound_by": "bytes", "library_ms": None}
    cases = []
    for name in chip_smoke.ONE_PASS_KERNELS:
        extra = {"case": "ddetr_encoder"} if name == "msda_sep_sum" else {}
        for precision in ("highest", "default"):
            cases.append({**base, **extra, "kernel": name, "precision": precision})
    launches = {f"{n}_onepass": 6 for n in chip_smoke.ONE_PASS_KERNELS}
    rows = {r["name"]: r for r in chip_smoke.kernel_summary(cases, launches)["kernels"]}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for name in chip_smoke.ONE_PASS_KERNELS:
        assert keys <= set(rows[f"{name}_onepass"]) and rows[f"{name}_onepass"]["launches"] == 6
        assert rows[f"{name}_onepass"]["replaces"] == rows[name]["replaces"]
    assert np.isclose(rows["msda_sep_sum_onepass"]["ms"], 1.0)
