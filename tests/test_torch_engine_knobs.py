"""Knobs the replica used to ignore, now refused or checked with the JAX
package's texts, and the knobs a captured graph is keyed by.

- `SPOTTER_TPU_STUB_ENGINE` (the JAX replica's canned-detection engine) and
  `SPOTTER_TPU_FAULTS` (its fault plan) raise at bring-up, naming ROADMAP
  item 6; their off values serve. An unknown fault raises the JAX text
  first, as `spotter_tpu.testing.faults` does.
- `SPOTTER_TPU_TOPK` outside auto|lax|bisect raises at the top-k call with
  the JAX text; every valid value serves (all compute lax.top_k's result).
- `SPOTTER_TPU_PROFILER_PORT` has no torch counterpart and raises at
  bring-up; `profiler.capture` keeps the JAX checks and texts.
- `graphs.graph_key` changes when any knob a forward reads changes, so a
  knob change captures anew instead of replaying a stale graph.
"""

import os

import numpy as np
import pytest
import torch

from spotter_tpu.ops import topk as jtopk
from spotter_tpu.testing import faults as jfaults
from spotter_tpu_torch.engine import graphs, profiler
from spotter_tpu_torch.models import layers
from spotter_tpu_torch.ops import msda, openvocab, postprocess
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.utils import quant

MODEL = "PekingU/rtdetr_v2_r101vd"
KNOBS = ("SPOTTER_TPU_STUB_ENGINE", "SPOTTER_TPU_FAULTS", "SPOTTER_TPU_TOPK",
         "SPOTTER_TPU_PROFILER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


@pytest.mark.parametrize("knob,value", [
    ("SPOTTER_TPU_STUB_ENGINE", "1"), ("SPOTTER_TPU_STUB_ENGINE", " 0"),
    ("SPOTTER_TPU_FAULTS", "engine_oom=1"), ("SPOTTER_TPU_FAULTS", "sdc=5,slow_stage=device:10"),
    ("SPOTTER_TPU_PROFILER_PORT", "9012"),
], ids=str)
def test_unported_knob_raises_at_bring_up(clean_env, knob, value):
    clean_env.setenv(knob, value)
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 6") as info:
        tapp.build_detector_app(MODEL, tiny=True, device="cpu")
    assert knob in str(info.value)
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 6"):
        tstandalone.make_app(model_name=MODEL, device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("SPOTTER_TPU_STUB_ENGINE", ""), ("SPOTTER_TPU_STUB_ENGINE", "0"),
    ("SPOTTER_TPU_FAULTS", ""), ("SPOTTER_TPU_FAULTS", "  "), ("SPOTTER_TPU_PROFILER_PORT", ""),
], ids=repr)
def test_off_values_serve(clean_env, knob, value):
    clean_env.setenv(knob, value)
    tapp.refuse_unported_planes()


def test_stub_off_values_are_the_jax_ones(clean_env):
    from spotter_tpu.testing import stub_engine

    for value in ("", "0", "1", " 0", "true"):
        clean_env.setenv("SPOTTER_TPU_STUB_ENGINE", value)
        refused = True
        try:
            tapp.refuse_unported_planes()
            refused = False
        except ValueError:
            pass
        assert refused == stub_engine.stub_mode_enabled(), value


@pytest.mark.parametrize("spec", ["no_such_fault=1", "engine_oom=1, bogus=2", "=3"])
def test_unknown_fault_raises_the_jax_text(clean_env, spec):
    clean_env.setenv("SPOTTER_TPU_FAULTS", spec)
    with pytest.raises(ValueError) as want:
        jfaults.maybe_activate_from_env()
    with pytest.raises(ValueError) as got:
        tapp.refuse_unported_planes()
    assert str(got.value) == str(want.value)
    assert set(tapp.FAULT_NAMES) >= {"engine_oom", "sdc", "corrupt_weights", "slow_stage"}


@pytest.mark.parametrize("value", ["bogus", "TOPK", "lax2"])
def test_bad_topk_raises_the_jax_text_at_the_call(clean_env, value):
    clean_env.setenv("SPOTTER_TPU_TOPK", value)
    with pytest.raises(ValueError) as want:
        jtopk._mode()
    x = torch.arange(6.0).reshape(1, 6)
    with pytest.raises(ValueError) as got:
        postprocess.stable_top_k(x, 3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["auto", "lax", " Bisect "])
def test_valid_topk_values_all_compute_the_stable_top_k(clean_env, value):
    clean_env.setenv("SPOTTER_TPU_TOPK", value)
    x = torch.tensor([[0.5, 2.0, 0.5, 1.0, 2.0]])
    values, idx = postprocess.stable_top_k(x, 4)
    assert idx.tolist() == [[1, 4, 3, 0]] and values.tolist() == [[2.0, 2.0, 1.0, 0.5]]


def test_profiler_capture_keeps_the_jax_checks(tmp_path):
    for bad in (0.0, -1.0, 61.0, float("nan")):
        with pytest.raises(ValueError, match=r"duration_s must be in \(0, 60\]"):
            profiler.capture(str(tmp_path), bad)
    out = profiler.capture(str(tmp_path / "trace"), 0.05)
    assert os.path.getsize(out["trace"]) > 0 and out["activities"][0] == "CPU"
    assert profiler._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="a profiler capture is already running"):
            profiler.capture(str(tmp_path), 0.05)
    finally:
        profiler._capture_lock.release()


# every knob a forward reads, and a second value for it
KNOB_CHANGES = [
    (msda, "MSDA_PREP", "kernel"), (msda, "MSDA_PREP", "fused"),
    (msda, "MSDA_BACKEND", "pallas_sep"), (msda, "MSDA_PRECISION", "default"),
    (quant, "INT8", True), (quant, "INT8_DENSE", True), (quant, "INT8_ATTN", True),
    (quant, "INT8_MIN_CH", 32), (quant, "INT8_MIN_BATCH", 1), (quant, "INT8_ATTN_MIN_HD", 16),
    (layers, "FLASH_ATTN_ENABLED", False), (layers, "FLASH_IMPL", "splash"),
    (layers, "GELU_MODE", "tanh"), (openvocab, "OWL_FUSED", "0"),
    ("SPOTTER_TPU_DTYPE", "bfloat16"), ("SPOTTER_TPU_REP_FUSE", "1"), ("SPOTTER_TPU_TOPK", "lax"),
]


@pytest.mark.parametrize("change", KNOB_CHANGES, ids=lambda c: str(c[-2]) + "=" + str(c[-1]))
def test_graph_key_changes_with_each_forward_knob(monkeypatch, change):
    for env in graphs.KNOB_ENVS:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(msda, "MSDA_PREP", "xla")
    monkeypatch.setattr(msda, "MSDA_BACKEND", "auto")
    monkeypatch.setattr(msda, "MSDA_PRECISION", None)
    before = graphs.graph_key("u8:8x640x640")
    assert graphs.graph_key("u8:8x640x640") == before
    if len(change) == 2:
        monkeypatch.setenv(*change)
    else:
        module, name, value = change
        assert getattr(module, name) != value
        monkeypatch.setattr(module, name, value)
    after = graphs.graph_key("u8:8x640x640")
    assert after != before and after[0] == before[0]
    assert graphs.graph_key("u8:4x640x640") != after


def test_graph_counts_put_back_and_added(monkeypatch):
    """The count bookkeeping a capture and its replays use."""
    before = graphs.read_counts()
    graphs.add_counts({"msda_gather_sum": 6, "quant.conv": 2})
    after = graphs.read_counts()
    assert after["msda_gather_sum"] == before["msda_gather_sum"] + 6
    assert after["quant.conv"] == before["quant.conv"] + 2
    graphs.add_counts({"msda_gather_sum": -6, "quant.conv": -2})
    assert graphs.read_counts() == before
    assert set(np.unique([k.split(".")[0] for k in before])) >= {"quant", "msda_gather_sum"}
