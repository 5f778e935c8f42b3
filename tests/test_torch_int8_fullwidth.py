"""RT-DETRv2-R101 at its published widths under int8, the port against the
JAX package on the same seeded weights, on the CPU (slow: not in the tier-1
run).

SPOTTER_TPU_INT8=1 with SPOTTER_TPU_INT8_MIN_BATCH=1 (so B = 1 quantizes)
and the default channel floor, under "float32", at B = 1. The question it
answers: on the card, int8 moves RT-DETR's decoder logits 24.6-30.2 % of
the largest at B = 8 against the float forward, with every kernel bit equal
to its plain version. Is that the int8 function on random weights, or a
fault of the port?

What it holds, and why not the tiny models' output bound: the float
forwards agree to ~1e-6, but a code sits on a rounding edge wherever the
two float activations differ by an ulp, and one flipped code moves its
activation by a whole step (1/127 of its sample's largest). At the first
quantized convolution a handful of codes flip; each flip moves the next
layers' inputs, which flip more codes, and through this depth the two
sides' int8 forwards drift apart about as far as each drifts from its own
float forward. So the test holds:
- the same convolutions quantized on both sides (call counts);
- the float forwards within 1e-4 (logits of the largest, boxes);
- at the first quantized call, float inputs within 1e-5 of the largest and
  at most 1e-4 of its codes flipped;
- the port's quantizer on JAX's own inputs giving JAX's codes, call by call
  (the function is the same; only its inputs drift);
- the departure no larger than the two movements together (the triangle
  bound): logits and boxes within JAX's int8-vs-float movement plus the
  port's plus the float parity, and the matched share at least one minus
  the two unmatched shares.
It prints each side's own movement: equal movements say the card's 24.6 %
is the int8 function at this depth on random weights, not the port.

Two sizes:
- "full": the published preset at 640x640 (ResNet-101-vd, depths 3/4/23/3);
- "cut": the same widths (every channel count, 256-wide decoder, 8 heads,
  300 queries, 80 classes, six decoder layers) with the backbone's depths
  cut to 1/1/2/1 and a 320x320 input, for a machine where the full model
  is too large to run on the CPU.

    python -m pytest -m slow tests/test_torch_int8_fullwidth.py -s
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import configs as jconfigs
from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.utils import quant as jquant
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import configs as tconfigs
from spotter_tpu_torch.models import rtdetr as trtdetr
from spotter_tpu_torch.ops import msda as tmsda
from spotter_tpu_torch.utils import quant as tquant
from tests.test_torch_int8 import set_knobs
from tests.test_torch_int8_models import MATCH_RADIUS, Spies, _flipped_codes, _port_inputs
from tests.torch_parity import random_flax_params

PRESET = "rtdetr_v2_r101vd"
SIZES = {"full": ((3, 4, 23, 3), 640), "cut": ((1, 1, 2, 1), 320)}


def _configs(size: str):
    depths, _ = SIZES[size]
    j = jconfigs.RTDETR_PRESETS[PRESET]
    t = tconfigs.RTDETR_PRESETS[PRESET]
    j = dataclasses.replace(j, backbone=dataclasses.replace(j.backbone, depths=depths))
    t = dataclasses.replace(t, backbone=dataclasses.replace(t.backbone, depths=depths))
    return j, t


def _matched(ref: dict, got: dict, b: int) -> dict:
    """Over each image's queries that both forwards select (encoder boxes
    within MATCH_RADIUS): the matched share, the logits' largest difference
    relative to `ref`'s largest |logit| and the boxes' largest difference."""
    out = {"matched": [], "logits": [], "boxes": []}
    for i in range(b):
        rb, gb = np.asarray(ref["enc_topk_bboxes"][i]), np.asarray(got["enc_topk_bboxes"][i])
        d = np.abs(gb[:, None] - rb[None]).max(-1)
        r_idx, ok = d.argmin(1), d.min(1) <= MATCH_RADIUS
        want = np.asarray(ref["logits"][i], np.float32)
        out["matched"].append(float(ok.mean()))
        out["logits"].append(float(np.abs(np.asarray(got["logits"][i], np.float32)[ok]
                                          - want[r_idx[ok]]).max() / np.abs(want).max()))
        out["boxes"].append(float(np.abs(np.asarray(got["pred_boxes"][i])[ok]
                                         - np.asarray(ref["pred_boxes"][i])[r_idx[ok]]).max()))
    return {k: max(v) if k != "matched" else min(v) for k, v in out.items()}


@pytest.mark.slow
@pytest.mark.parametrize("size", list(SIZES))
def test_r101_int8_port_matches_jax_at_b1(monkeypatch, capsys, size):
    jcfg, tcfg = _configs(size)
    hw = SIZES[size][1]
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "float32")
    monkeypatch.delenv("SPOTTER_TPU_REP_FUSE", raising=False)
    monkeypatch.setattr(jrtdetr, "REP_FUSE", False)
    monkeypatch.setattr(tmsda, "MSDA_PRECISION", None)
    x = np.random.default_rng(7).uniform(-2, 2, (1, hw, hw, 3)).astype(np.float32)
    jmodel = jrtdetr.RTDetrDetector(jcfg)
    params = random_flax_params(jmodel, x, seed=0)
    model = load_from_jax(trtdetr.RTDetrDetector(tcfg).eval(), params)
    tx = torch.from_numpy(x)

    set_knobs(monkeypatch, int8=False, dense=False, attn=False, min_ch=64, min_batch=1, min_hd=32)
    jfloat = jmodel.apply({"params": params}, x)
    with torch.inference_mode():
        tfloat = {k: v.numpy() for k, v in model(tx).items()}

    set_knobs(monkeypatch, int8=True, dense=False, attn=False, min_ch=64, min_batch=1, min_hd=32)
    spies = Spies(monkeypatch)
    seen = _port_inputs(monkeypatch)
    jint8 = jmodel.apply({"params": params}, x)  # eagerly, op by op
    tquant.reset_calls()
    with torch.inference_mode():
        tint8 = {k: v.numpy() for k, v in model(tx).items()}
    assert dict(tquant.CALLS) == spies.calls and spies.calls["conv"] > 50
    flipped, total = _flipped_codes(spies.inputs, seen)
    port_vs_jax = _matched(jint8, tint8, 1)
    jax_move, port_move = _matched(jfloat, jint8, 1), _matched(tfloat, tint8, 1)
    float_vs_jax = _matched(jfloat, tfloat, 1)
    first = _first_call(spies.inputs[0][1][0], seen[0][1][0])
    _same_codes_from_jax_inputs(spies.inputs)
    with capsys.disabled():
        print(f"\nR101 {size} int8 B=1: calls {spies.calls}, flipped codes {flipped} of {total}"
              f"\n  first quantized call: {first}"
              f"\n  port vs JAX, float: {float_vs_jax}\n  port vs JAX, int8: {port_vs_jax}"
              f"\n  int8 vs float, JAX: {jax_move}\n  int8 vs float, port: {port_move}")
    assert float_vs_jax["matched"] == 1.0
    assert float_vs_jax["logits"] <= 1e-4 and float_vs_jax["boxes"] <= 1e-4, float_vs_jax
    assert first["input_rel_diff"] <= 1e-5 and first["flipped_share"] <= 1e-4, first
    for key in ("logits", "boxes"):
        bound = jax_move[key] + port_move[key] + float_vs_jax[key]
        assert port_vs_jax[key] <= bound, (key, port_vs_jax, bound)
    assert port_vs_jax["matched"] >= 1 - (1 - jax_move["matched"]) - (1 - port_move["matched"])


def _first_call(jax_x: np.ndarray, port_x: np.ndarray) -> dict:
    """The first quantized convolution's float inputs (JAX's NHWC) side by
    side: their largest difference relative to the largest |input|, and the
    share of codes that differ when each is quantized."""
    j = np.ascontiguousarray(jax_x.transpose(0, 3, 1, 2))
    jq = tquant.quantize_activation(torch.from_numpy(j))[0]
    tq = tquant.quantize_activation(torch.from_numpy(port_x))[0]
    return {"input_rel_diff": float(np.abs(j - port_x).max() / np.abs(j).max()),
            "flipped": int((jq != tq).sum()), "flipped_share": float((jq != tq).float().mean())}


def _same_codes_from_jax_inputs(jax_inputs) -> None:
    """Every quantized convolution's input, as JAX computed it, quantized by
    both packages: equal codes and scales."""
    for kind, (a,) in jax_inputs:
        assert kind == "conv"
        jq, js = jquant.quantize_activation(jnp.asarray(a))
        tq, ts = tquant.quantize_activation(torch.from_numpy(
            np.ascontiguousarray(a.transpose(0, 3, 1, 2))))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(ts.numpy().reshape(-1), np.asarray(js).reshape(-1))
