"""The seven families with the int8 knobs on, against the JAX package's
modules with the same knobs and the same weights, at the zoo's tiny sizes
on the CPU.

Both sides run with SPOTTER_TPU_INT8_MIN_CH = 8, _MIN_BATCH = 1 and
_INT8_ATTN_MIN_HD = 4 (the tiny heads are 8 wide), set as module
attributes (both packages read the knobs at import). The JAX modules run
eagerly, under "float32"; RT-DETR and DETR also under "bfloat16" and YOLOS
under "mixed". This file holds RT-DETR and Deformable-DETR;
tests/test_torch_int8_models_detr.py the DETR lineage and
tests/test_torch_int8_models_vit.py YOLOS and OWL.

Counts: the port's quantized convolutions, projections and attention
products (utils/quant.py's CALLS) equal the JAX module's, counted by spies
wrapped around its `int8_conv`, `int8_dense`, `int8_qk` and `int8_av`. A
wrong mapping (a layer quantized that JAX keeps float, or the reverse)
changes them.

Tolerance. Both sides quantize with the same arithmetic, so a code
differs only where the float activation it quantizes already differs by
an ulp (XLA's and PyTorch's rsqrt, exp and sums in another order) and sits
on a rounding edge; one such flip moves that activation by one step
(1/127 of its sample's largest) and the outputs after it. The test counts
the flipped codes (each quantized input re-quantized from both sides'
values) and prints them: under "float32" none flipped in these runs, and
the outputs agree within the float tests' bounds (1e-4 of the largest
logit, 1e-4 in the boxes). Under the bf16 policies the float drift that
tests/test_torch_precision_models.py measures comes first (logits 6 % of
the largest, boxes 2e-2 under "bfloat16"; YOLOS "mixed" 0.05 / 0.01), and
flips follow it.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import conditional_detr as jcond
from spotter_tpu.models import dab_detr as jdab
from spotter_tpu.models import deformable_detr as jddetr
from spotter_tpu.models import detr as jdetr
from spotter_tpu.models import layers as jl
from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.owlvit import OwlViTDetector as JOwl
from spotter_tpu.models.yolos import YolosDetector as JYolos
from spotter_tpu.ops import msda as jmsda
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import conditional_detr as tcond
from spotter_tpu_torch.models import dab_detr as tdab
from spotter_tpu_torch.models import deformable_detr as tddetr
from spotter_tpu_torch.models import detr as tdetr
from spotter_tpu_torch.models import rtdetr as trtdetr
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.owlvit import OwlViTDetector
from spotter_tpu_torch.models.yolos import YolosDetector
from spotter_tpu_torch.ops import msda as tmsda
from spotter_tpu_torch.utils import quant as tquant
from tests.test_torch_int8 import set_knobs
from tests.torch_parity import random_flax_params

KNOB_SETS = {
    "int8": dict(int8=True, dense=False, attn=False),
    "int8_dense": dict(int8=True, dense=True, attn=False),
    "int8_dense_attn": dict(int8=True, dense=True, attn=True),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "mixed": (jnp.bfloat16, torch.bfloat16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (1e-4, 1e-4), "mixed": (0.05, 0.01), "bfloat16": (6e-2, 2e-2)}
FLIPPED_TOL = (6e-2, 2e-2)  # once a code has flipped: "bfloat16"'s bounds
MATCH_RADIUS = 1e-2


def _masked_inputs(hw=(64, 64), masked=True, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, *hw, 3)).astype(np.float32)
    if not masked:
        return (x,)
    mask = np.ones((2, *hw), np.float32)
    mask[0, :, hw[1] * 5 // 8:] = 0
    mask[1, hw[0] * 3 // 4:, :] = 0
    return x * mask[..., None], mask


def _owl_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids, mask = jzoo._tiny_tokenize(["a photo of a couch", "a photo of a dog",
                                     "a photo of a tv", "a photo of a bed"], 99, 8)
    return x, ids, mask


# family -> (JAX module factory, port module factory, inputs); each factory
# takes (compute dtype, backbone dtype)
def _detr_like(jcls, tcls, jtiny, ttiny):
    return (lambda d, bd: jcls(jtiny(), dtype=d, backbone_dtype=bd),
            lambda d, bd: tcls(ttiny(), dtype=d, backbone_dtype=bd), _masked_inputs)


FAMILIES = {
    "rtdetr": (lambda d, bd: jrtdetr.RTDetrDetector(jzoo.tiny_rtdetr_config(), dtype=d,
                                                    backbone_dtype=bd),
               lambda d, bd: trtdetr.RTDetrDetector(tzoo.tiny_rtdetr_config(), dtype=d,
                                                    backbone_dtype=bd),
               functools.partial(_masked_inputs, masked=False)),
    "deformable_detr": _detr_like(jddetr.DeformableDetrDetector, tddetr.DeformableDetrDetector,
                                  jzoo.tiny_deformable_detr_config,
                                  tzoo.tiny_deformable_detr_config),
    "detr": _detr_like(jdetr.DetrDetector, tdetr.DetrDetector, jzoo.tiny_detr_config,
                       tzoo.tiny_detr_config),
    "conditional_detr": _detr_like(jcond.ConditionalDetrDetector, tcond.ConditionalDetrDetector,
                                   jzoo.tiny_conditional_detr_config,
                                   tzoo.tiny_conditional_detr_config),
    "dab_detr": _detr_like(jdab.DabDetrDetector, tdab.DabDetrDetector, jzoo.tiny_dab_detr_config,
                           tzoo.tiny_dab_detr_config),
    "yolos": (lambda d, bd: JYolos(jzoo.tiny_yolos_config(), dtype=bd),
              lambda d, bd: YolosDetector(tzoo.tiny_yolos_config(), dtype=bd),
              lambda: (np.random.default_rng(0).standard_normal((2, 32, 48, 3))
                       .astype(np.float32),)),
    "owlvit": (lambda d, bd: JOwl(dataclasses.replace(jzoo.tiny_owlvit_config(), objectness=True),
                                  dtype=d, vision_dtype=bd),
               lambda d, bd: OwlViTDetector(dataclasses.replace(tzoo.tiny_owlvit_config(),
                                                                objectness=True),
                                            dtype=d, vision_dtype=bd),
               _owl_inputs),
}


class Spies:
    """Wraps the JAX package's quantized products where its modules call
    them, counting calls and keeping the float inputs each quantizes."""

    def __init__(self, monkeypatch):
        self.calls = {"conv": 0, "dense": 0, "qk": 0, "av": 0}
        self.inputs = []
        for module, name in ((jl, "int8_conv"), (jl, "int8_dense"), (jl, "int8_qk"),
                             (jl, "int8_av"), (jrtdetr, "int8_conv")):
            monkeypatch.setattr(module, name, self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        kind = name.removeprefix("int8_")

        def spy(*args, **kw):
            self.calls[kind] += 1
            arrays = args[:2] if kind in ("qk", "av") else args[:1]
            self.inputs.append((kind, [np.asarray(jnp.asarray(a, jnp.float32)) for a in arrays]))
            return fn(*args, **kw)

        return spy


def _port_inputs(monkeypatch):
    """The same record on the port's side, from utils/quant.py's entry points."""
    seen = []
    for name in ("int8_conv", "int8_dense", "int8_qk", "int8_av"):
        fn = getattr(tquant, name)
        kind = name.removeprefix("int8_")

        def spy(*args, _fn=fn, _kind=kind, **kw):
            arrays = args[:2] if _kind in ("qk", "av") else args[:1]
            seen.append((_kind, [a.float().numpy() for a in arrays]))
            return _fn(*args, **kw)

        monkeypatch.setattr(tquant, name, spy)
    return seen


def _flipped_codes(jax_inputs, port_inputs) -> tuple[int, int]:
    """Codes that differ when each quantized input is quantized from both
    sides' float values (conv inputs NHWC on the JAX side)."""
    flipped = total = 0
    assert [k for k, _ in jax_inputs] == [k for k, _ in port_inputs]
    for (kind, ja), (_, ta) in zip(jax_inputs, port_inputs):
        for i, (j, t) in enumerate(zip(ja, ta)):
            if kind == "conv":
                j = j.transpose(0, 3, 1, 2)
            if kind == "av" and i == 0 or kind in ("conv", "dense"):
                jq = tquant.quantize_activation(torch.from_numpy(j))[0] if kind != "av" else \
                    tquant.quantize_per_head(torch.from_numpy(j), 1)[0]
                tq = tquant.quantize_activation(torch.from_numpy(t))[0] if kind != "av" else \
                    tquant.quantize_per_head(torch.from_numpy(t), 1)[0]
            else:
                jq = tquant.quantize_per_head(torch.from_numpy(j), 2)[0]
                tq = tquant.quantize_per_head(torch.from_numpy(t), 2)[0]
            flipped += int((jq != tq).sum())
            total += jq.numel()
    return flipped, total


def _close(name, got, want, tol, scale=None):
    want = np.asarray(want, np.float32)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    scale = float(np.abs(want[finite]).max()) if scale is None else scale
    err = float(np.abs(got[finite] - want[finite]).max()) if finite.any() else 0.0
    assert err <= tol * scale, (name, err, tol * scale)
    return err / max(scale, 1e-30)


def _run(monkeypatch, family, knobs, policy):
    jfac, tfac, inputs = FAMILIES[family]
    set_knobs(monkeypatch, **KNOB_SETS[knobs], min_ch=8, min_batch=1, min_hd=4)
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    monkeypatch.setattr(tmsda, "MSDA_PRECISION", None)
    monkeypatch.delenv("SPOTTER_TPU_REP_FUSE", raising=False)
    monkeypatch.setattr(jrtdetr, "REP_FUSE", policy == "bfloat16")
    if policy != "float32":  # the TPU's MSDA, interpreted (tests/test_torch_precision_models.py)
        tpu = functools.partial(jmsda.deformable_sampling, backend="pallas", interpret=True)
        monkeypatch.setattr(jrtdetr, "deformable_sampling", tpu)
        monkeypatch.setattr(jddetr, "deformable_sampling", tpu)
    jd, jbd = (jnp.float32, DTYPES[policy][0]) if policy == "mixed" else (DTYPES[policy][0],) * 2
    td, tbd = (torch.float32, DTYPES[policy][1]) if policy == "mixed" else (DTYPES[policy][1],) * 2
    args = inputs()
    jmodel = jfac(jd, jbd)
    if family == "owlvit":
        params = random_flax_params(jmodel, args[0][:1], *args[1:], seed=3,
                                    method=JOwl.detect_with_text)
    else:
        params = random_flax_params(jmodel, *(a[:1] for a in args), seed=3)
    spies = Spies(monkeypatch)
    seen = _port_inputs(monkeypatch)
    method = {"method": JOwl.detect_with_text} if family == "owlvit" else {}
    jout = jmodel.apply({"params": params}, *args, **method)  # eagerly, op by op
    model = load_from_jax(tfac(td, tbd).eval(), params)
    tquant.reset_calls()
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    with torch.inference_mode():
        tout = model.detect_with_text(*targs) if family == "owlvit" else model(*targs)
    return jout, tout, spies, seen


def check_family(monkeypatch, capsys, family, knobs):
    """`family` under "float32" with `knobs` against JAX: equal quantized
    calls, outputs within the bound the flipped codes allow."""
    jout, tout, spies, seen = _run(monkeypatch, family, knobs, "float32")
    assert dict(tquant.CALLS) == spies.calls, (tquant.CALLS, spies.calls)
    if family not in ("yolos", "owlvit") or knobs != "int8":  # the ViTs have no ConvNorm
        assert spies.calls["conv"] + spies.calls["dense"] > 0
    if knobs == "int8_dense_attn" and family not in ("yolos",):
        assert spies.calls["qk"] > 0  # YOLOS's own attention has no int8 branch
    flipped, total = _flipped_codes(spies.inputs, seen)
    errs = _compare(family, jout, tout, TOL["float32"] if flipped == 0 else FLIPPED_TOL)
    with capsys.disabled():
        print(f"\n{family} {knobs}: calls {spies.calls}, flipped codes {flipped} of {total}, "
              f"errors {errs}")


def _compare(family, jout, tout, tol):
    """Logits within tol[0] of the largest, boxes within tol[1]; returns the
    errors (relative for logits)."""
    logit_tol, box_tol = tol
    errs = {}
    if family == "rtdetr":  # the decoder over the queries both select (top-k near ties)
        for i in range(2):
            tb, jb = tout["enc_topk_bboxes"][i].numpy(), np.asarray(jout["enc_topk_bboxes"][i])
            d = np.abs(tb[:, None] - jb[None]).max(-1)
            j_idx, ok = d.argmin(1), d.min(1) <= MATCH_RADIUS
            errs[f"matched_{i}"] = float(ok.mean())
            assert ok.mean() >= 0.9, ok.mean()
            want = np.asarray(jout["logits"][i], np.float32)
            errs[f"logits_{i}"] = _close("logits", tout["logits"][i].numpy()[ok], want[j_idx[ok]],
                                         logit_tol, float(np.abs(want).max()))
            errs[f"boxes_{i}"] = _close("boxes", tout["pred_boxes"][i].numpy()[ok],
                                        np.asarray(jout["pred_boxes"][i])[j_idx[ok]], box_tol, 1.0)
        return errs
    for key, value in tout.items():
        got = value.float().numpy()
        if "box" in key:
            errs[key] = _close(key, got, jout[key], box_tol, 1.0)
        elif value.dtype.is_floating_point:
            errs[key] = _close(key, got, jout[key], logit_tol)
    return errs


def check_family_under_policy(monkeypatch, capsys, family, policy):
    """`family` under a bf16 `policy` with every knob against JAX."""
    jout, tout, spies, seen = _run(monkeypatch, family, "int8_dense_attn", policy)
    assert dict(tquant.CALLS) == spies.calls
    flipped, total = _flipped_codes(spies.inputs, seen)
    errs = _compare(family, jout, tout, TOL[policy])
    with capsys.disabled():
        print(f"\n{family} {policy} all knobs: calls {spies.calls}, flipped codes {flipped} "
              f"of {total}, errors {errs}")


# this file's families; tests/test_torch_int8_models_detr.py and _vit.py
# take the others (one file a worker, so the files run side by side)
@pytest.mark.parametrize("knobs", list(KNOB_SETS))
@pytest.mark.parametrize("family", ["rtdetr", "deformable_detr"])
def test_family_under_int8_matches_jax(monkeypatch, capsys, family, knobs):
    check_family(monkeypatch, capsys, family, knobs)


def test_family_under_int8_and_a_bf16_policy_matches_jax(monkeypatch, capsys):
    check_family_under_policy(monkeypatch, capsys, "rtdetr", "bfloat16")
