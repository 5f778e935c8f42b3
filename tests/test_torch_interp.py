"""Off-native position tables: the port's bicubic table resize
(spotter_tpu_torch.ops.resize) against `jax.image.resize(..., "bicubic")`,
and tiny YOLOS (mid tables on and off) and tiny OWL at input sizes other
than their trained ones, against the JAX modules on the same weights.

Tolerances, each for its reason:
- The resize: 1e-6 of the table's largest magnitude. The weights are JAX's
  to one fp32 ulp (XLA fuses their arithmetic), and XLA's CPU dot at
  HIGHEST lands up to ~2.3e-6 from the float64 product of a unit-normal
  table (the port ~3.4e-7); the models' tables are drawn at std 0.02.
- The models: tests/test_torch_yolos.py's and tests/test_torch_owlvit.py's
  fp32 tolerances, atol 1e-5 / rtol 1e-5 on logits and boxes (and OWL's
  objectness): fp32 on both sides, summed in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.owlvit import OwlViTDetector as JOwl
from spotter_tpu.models.yolos import YolosDetector as JYolos
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import owlvit as towl
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.yolos import YolosDetector
from spotter_tpu_torch.ops import resize
from tests.torch_parity import random_flax_params

TOL = dict(atol=1e-5, rtol=1e-5)
RESIZE_RTOL_OF_MAX = 1e-6


@pytest.mark.parametrize("src,dst", [
    ((4, 6), (7, 9)),      # up, both axes
    ((10, 12), (4, 5)),    # down, both axes (antialiased)
    ((6, 6), (6, 9)),      # one axis only
    ((8, 5), (3, 11)),     # down one axis, up the other
    ((50, 84), (42, 60)),  # yolos-base's grid, shrunk
    ((24, 24), (30, 17)),  # OWL-sized, non-square
])
def test_bicubic_table_resize_matches_jax(src, dst):
    d = 16
    t = np.random.default_rng(sum(src) + 7 * sum(dst)).standard_normal(
        (1, src[0] * src[1], d)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(t).reshape(1, *src, d), (1, *dst, d),
                                       "bicubic")).reshape(1, -1, d)
    got = resize.resize_table_bicubic(torch.from_numpy(t), src, dst)
    assert got.dtype == torch.float32 and got.shape == (1, dst[0] * dst[1], d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RESIZE_RTOL_OF_MAX * np.abs(t).max())


def test_bicubic_weights_are_jax_weights_and_kept():
    from jax._src.image import scale as jscale

    for m, n in ((24, 30), (24, 17), (84, 60), (4, 7)):
        want = np.asarray(jscale.compute_weight_mat(
            m, n, jnp.float32(n / m), jnp.float32(0.0), jscale._fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(resize.bicubic_weights(m, n).numpy(), want, rtol=0,
                                   atol=2.0**-23)
    cpu = torch.device("cpu")
    assert resize._weight_table(5, 7, cpu) is resize._weight_table(5, 7, cpu)
    table = torch.zeros(1, 12, 4)
    assert resize.resize_table_bicubic(table, (3, 4), (3, 4)) is table


@pytest.mark.parametrize("hw", [(40, 56), (24, 32), (16, 64)],
                         ids=["up", "down", "non_square"])
@pytest.mark.parametrize("use_mid", [True, False], ids=["mid", "no_mid"])
def test_tiny_yolos_off_native_matches_jax(hw, use_mid):
    jcfg = dataclasses.replace(jzoo.tiny_yolos_config(), use_mid_position_embeddings=use_mid)
    tcfg = dataclasses.replace(tzoo.tiny_yolos_config(), use_mid_position_embeddings=use_mid)
    native = np.random.default_rng(0).standard_normal((1, 32, 48, 3)).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    jmodel = JYolos(jcfg)
    params = random_flax_params(jmodel, native, seed=3)
    jout = jax.jit(jmodel.apply)({"params": params}, x)
    model = load_from_jax(YolosDetector(tcfg).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    for key in ("logits", "pred_boxes"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), **TOL)
    assert tout["logits"].shape == (2, 5, 81)


def test_yolos_input_not_a_multiple_of_the_patch_raises():
    model = YolosDetector(tzoo.tiny_yolos_config())
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 30, 48, 3))


@pytest.mark.parametrize("hw", [(48, 48), (24, 40)], ids=["up", "non_square"])
@pytest.mark.parametrize("objectness", [False, True], ids=["owlvit", "owlv2"])
def test_tiny_owl_off_native_matches_jax(hw, objectness):
    jcfg = dataclasses.replace(jzoo.tiny_owlvit_config(), objectness=objectness)
    tcfg = dataclasses.replace(tzoo.tiny_owlvit_config(), objectness=objectness)
    rng = np.random.default_rng(5)
    native = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ids, mask = jzoo._tiny_tokenize(["a photo of a couch", "a photo of a tv"], 99, 8)
    jm = JOwl(jcfg)
    params = random_flax_params(jm, native, ids, mask, seed=3, method=JOwl.detect_with_text)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=JOwl.detect_with_text))(
        params, x, ids, mask)
    tm = load_from_jax(towl.OwlViTDetector(tcfg).eval(), params)
    with torch.inference_mode():
        got = tm.detect_with_text(*map(torch.from_numpy, (x, ids, mask)))
    patches = (hw[0] // 8) * (hw[1] // 8)
    assert got["logits"].shape == (2, patches, 2)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


def test_owl_input_not_a_multiple_of_the_patch_raises():
    model = towl.OwlViTDetector(tzoo.tiny_owlvit_config())
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 30, 32, 3), torch.zeros(3, 16))
