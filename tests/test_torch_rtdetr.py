"""Whole tiny RT-DETRv2: the port against the JAX package on the same weights.

Flax params are drawn from a numpy seed (tests/torch_parity.py), carried
across with `convert.from_jax`, and both run on the same NHWC pixels. JAX
runs on the CPU with its default MSDA backend there ("xla"); the port's
MSDA runs its plain path, which is what its wrapper takes for CPU tensors.

Tolerances are tests/test_rtdetr_parity.py's: boxes atol 2e-4, logits
atol 5e-4, both rtol 1e-3 — fp32 on both sides, summed in other orders
through the backbone, encoder and two decoder layers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.configs import ResNetConfig as JResNetConfig
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.configs import ResNetConfig
from spotter_tpu_torch.models.rtdetr import RTDetrDetector
from tests.torch_parity import random_flax_params


def _configs(method="default", bottleneck=False):
    """(JAX config, port config) for the zoo's tiny RT-DETR, optionally with
    a tiny bottleneck ResNet-D backbone (covers the avgpool shortcuts)."""
    jcfg = dataclasses.replace(jzoo.tiny_rtdetr_config(), decoder_method=method)
    tcfg = dataclasses.replace(tzoo.tiny_rtdetr_config(), decoder_method=method)
    if bottleneck:
        bb = dict(embedding_size=16, hidden_sizes=(32, 48, 64, 96), depths=(1, 1, 2, 1))
        jcfg = dataclasses.replace(
            jcfg, backbone=JResNetConfig(**bb), encoder_in_channels=(48, 64, 96)
        )
        tcfg = dataclasses.replace(
            tcfg, backbone=ResNetConfig(**bb), encoder_in_channels=(48, 64, 96)
        )
    return jcfg, tcfg


def _run_both(method="default", bottleneck=False, hw=(64, 64), seed=0):
    jcfg, tcfg = _configs(method, bottleneck)
    jmodel = JRTDetr(jcfg)
    x = np.random.default_rng(seed).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    params = random_flax_params(jmodel, x[:1], seed=seed)
    jout = jax.jit(jmodel.apply)({"params": params}, x)
    model = load_from_jax(RTDetrDetector(tcfg).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    return jout, tout


@pytest.mark.parametrize(
    "method,bottleneck", [("default", False), ("discrete", False), ("default", True)]
)
def test_tiny_rtdetr_matches_jax(method, bottleneck):
    jout, tout = _run_both(method, bottleneck)
    np.testing.assert_allclose(
        tout["pred_boxes"].numpy(), np.asarray(jout["pred_boxes"]), atol=2e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        tout["logits"].numpy(), np.asarray(jout["logits"]), atol=5e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        tout["aux_boxes"].numpy(), np.asarray(jout["aux_boxes"]), atol=2e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        tout["enc_topk_logits"].numpy(), np.asarray(jout["enc_topk_logits"]),
        atol=5e-4, rtol=1e-3,
    )


def test_from_jax_rejects_unmapped_and_missing_keys():
    jcfg, tcfg = _configs()
    params = random_flax_params(JRTDetr(jcfg), np.zeros((1, 64, 64, 3), np.float32))
    model = RTDetrDetector(tcfg)
    sd = state_dict_from_jax(params, model)
    assert set(sd) == set(model.state_dict())
    # one query_pos_head, shared by every decoder layer
    assert "query_pos_head.layer0.weight" in sd
    assert not any(k.startswith("decoder_layer0.query_pos_head") for k in sd)

    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        state_dict_from_jax(extra, model)
    missing = {k: v for k, v in params.items() if k != "class_head1"}
    with pytest.raises(ValueError, match="class_head1"):
        state_dict_from_jax(missing, model)


def test_seeded_init_is_deterministic_and_flax_shaped():
    """The zoo's random init: same seed, same weights; lecun-normal kernels
    (std ~ 1/sqrt(fan_in)), zero biases, identity BN statistics."""
    cfg = tzoo.tiny_rtdetr_config()
    a = tzoo.init_rtdetr(RTDetrDetector(cfg), seed=3).state_dict()
    b = tzoo.init_rtdetr(RTDetrDetector(cfg), seed=3).state_dict()
    c = tzoo.init_rtdetr(RTDetrDetector(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["class_head0.weight"], c["class_head0.weight"])
    w = a["decoder_layer0.fc1.weight"]  # (48, 32): fan_in 32
    assert abs(w.std().item() - 32**-0.5) < 0.03
    assert w.abs().max().item() <= 2 * 32**-0.5 / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(a["decoder_layer0.fc1.bias"]) == 0
    assert torch.equal(a["backbone.stem0.bn.running_var"], torch.ones(8))
    assert torch.count_nonzero(a["backbone.stem0.bn.running_mean"]) == 0
