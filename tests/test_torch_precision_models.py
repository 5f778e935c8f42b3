"""Every MSDA and DETR-lineage family under the "mixed" and "bfloat16"
policies, against the JAX module built with the same `dtype` /
`backbone_dtype`, at the zoo's tiny sizes on the CPU.

Weights are numpy-seeded flax params (tests/torch_parity.py) carried into
a port module built at the policy's dtypes, so the port stores what flax
casts them to at use; each test checks that too. Outputs must be fp32.

The JAX modules run under `jax.jit` for "float32" and "mixed", and
eagerly (`apply`, op by op) for "bfloat16": on the CPU, jit-compiled bf16
Deformable-DETR moves its own logits by 1.29 from its fp32 forward (of a
largest 4.4), eagerly by 0.043, as the port's bf16 forward does (0.048).
That is XLA's CPU compilation of the bf16 program, not the TPU's, and not
traced further here; "mixed" keeps the transformer fp32 and agrees either
way.

The JAX side's MSDA runs its TPU kernel in interpret mode
(`deformable_sampling(..., backend="pallas", interpret=True)`, swapped in
for the models' calls): that is the function the TPU serves, fp32 sums
over bf16 or fp32 values. Its CPU default ("xla") sums bf16 products in
bf16, which the TPU never does (under "bfloat16" it moves Deformable-DETR's
logits by ~10 % of their largest). XLA ignores `Precision.DEFAULT` on the
CPU, while the port's MSDA runs the policy's "default" one-pass mode,
which rounds the sampling weights (and under "mixed" the fp32 values) to
bf16: a relative change of at most 2**-8 on each sampled value.

Tolerances (atol, of the largest |output| on the JAX side; boxes absolute
in normalized coordinates), each about twice the largest error measured
here:

- "mixed": the backbone is bf16 on both sides (the same rounded operands;
  the DETR lineage's outputs agree to 2e-6) and the rest fp32; the MSDA
  families carry the one-pass rounding through encoder and decoder:
  logits 1 %, boxes 3e-3 (measured: Deformable-DETR 0.09 % / 2.8e-4, two-stage
  0.14–0.18 % / 4.8e-4; RT-DETR over its matched queries 0.48 % / 1.21e-3).
- "bfloat16": bf16 activations everywhere. XLA's CPU fusion may keep a bf16
  elementwise chain (a residual add, LayerNorm's scale and shift, the
  offset arithmetic) in fp32 between ops where PyTorch rounds after each,
  so the two drift by a few bf16 ulps a layer: logits 6 % (about 8 bf16
  ulps of the largest), boxes 2e-2 (measured: the lineage 1.2-1.6 % /
  2.3e-3-6.8e-3, Deformable-DETR 1.1-2.2 % / 4.3e-3-6.6e-3, RT-DETR 3.9 %
  / 8.5e-3).
- RT-DETR's query selection: top-k over a random-init model's scores is
  chaotic at near ties (tests/test_precision.py says so). So the test
  compares what is continuous: the encoder scores before selection and
  the sorted top-k scores, with the logit tolerance (measured 0.32 % and
  0.22 % "mixed", 1.4 % and 0.94 % "bfloat16"); then the decoder outputs
  over the queries both packages select, matched by `enc_topk_bboxes`
  (nearest box within 1e-2, about 2 bf16 ulps of a logit near 2 through the
  sigmoid). The matched share is printed and must be at least 90 % of the
  queries (measured 100 % "mixed", 93-97 % "bfloat16"); under "float32" it
  is 100 % with the fp32 bounds (logits 2e-4 of the largest, boxes 2e-4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import conditional_detr as jcond
from spotter_tpu.models import dab_detr as jdab
from spotter_tpu.models import deformable_detr as jddetr
from spotter_tpu.models import detr as jdetr
from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.resnet import ResNetBackbone as JResNet
from spotter_tpu.ops import msda as jmsda
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.models import conditional_detr as tcond
from spotter_tpu_torch.models import dab_detr as tdab
from spotter_tpu_torch.models import deformable_detr as tddetr
from spotter_tpu_torch.models import detr as tdetr
from spotter_tpu_torch.models import rtdetr as trtdetr
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.resnet import ResNetBackbone
from spotter_tpu_torch.ops import msda as tmsda
from tests.torch_parity import random_flax_params

# policy -> (JAX dtype, JAX backbone dtype, port dtype, port backbone dtype)
POLICIES = {
    "mixed": (jnp.float32, jnp.bfloat16, torch.float32, torch.bfloat16),
    "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, torch.bfloat16),
}
TOL = {  # policy -> (logits, of the largest; boxes, absolute)
    "mixed": (1e-2, 3e-3),
    "bfloat16": (6e-2, 2e-2),
    "float32": (2e-4, 2e-4),
}
MATCH_RADIUS = 1e-2
MIN_MATCHED_SHARE = 0.9

# family -> (JAX detector, port detector, JAX tiny config, port tiny config,
# config overrides, input hw, pixel mask)
FAMILIES = {
    "rtdetr": (jrtdetr.RTDetrDetector, trtdetr.RTDetrDetector, jzoo.tiny_rtdetr_config,
               tzoo.tiny_rtdetr_config, {}, (64, 64), False),
    "deformable_detr": (jddetr.DeformableDetrDetector, tddetr.DeformableDetrDetector,
                        jzoo.tiny_deformable_detr_config, tzoo.tiny_deformable_detr_config, {},
                        (64, 64), True),
    "deformable_detr_two_stage": (
        jddetr.DeformableDetrDetector, tddetr.DeformableDetrDetector,
        jzoo.tiny_deformable_detr_config, tzoo.tiny_deformable_detr_config,
        dict(two_stage=True, two_stage_num_proposals=9), (64, 64), True),
    "detr": (jdetr.DetrDetector, tdetr.DetrDetector, jzoo.tiny_detr_config,
             tzoo.tiny_detr_config, {}, (64, 64), True),
    "table_transformer": (jdetr.DetrDetector, tdetr.DetrDetector, jzoo.tiny_detr_config,
                          tzoo.tiny_detr_config, dict(pre_norm=True), (64, 64), True),
    "conditional_detr": (jcond.ConditionalDetrDetector, tcond.ConditionalDetrDetector,
                         jzoo.tiny_conditional_detr_config, tzoo.tiny_conditional_detr_config,
                         {}, (64, 64), True),
    "dab_detr": (jdab.DabDetrDetector, tdab.DabDetrDetector, jzoo.tiny_dab_detr_config,
                 tzoo.tiny_dab_detr_config, {}, (64, 64), True),
}
# the raw tables flax creates as params and casts at use; the port keeps them fp32
FP32_TABLES = ("query_embed", "level_embed", "query_embeddings", "query_pos", "query_refpoints")


def _fp32_key(key: str) -> bool:
    """A raw table, a PReLU slope, or Deformable-DETR's fp32 reference head."""
    return (key in FP32_TABLES or key.endswith("activation.weight")
            or key.startswith("reference_points_proj."))


@pytest.fixture
def tpu_msda(monkeypatch):
    """The JAX models' MSDA through its TPU kernel in interpret mode."""
    tpu = functools.partial(jmsda.deformable_sampling, backend="pallas", interpret=True)
    monkeypatch.setattr(jrtdetr, "deformable_sampling", tpu)
    monkeypatch.setattr(jddetr, "deformable_sampling", tpu)


def _inputs(hw, masked, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, *hw, 3)).astype(np.float32)
    if not masked:
        return (x,)
    mask = np.ones((2, *hw), np.float32)
    mask[0, :, hw[1] * 5 // 8:] = 0
    mask[1, hw[0] * 3 // 4:, :] = 0
    return x * mask[..., None], mask


def _run(family, policy, monkeypatch, capture=False):
    """(JAX outputs, port outputs, port model, params, JAX intermediates)
    under `policy`, on the same params and inputs."""
    jcls, tcls, jtiny, ttiny, kw, hw, masked = FAMILIES[family]
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    monkeypatch.setattr(tmsda, "MSDA_PRECISION", None)  # follows the policy
    fuse = policy == "bfloat16"
    monkeypatch.delenv("SPOTTER_TPU_REP_FUSE", raising=False)
    monkeypatch.setattr(jrtdetr, "REP_FUSE", fuse)  # the JAX package reads it at import
    jd, jbd, td, tbd = POLICIES.get(policy, (jnp.float32,) * 2 + (torch.float32,) * 2)
    jcfg, tcfg = dataclasses.replace(jtiny(), **kw), dataclasses.replace(ttiny(), **kw)
    args = _inputs(hw, masked)
    params = random_flax_params(jcls(jcfg), *(a[:1] for a in args), seed=3)
    jmodel = jcls(jcfg, dtype=jd, backbone_dtype=jbd)
    inter = None
    # eager, op by op, under "bfloat16" (see the module docstring)
    apply = functools.partial(jmodel.apply, capture_intermediates=capture)
    if policy != "bfloat16":
        apply = jax.jit(apply)
    jout = apply({"params": params}, *args)
    if capture:
        jout, state = jout
        inter = state["intermediates"]
    model = load_from_jax(tcls(tcfg, dtype=td, backbone_dtype=tbd).eval(), params)
    with torch.inference_mode():
        tout = model(*(torch.from_numpy(a) for a in args))
    return jout, tout, model, params, inter


def _check_stored_weights(model, params, dtype, backbone_dtype):
    """Each state-dict tensor is the flax param cast to the dtype the policy
    computes it at: backbone convolutions at the backbone dtype, the other
    convolutions and dense layers at the compute dtype, norm statistics and
    scales and the raw tables fp32 (flax keeps its params fp32 and casts
    them at use; those it does not cast, the port keeps fp32), and so are
    the ConvNorm and QuantDense kernels, which the port keeps as fp32
    masters (an int8 path quantizes the fp32 param) and casts at use."""
    ref = state_dict_from_jax(params, model)  # fp32-valued, at the port's dtypes
    wide = {k: torch.from_numpy(np.asarray(v)) for k, v in _flat_fp32(params, model).items()}
    norms = set()  # and the fp32 masters of ConvNorm and QuantDense
    for name, module in model.named_modules():
        if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)) or \
                type(module).__name__ in ("FrozenBatchNorm", "QuantDense"):
            norms.update(f"{name}.{p}" for p, _ in module.state_dict().items())
        elif type(module).__name__ == "ConvNorm":
            norms.add(f"{name}.conv.weight")
    for key, tensor in model.state_dict().items():
        if key in norms or _fp32_key(key):
            want = torch.float32
        elif key.startswith("backbone."):
            want = backbone_dtype
        else:
            want = dtype
        assert tensor.dtype == want, (key, tensor.dtype, want)
        assert torch.equal(tensor, wide[key].to(want)), key
        assert torch.equal(tensor, ref[key]), key


def _flat_fp32(params, model):
    """The params in the port's layout at fp32 (an fp32 twin's state dict)."""
    twin = type(model)(model.config).eval()
    return state_dict_from_jax(params, twin)


def _assert_close(name, got, want, rel_atol, scale=None):
    """Max abs error within rel_atol * scale (default: the largest finite
    |want|); non-finite entries (two-stage's +inf proposal logits) must
    sit at the same places with the same values."""
    want = np.asarray(want, np.float32)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    got, want = got[finite], want[finite]
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= rel_atol * scale, (name, err, rel_atol * scale)
    return err / max(scale, 1e-30)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "rtdetr"])
def test_family_matches_jax_under_policy(monkeypatch, tpu_msda, family, policy):
    """Deformable-DETR (plain and two-stage), DETR, Table-Transformer,
    Conditional-DETR and DAB-DETR: fp32 outputs, logits and boxes (and every
    other output) within the policy's tolerance, weights stored as flax
    casts them."""
    jout, tout, model, params, _ = _run(family, policy, monkeypatch)
    _, _, dtype, backbone_dtype = POLICIES[policy]
    _check_stored_weights(model, params, dtype, backbone_dtype)
    logit_tol, box_tol = TOL[policy]
    assert set(tout) == set(jout)
    for key, value in tout.items():
        assert value.dtype == torch.float32, key
        if "box" in key:  # (two-stage's coord logits are logits)
            _assert_close(key, value.numpy(), jout[key], box_tol, scale=1.0)
        else:
            _assert_close(key, value.numpy(), jout[key], logit_tol)


def _match(tb, jb):
    """For each port query, the JAX query whose selected box is nearest,
    and whether it lies within MATCH_RADIUS."""
    d = np.abs(tb[:, None, :] - jb[None, :, :]).max(-1)
    return d.argmin(1), d.min(1) <= MATCH_RADIUS


@pytest.mark.parametrize("policy", ["float32", *POLICIES])
def test_rtdetr_matches_jax_over_the_queries_both_select(monkeypatch, tpu_msda, policy,
                                                         capsys):
    """RT-DETR: the continuous parts (encoder scores before selection,
    sorted top-k scores), then the decoder's logits and boxes over the
    queries both packages select, matched by their selected boxes (module
    docstring); the matched share is printed."""
    jout, tout, model, params, inter = _run("rtdetr", policy, monkeypatch, capture=True)
    if policy in POLICIES:
        _check_stored_weights(model, params, *POLICIES[policy][2:])
    logit_tol, box_tol = TOL[policy]
    for key, value in tout.items():
        assert value.dtype == (torch.int64 if key == "enc_topk_index" else torch.float32), key
    # encoder scores before selection, the port's through a hook on the same head
    scores = {}

    def keep(module, args, output) -> None:  # returns None: the output stays as it is
        scores["port"] = output.float()

    hook = model.enc_score_head.register_forward_hook(keep)
    x = _inputs((64, 64), False)[0]
    with torch.inference_mode():
        model(torch.from_numpy(x))
    hook.remove()
    jscores = np.asarray(inter["enc_score_head"]["__call__"][0], np.float32)
    _assert_close("encoder scores", scores["port"].max(-1).values.numpy(), jscores.max(-1),
                  logit_tol)
    _assert_close("sorted top-k scores",
                  np.sort(tout["enc_topk_logits"].numpy().max(-1), -1),
                  np.sort(np.asarray(jout["enc_topk_logits"], np.float32).max(-1), -1),
                  logit_tol)
    shares = []
    for i in range(2):
        j_idx, ok = _match(tout["enc_topk_bboxes"][i].numpy(),
                           np.asarray(jout["enc_topk_bboxes"][i]))
        shares.append(float(ok.mean()))
        want_logits = np.asarray(jout["logits"][i], np.float32)
        _assert_close("logits", tout["logits"][i].numpy()[ok], want_logits[j_idx[ok]],
                      logit_tol, scale=float(np.abs(want_logits).max()))
        _assert_close("boxes", tout["pred_boxes"][i].numpy()[ok],
                      np.asarray(jout["pred_boxes"][i])[j_idx[ok]], box_tol, scale=1.0)
    with capsys.disabled():
        print(f"\nRT-DETR {policy}: matched share of selected queries {shares}")
    assert min(shares) >= (1.0 if policy == "float32" else MIN_MATCHED_SHARE), shares


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("style,layer_type", [("d", "basic"), ("d", "bottleneck"),
                                              ("v1", "basic")])
def test_tiny_resnet_matches_jax_under_policy(policy, style, layer_type):
    """The backbone alone at the policy's backbone dtype (bf16 under both):
    every returned map within 4 bf16 ulps of the largest (stem, pools,
    shortcuts, each rounded on the port's side; measured 2)."""
    from spotter_tpu.models.configs import ResNetConfig as JCfg
    from spotter_tpu_torch.models.configs import ResNetConfig as TCfg

    kw = dict(embedding_size=8, hidden_sizes=(8, 12, 16, 24), depths=(1, 1, 2, 1),
              layer_type=layer_type, style=style, out_indices=(2, 3, 4))
    if layer_type == "bottleneck":
        kw["hidden_sizes"] = (16, 24, 32, 48)
    jd, _, td, _ = (jnp.bfloat16, None, torch.bfloat16, None)
    x = np.random.default_rng(0).uniform(-2, 2, (2, 48, 40, 3)).astype(np.float32)
    jmodel = JResNet(JCfg(**kw), dtype=jd)
    params = random_flax_params(jmodel, x[:1], seed=5)
    jfeats = jmodel.apply({"params": params}, x)
    model = load_from_jax(ResNetBackbone(TCfg(**kw), dtype=td).eval(), params)
    with torch.no_grad():
        feats = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for jf, tf in zip(jfeats, feats):
        assert tf.dtype == torch.bfloat16
        want = np.asarray(jf, np.float32)
        got = tf.float().permute(0, 2, 3, 1).numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


@pytest.mark.parametrize("name", ["PekingU/rtdetr_v2_r101vd", "SenseTime/deformable-detr",
                                  "facebook/detr-resnet-50", "IDEA-Research/dab-detr-resnet-50"])
def test_seeded_model_under_mixed_stores_the_rounded_float32_draws(monkeypatch, name):
    """The zoo's seeded init draws fp32 from the seed stream and rounds it:
    a seed-0 model under "mixed" holds the seed-0 "float32" model's weights
    cast to its own dtypes, bit for bit."""
    from spotter_tpu_torch.models import registry

    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "float32")
    f32 = registry.build_detector(name, tiny=True, seed=0).module.state_dict()
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "mixed")
    mixed = registry.build_detector(name, tiny=True, seed=0).module.state_dict()
    model = registry.build_detector(name, tiny=True, seed=0).module
    assert any(getattr(m, "dtype", None) == torch.bfloat16 for m in model.modules())
    for key, tensor in mixed.items():
        assert torch.equal(tensor, f32[key].to(tensor.dtype)), key


@pytest.mark.parametrize("policy", list(POLICIES))
def test_checkpoint_loaded_under_policy_equals_the_seeded_model(tmp_path, monkeypatch, policy):
    """A tiny RT-DETR checkpoint written by tools/hf_checkpoint.py from the
    seeded fp32 model, loaded under the policy, holds what the seeded model
    built under the policy holds, bit for bit (the loader casts the fp32
    params as they load and stays strict), and its forward equals it."""
    from spotter_tpu_torch.models import registry
    from spotter_tpu_torch.tools import hf_checkpoint

    name = "PekingU/rtdetr_v2_r18vd"
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "float32")
    path = tmp_path / "PekingU" / "rtdetr_v2_r18vd"
    hf_checkpoint.write_checkpoint(registry.build_detector(name, tiny=True, seed=5).module,
                                   "rtdetr", path)
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    seeded = registry.build_detector(name, tiny=True, seed=5).module
    loaded = registry.build_detector(str(path), tiny=False).module
    want, got = seeded.state_dict(), loaded.state_dict()
    assert set(got) == set(want)
    for key, tensor in want.items():
        assert got[key].dtype == tensor.dtype and torch.equal(got[key], tensor), key
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        a, b = seeded(x), loaded(x)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("knob", ["SPOTTER_TPU_INT8", "SPOTTER_TPU_INT8_DENSE",
                                  "SPOTTER_TPU_INT8_ATTN"])
@pytest.mark.parametrize("name", ["SenseTime/deformable-detr", "facebook/detr-resnet-50",
                                  "microsoft/conditional-detr-resnet-50",
                                  "IDEA-Research/dab-detr-resnet-50"])
def test_int8_knobs_still_raise_under_every_policy_family(monkeypatch, knob, name):
    """Formerly a refusal: under "mixed" each int8 knob builds these
    families. SPOTTER_TPU_INT8 takes their ResNet's ConvNorm layers to the
    int8 path, _INT8_DENSE or _INT8_ATTN alone is a no-op (the float forward
    bit for bit), and "0" keeps the float path."""
    from spotter_tpu_torch.models import registry
    from tests.test_torch_int8 import assert_knob_serves

    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "mixed")
    monkeypatch.setattr(tmsda, "MSDA_PRECISION", None)
    args = [torch.from_numpy(a) for a in _inputs((64, 64), True)]
    assert_knob_serves(monkeypatch, knob,
                       lambda: registry.build_detector(name, tiny=True).module.eval(),
                       lambda m: m(*args), quantizes=knob == "SPOTTER_TPU_INT8")


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", ["PekingU/rtdetr_v2_r101vd", "SenseTime/deformable-detr",
                                  "facebook/detr-resnet-50",
                                  "microsoft/table-transformer-detection",
                                  "microsoft/conditional-detr-resnet-50",
                                  "IDEA-Research/dab-detr-resnet-50"])
def test_family_serves_through_the_engine_and_detect_under_policy(monkeypatch, tmp_path,
                                                                  name, policy):
    """Each family built under the policy by the replica's own entry
    (`build_detector_app`, tiny) answers InferenceEngine.detect and POST
    /detect with the reference wire schema, its backbone stored in bf16."""
    import asyncio

    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer
    from PIL import Image

    from spotter_tpu_torch.serving.app import build_detector_app
    from spotter_tpu_torch.serving.standalone import make_app

    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    monkeypatch.setattr(tmsda, "MSDA_PRECISION", None)
    rng = np.random.default_rng(7)
    photos = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(2)]
    for i, p in enumerate(photos):
        Image.fromarray(p).save(tmp_path / f"p{i}.png")
    det = build_detector_app(name, tiny=True, device="cpu", batch_buckets=(1, 2))
    assert det.engine.built.module.backbone.stem0.dtype == torch.bfloat16  # (an fp32 master kernel)
    assert len(det.engine.detect(photos)) == 2

    async def run():
        static = web.Application()
        static.router.add_static("/img", str(tmp_path))
        async with TestServer(static) as images:
            client = TestClient(TestServer(make_app(detector=det)))
            await client.start_server()
            try:
                urls = [str(images.make_url(f"/img/p{i}.png")) for i in range(2)]
                resp = await client.post("/detect", json={"image_urls": urls})
                return resp.status, await resp.json()
            finally:
                await client.close()

    status, body = asyncio.run(run())
    assert status == 200 and len(body["images"]) == 2
    assert isinstance(body["amenities_description"], str)
    assert all("detections" in img for img in body["images"])
