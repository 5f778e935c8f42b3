"""The open-vocabulary parts of the port against the JAX package: the
class-logit head (`spotter_tpu_torch.ops.openvocab`) and its knob, the token
ids (`convert.tokens`), the text cache (`caching.text_cache`), the
scheduler's query groups, `quick_gelu` and `sigmoid_max_postprocess`.

Tolerances, each for its reason:
- `class_logits_reference` against JAX's `_class_logits_ref`: atol 1e-6. Both
  widen the features to fp32 and sum 16 fp32 products per logit in another
  order, on logits of a few units; masked columns are NEG_INF exactly.
- The class head (dense0, shift, scale, then the tail) under
  SPOTTER_TPU_OWL_FUSED=0 and =1 on both sides (JAX's =1 runs the Pallas
  kernel in interpret mode, the port's its plain version): atol 1e-5, fp32
  dense layers of 20 inputs plus the tail, summed in other orders.
- The card kernel's split-TF32 arithmetic replayed on the CPU
  (`tools.class_logits_rounding`) against JAX's reference and its Pallas
  kernel in interpret mode: within 1e-5 of the largest unmasked logit, the
  card's gate (two TF32 terms of each operand; the tool puts them ~3e-7
  away).
- `quick_gelu`: fp32 within 1e-6; bf16 within one bf16 ulp (both round
  after each op at bf16).
- `sigmoid_max_postprocess`: labels equal (ties go to the first index),
  scores within 1e-7, boxes within 1e-4 px.
"""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.caching.keys import queries_key as j_queries_key
from spotter_tpu.caching.text_cache import TextQueryResolver as JResolver
from spotter_tpu.engine.scheduler import QueueItem as JItem
from spotter_tpu.engine.scheduler import Scheduler as JScheduler
from spotter_tpu.models import layers as jl
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.owlvit import OwlViTClassHead as JClassHead
from spotter_tpu.ops import openvocab as jov
from spotter_tpu.ops import postprocess as jpost
from spotter_tpu_torch.caching.keys import queries_key
from spotter_tpu_torch.caching.text_cache import QuerySet, TextQueryResolver
from spotter_tpu_torch.convert import tokens
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.metrics import Metrics
from spotter_tpu_torch.engine.scheduler import QueueItem, Scheduler
from spotter_tpu_torch.models import layers as tl
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.owlvit import OwlViTClassHead
from spotter_tpu_torch.ops import openvocab
from spotter_tpu_torch.ops import postprocess as tpost
from spotter_tpu_torch.tools import class_logits_rounding
from tests.torch_parity import random_flax_params

NEG_INF = openvocab.NEG_INF


def _logit_inputs(b=2, p=12, dt=16, q=7, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, p, dt)).astype(np.float32)
    bank = rng.standard_normal((q, dt)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    shift = rng.standard_normal((b, p)).astype(np.float32)
    scale = (2.0 * rng.standard_normal((b, p))).astype(np.float32)  # both elu branches
    mask = np.array([1, 1, 0, 1, 1, 0, 1], np.int32)[:q]
    return img, bank, shift, scale, mask


@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_class_logits_reference_matches_jax_ref(img_dtype, masked):
    img, bank, shift, scale, mask = _logit_inputs()
    qmask = mask if masked else np.ones_like(mask)
    jimg = jnp.asarray(img).astype(getattr(jnp, img_dtype))
    want = np.asarray(jov._class_logits_ref(
        jimg, jnp.asarray(bank.T), jnp.stack([shift, scale], axis=-1),
        jnp.asarray(qmask, jnp.float32)[None]))
    timg = torch.from_numpy(img).to(getattr(torch, img_dtype))
    got = openvocab.class_logits_reference(
        timg, torch.from_numpy(bank), torch.from_numpy(shift), torch.from_numpy(scale),
        torch.from_numpy(mask) if masked else None).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 12, 7)
    real = qmask == 1
    np.testing.assert_allclose(got[..., real], want[..., real], atol=1e-6)
    if masked:
        assert np.all(got[..., ~real] == NEG_INF) and np.all(want[..., ~real] == NEG_INF)
        winners = got.argmax(-1)
        assert not np.isin(winners, np.flatnonzero(~real)).any()


@pytest.fixture(scope="module")
def head_params():
    cfg = jzoo.tiny_owlvit_config()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 16, cfg.vision.hidden_size)).astype(np.float32)
    queries = rng.standard_normal((7, cfg.text.hidden_size)).astype(np.float32)
    params = random_flax_params(JClassHead(cfg), feats, queries, seed=5)
    return cfg, feats, queries, params


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("masked", [False, True])
def test_class_head_matches_jax_under_the_knob(monkeypatch, head_params, fused, masked):
    cfg, feats, queries, params = head_params
    qmask = np.array([1, 1, 0, 1, 1, 0, 1], np.int32) if masked else None
    monkeypatch.setattr(jov, "OWL_FUSED", fused)  # "1": the Pallas kernel, interpreted
    want = np.asarray(JClassHead(cfg).apply(
        {"params": params}, feats, queries, None if qmask is None else jnp.asarray(qmask)))
    monkeypatch.setattr(openvocab, "OWL_FUSED", fused)
    head = load_from_jax(OwlViTClassHead(tzoo.tiny_owlvit_config()).eval(), params)
    with torch.inference_mode():
        got = head(torch.from_numpy(feats), torch.from_numpy(queries),
                   None if qmask is None else torch.from_numpy(qmask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if masked:
        assert np.all(got[..., [2, 5]] == NEG_INF)


def test_fused_head_routes_through_the_wrapper(monkeypatch, head_params):
    """auto and =1 call `owl_class_logits` (its plain version on the CPU); =0
    does not; a CPU call of the wrapper launches nothing."""
    cfg, feats, queries, params = head_params
    calls = []
    real = openvocab.owl_class_logits

    def spy(*args):
        calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr("spotter_tpu_torch.models.owlvit.owl_class_logits", spy)
    head = load_from_jax(OwlViTClassHead(tzoo.tiny_owlvit_config()).eval(), params)
    x, q = torch.from_numpy(feats), torch.from_numpy(queries)
    before = openvocab.owl_class_logits.launches
    for value, routed in (("auto", True), ("0", False), ("1", True)):
        monkeypatch.setattr(openvocab, "OWL_FUSED", value)
        calls.clear()
        with torch.inference_mode():
            head(x, q)
        assert bool(calls) == routed, value
    assert openvocab.owl_class_logits.launches == before


@pytest.mark.parametrize("raw,value", [("auto", "auto"), (" 1 ", "1"), ("0", "0"),
                                       ("AUTO", "auto")])
def test_owl_fused_knob_values(raw, value):
    assert openvocab.parse_owl_fused(raw) == value


def test_owl_fused_knob_error_text_matches_jax():
    import os
    import subprocess
    import sys

    env = dict(os.environ, SPOTTER_TPU_OWL_FUSED="bogus", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", "import spotter_tpu.ops.openvocab"], env=env,
                          capture_output=True, text=True, timeout=240)
    want = proc.stderr.strip().splitlines()[-1]
    with pytest.raises(ValueError) as got:
        openvocab.parse_owl_fused("bogus")
    assert want == f"ValueError: {got.value}"


@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dt", [512, 100])
def test_split_tf32_emulation_matches_jax_within_the_gate(img_dtype, dt):
    """The class-logit kernel's arithmetic replayed on the CPU
    (`tools.class_logits_rounding.split_tf32_logits`: two TF32 terms of each
    operand over the kernel's k-steps, the accumulators truncated at each
    wgmma) against the JAX
    package's reference and its Pallas kernel in interpret mode: within 1e-5
    of the largest unmasked logit (chip_smoke's gate), masked columns
    NEG_INF in all three."""
    img, bank, shift, scale, mask = _logit_inputs(b=2, p=40, dt=dt, q=7, seed=11)
    jimg = jnp.asarray(img).astype(getattr(jnp, img_dtype))
    j_ref = np.asarray(jov._class_logits_ref(
        jimg, jnp.asarray(bank.T), jnp.stack([shift, scale], axis=-1),
        jnp.asarray(mask, jnp.float32)[None]))
    j_kernel = np.asarray(jov.fused_class_logits(
        jimg, jnp.asarray(bank), jnp.asarray(shift), jnp.asarray(scale), jnp.asarray(mask),
        interpret=True))
    got = class_logits_rounding.split_tf32_logits(
        torch.from_numpy(img).to(getattr(torch, img_dtype)), torch.from_numpy(bank),
        torch.from_numpy(shift), torch.from_numpy(scale), torch.from_numpy(mask)).numpy()
    real = mask == 1
    for want in (j_ref, j_kernel):
        assert got.shape == want.shape == (2, 40, 7)
        atol = 1e-5 * np.abs(want[..., real]).max()
        np.testing.assert_allclose(got[..., real], want[..., real], rtol=0, atol=atol)
        assert np.all(got[..., ~real] == NEG_INF) and np.all(want[..., ~real] == NEG_INF)


def test_wrapper_checks_its_inputs():
    img, bank, shift, scale, mask = map(torch.from_numpy, _logit_inputs())
    with pytest.raises(ValueError, match="shift and scale"):
        openvocab.owl_class_logits(img, bank, shift[:, :3], scale)
    with pytest.raises(ValueError, match="mask must be"):
        openvocab.owl_class_logits(img, bank, shift, scale, mask[:3])
    with pytest.raises(TypeError, match="queries must be float32"):
        openvocab.owl_class_logits(img, bank.double(), shift, scale)
    with pytest.raises(ValueError, match="expected img"):
        openvocab.owl_class_logits(img[0], bank, shift, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("img_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 576, 22, 0), (2, 1000, 24, 2), (1, 130, 70, 5)])
def test_kernel_matches_plain_version_on_the_card(img_dtype, shape):
    """Within 1e-5 of the largest unmasked logit (fp32 sums of 512 products
    in another order); masked columns NEG_INF bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    b, p, q, n_masked = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn((b, p, 512), generator=gen, device="cuda").to(img_dtype)
    bank = torch.nn.functional.normalize(torch.randn((q, 512), generator=gen, device="cuda"),
                                         dim=-1)
    shift, scale = (torch.randn((b, p), generator=gen, device="cuda") for _ in range(2))
    mask = torch.ones(q, dtype=torch.int32, device="cuda")
    mask[q - n_masked:] = 0
    got = openvocab.owl_class_logits(img, bank, shift, scale, mask)
    want = openvocab.class_logits_reference(img, bank, shift, scale, mask)
    real = slice(0, q - n_masked)
    atol = 1e-5 * want[..., real].abs().max().item()
    assert (got[..., real] - want[..., real]).abs().max().item() <= atol
    assert (got[..., q - n_masked:] == NEG_INF).all()


# --- quick_gelu and the sigmoid-max postprocess ---------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quick_gelu_matches_jax(dtype):
    x = np.random.default_rng(6).uniform(-6, 6, (4, 33)).astype(np.float32)
    want = np.asarray(jl.get_activation("quick_gelu")(jnp.asarray(x, dtype)), np.float32)
    got = tl.get_activation("quick_gelu")(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-6) if dtype == "float32" else dict(atol=2**-8, rtol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("ties", [False, True])
def test_sigmoid_max_postprocess_matches_jax(ties):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 5)).astype(np.float32)
    if ties:
        logits[0, 0] = [1.0, 3.0, 3.0, 0.0, NEG_INF]  # a tie at 1 and 2
        logits[1, :, :] = NEG_INF  # every query masked out: all-zero scores
        logits[1, :, :2] = -40.0  # sigmoid underflows to equal values
    boxes = rng.uniform(0.1, 0.9, (2, 9, 4)).astype(np.float32)
    sizes = np.asarray([[960, 960], [768, 768]], np.float32)
    want = jpost.sigmoid_max_postprocess(logits, boxes, sizes)
    got = tpost.sigmoid_max_postprocess(*map(torch.from_numpy, (logits, boxes, sizes)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    if ties:
        assert got[1][0, 0] == 1 and (got[1][1] == 0).all()


# --- token ids -------------------------------------------------------------


def _write_table(root, model, table):
    path = root / f"{model.replace('/', '--')}--v3" / "tokenized.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(table))
    return path


def test_owlvit_tokenize_reads_the_jax_cache(tmp_path, monkeypatch):
    """The port reads the file where and as the JAX package writes it: both
    return the same arrays for prompts the file holds."""
    from spotter_tpu.convert.loader import owlvit_tokenize as j_tokenize

    model = "google/owlv2-base-patch16-ensemble"
    table = {"a photo of a tv": {"ids": [49406, 320, 1125, 49407, 0, 0],
                                 "mask": [1, 1, 1, 1, 0, 0]},
             "a photo of a bed": {"ids": [49406, 320, 2722, 49407, 0, 0],
                                  "mask": [1, 1, 1, 1, 0, 0]}}
    path = _write_table(tmp_path, model, table)
    monkeypatch.setenv("SPOTTER_TPU_CACHE", str(tmp_path))
    assert tokens.tokenization_path(model) == path
    prompts = ["a photo of a bed", "a photo of a tv"]
    ids, mask = tokens.owlvit_tokenize(model, prompts, 6)
    j_ids, j_mask = j_tokenize(model, prompts, 6)
    assert ids.dtype == mask.dtype == np.int32
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(mask, j_mask)


def test_owlvit_tokenize_raises_for_missing_prompts(tmp_path, monkeypatch):
    model = "google/owlvit-base-patch32"
    monkeypatch.setenv("SPOTTER_TPU_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="no tokenization cache at .*tokenized.json"):
        tokens.owlvit_tokenize(model, ["a photo of a tv"], 4)
    path = _write_table(tmp_path, model, {"a photo of a tv": {"ids": [3, 5, 9, 0],
                                                               "mask": [1, 1, 1, 0]}})
    with pytest.raises(ValueError) as err:
        tokens.owlvit_tokenize(model, ["a photo of a tv", "a photo of a cat"], 4)
    assert str(path) in str(err.value) and "'a photo of a cat'" in str(err.value)
    assert "'a photo of a tv'" not in str(err.value)
    with pytest.raises(ValueError, match="rows of 6"):
        tokens.owlvit_tokenize(model, ["a photo of a tv"], 6)


def test_tiny_tokenize_is_the_jax_zoos():
    prompts = ["a photo of a couch", "a photo of a dog", ""]
    for got, want in zip(tokens.tiny_tokenize(prompts, 99, 8),
                         jzoo._tiny_tokenize(prompts, 99, 8)):
        np.testing.assert_array_equal(got, want)


# --- text cache and query groups -------------------------------------------


def _encoder(calls):
    def encode(queries):
        calls.append(list(queries))
        rng = np.random.default_rng(len(queries))
        e = rng.standard_normal((len(queries), 6)).astype(np.float32)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)
    return encode


def test_queries_key_matches_jax():
    for qs in (["dog", "couch"], ["couch", "dog"], ["palm tree"]):
        assert queries_key("m", qs) == j_queries_key("m", qs)
    assert queries_key("m", ["dog", "couch"]) == queries_key("m", ["couch", "dog"])


@pytest.mark.parametrize("pad", [8, 4, 1])
def test_resolver_pads_sorts_and_caches_like_jax(pad):
    calls, j_calls = [], []
    metrics = Metrics()
    res = TextQueryResolver("m", _encoder(calls), metrics=metrics, pad=pad)
    jres = JResolver("m", _encoder(j_calls), pad=pad)
    qs = res.resolve([" tv", "couch", "dog", ""])
    jqs = jres.resolve([" tv", "couch", "dog", ""])
    assert qs.labels == jqs.labels == ("couch", "dog", "tv")
    assert (qs.key, qs.digest) == (jqs.key, jqs.digest)
    np.testing.assert_array_equal(qs.embeds, jqs.embeds)
    np.testing.assert_array_equal(qs.mask, jqs.mask)
    assert qs.embeds.shape[0] == -(-3 // pad) * pad and qs.mask.sum() == 3
    assert not qs.embeds[3:].any()
    assert res.resolve(["dog", "tv", "couch"]) is qs and len(calls) == 1
    snap = metrics.snapshot()
    assert (snap["text_cache_hits_total"], snap["text_cache_misses_total"]) == (1, 1)
    assert snap["text_cache_hit_ms_p50"] is not None
    assert qs.id2label == {0: "couch", 1: "dog", 2: "tv"}


def test_resolver_rejects_empty_and_bounds_entries(monkeypatch):
    monkeypatch.setenv("SPOTTER_TPU_TEXT_CACHE_ENTRIES", "2")
    monkeypatch.setenv("SPOTTER_TPU_QUERY_PAD", "3")
    calls = []
    res = TextQueryResolver("m", _encoder(calls))
    assert (res.max_entries, res.pad) == (2, 3)
    with pytest.raises(ValueError, match="at least one non-empty"):
        res.resolve(["", "  "])
    a = res.resolve(["a"])
    res.resolve(["b"])
    assert res.resolve(["a"]) is a  # a hit refreshes "a"
    res.resolve(["c"])  # evicts "b", the least recently used
    assert res.stats() == {"enabled": True, "entries": 2, "max_entries": 2, "query_pad": 3}
    res.resolve(["b"])
    assert calls == [["a"], ["b"], ["c"], ["b"]]
    monkeypatch.setenv("SPOTTER_TPU_QUERY_PAD", "x")
    with pytest.raises(ValueError, match="SPOTTER_TPU_QUERY_PAD must be an integer"):
        TextQueryResolver("m", _encoder(calls))


def _qset(key):
    return QuerySet(key=key, digest=key, labels=("x",), embeds=np.zeros((1, 2), np.float32),
                    mask=np.ones((1,), np.int32))


class _Fut:
    @staticmethod
    def done():
        return False


@pytest.mark.parametrize("ragged", [False, True])
def test_scheduler_never_mixes_query_groups_like_jax(ragged):
    groups = ["a", "a", "b", None, "a", "b"]
    img = Image.new("RGB", (16, 16))
    mine = [QueueItem(image=img, fut=_Fut(), qset=None if g is None else _qset(g),
                      t_submit=float(i)) for i, g in enumerate(groups)]
    theirs = [JItem(image=img, fut=_Fut(), qset=None if g is None else _qset(g),
                    t_submit=float(i)) for i, g in enumerate(groups)]
    sched, jsched = Scheduler(ragged=ragged), JScheduler(spec=None, ragged=ragged)
    plans = []
    while mine:
        pack = sched.plan(mine, target=2, now=0.0).items
        jpack = jsched.plan(theirs, target=2, now=0.0).items
        assert [it.group for it in pack] == [it.group for it in jpack]
        assert len({it.group for it in pack}) == 1
        plans.append([it.group for it in pack])
    assert theirs == []
    assert plans == [["a", "a"], ["b", "b"], [None], ["a"]]


def test_batcher_passes_each_groups_query_set():
    """Four submits over two query sets and the deployment's vocabulary: no
    engine call mixes them, and each gets the batch's own `qset`."""
    calls = []

    class Engine:
        batch_buckets = (1, 2, 4, 8)
        metrics = Metrics()

        def detect(self, images, qset=None):
            calls.append((len(images), None if qset is None else qset.key))
            return [[{"label": "x", "score": 1.0, "box": [0, 0, 1, 1]}] for _ in images]

    batcher = MicroBatcher(Engine(), max_delay_ms=50.0)
    qa, qb = _qset("a"), _qset("b")

    async def drive():
        out = await asyncio.gather(*(batcher.submit(i, qset=q)
                                     for i, q in enumerate([qa, qb, qa, None, qb])))
        await batcher.stop()
        return out

    assert len(asyncio.run(drive())) == 5
    assert sorted(calls, key=str) == sorted([(2, "a"), (2, "b"), (1, None)], key=str)
