"""The port's local-checkpoint loader (spotter_tpu_torch.convert) against the
JAX package's (spotter_tpu.convert.loader): RT-DETR, YOLOS and OWL here, the
DETR lineage in test_torch_loader_lineage.py; the safetensors reader and
writer, the config view, the refusals and the checkpoint fixture.

Tiny HF models are built from a config inside each test (`torch.manual_seed`,
BatchNorm statistics drawn as in tests/test_conditional_detr_parity.py) and
written with `save_pretrained`. Both loaders read that directory: the JAX one
through `transformers` (its Orbax cache under a temporary SPOTTER_TPU_CACHE,
since that cache is keyed by the name), the port through its own reader.
Params must be equal leaf for leaf and bit for bit, and configs field for
field. Forward tolerances are tests/test_rtdetr_parity.py's: boxes atol
2e-4, logits atol 5e-4, both rtol 1e-3.
"""

import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch
from transformers import AutoConfig
from transformers import OwlViTConfig as HFOwlViTConfig
from transformers import Owlv2Config as HFOwlv2Config
from transformers import RTDetrConfig as HFRTDetrConfig
from transformers import RTDetrResNetConfig, RTDetrV2Config
from transformers import YolosConfig as HFYolosConfig
from transformers.modeling_utils import PreTrainedModel
from transformers.models.owlv2.modeling_owlv2 import Owlv2ForObjectDetection
from transformers.models.owlvit.modeling_owlvit import OwlViTForObjectDetection
from transformers.models.rt_detr.modeling_rt_detr import RTDetrForObjectDetection
from transformers.models.rt_detr_v2.modeling_rt_detr_v2 import RTDetrV2ForObjectDetection
from transformers.models.yolos.modeling_yolos import YolosForObjectDetection

from spotter_tpu.convert import loader as jloader
from spotter_tpu.models import configs as jconfigs
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu_torch.convert import checkpoint_io, loader
from spotter_tpu_torch.convert.hf_config import is_checkpoint_dir, read_hf_config
from spotter_tpu_torch.models import configs, registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.coco import coco_id2label_80
from spotter_tpu_torch.tools import hf_checkpoint

BOX_ATOL, LOGIT_ATOL, RTOL = 2e-4, 5e-4, 1e-3


@pytest.fixture(autouse=True)
def jax_cache(tmp_path, monkeypatch):
    """The JAX loader's param cache in this test's own directory."""
    monkeypatch.setenv(jloader.CACHE_ENV, str(tmp_path / "jax-cache"))


def flat(tree: dict, prefix=()) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, (*prefix, key)))
        else:
            out[(*prefix, key)] = np.asarray(value)
    return out


def assert_params_equal(got: dict, want: dict) -> None:
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def assert_same_config(port_cfg, jax_cfg) -> None:
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def draw_bn_stats(model) -> None:
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_mean") and m.running_mean is not None:
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)


def save(model_cls, hf_cfg, path, safe: bool = True):
    torch.manual_seed(0)
    model = model_cls(hf_cfg).eval()
    draw_bn_stats(model)
    model.save_pretrained(path, safe_serialization=safe)
    return model


# --- tiny HF configs (tests/test_rtdetr_parity.py, test_yolos_parity.py,
# test_owlvit_parity.py)


def tiny_rtdetr(version: int = 2):
    backbone = RTDetrResNetConfig(
        embedding_size=16, hidden_sizes=[16, 24, 32, 48], depths=[1, 1, 1, 1],
        layer_type="basic", out_features=["stage2", "stage3", "stage4"],
    )
    config_cls = RTDetrV2Config if version == 2 else HFRTDetrConfig
    return config_cls(
        backbone_config=backbone, d_model=32, encoder_hidden_dim=32,
        encoder_in_channels=[24, 32, 48], decoder_in_channels=[32, 32, 32],
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=48,
        decoder_ffn_dim=48, encoder_layers=1, decoder_layers=2, num_queries=12, num_labels=7,
        num_denoising=0, decoder_n_points=2, hidden_expansion=1.0,
        # distinct encoder scores, so top-k picks the same queries on both sides
        initializer_range=0.2,
    )


def tiny_yolos(use_mid: bool = True):
    return HFYolosConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        image_size=[32, 48], patch_size=8, num_detection_tokens=5,
        use_mid_position_embeddings=use_mid, num_labels=7,
    )


def tiny_owl(v2: bool = False):
    config_cls = HFOwlv2Config if v2 else HFOwlViTConfig
    return config_cls(
        text_config=dict(vocab_size=99, hidden_size=16, intermediate_size=24,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=8),
        vision_config=dict(hidden_size=20, intermediate_size=28, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8),
        projection_dim=16,
    )


RTDETR_MODELS = {1: RTDetrForObjectDetection, 2: RTDetrV2ForObjectDetection}


@pytest.mark.parametrize("version", [1, 2])
def test_rtdetr_checkpoint_loads_as_jax(tmp_path, version):
    """The file lacks the top-level heads (tied to the decoder's, which
    save_pretrained keeps); the port resolves the twins as from_pretrained
    does, and its params and config equal the JAX loader's."""
    path = tmp_path / "PekingU" / f"rtdetr_v{version}_tiny"
    save(RTDETR_MODELS[version], tiny_rtdetr(version), path)
    keys = set(checkpoint_io.read_checkpoint(path))
    assert not any(k.startswith(("class_embed.", "bbox_embed.")) for k in keys)
    assert any(k.startswith("model.decoder.class_embed.") for k in keys)
    jcfg, jparams = jloader.load_rtdetr_from_hf(str(path))
    cfg, params = loader.load_rtdetr_from_hf(path)
    assert_same_config(cfg, jcfg)
    assert cfg.version == version
    assert_params_equal(params, jparams)


def test_rtdetr_forward_from_checkpoint_matches_jax(tmp_path):
    """MODEL_NAME=<dir> through the port's zoo against the JAX detector on
    the JAX loader's params, on the same numpy pixels."""
    path = tmp_path / "PekingU" / "rtdetr_v2_tiny"
    save(RTDetrV2ForObjectDetection, tiny_rtdetr(), path)
    jcfg, jparams = jloader.load_rtdetr_from_hf(str(path))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jout = jax.jit(JRTDetr(jcfg).apply)({"params": jparams}, x)
    built = registry.build_detector(str(path), tiny=False)
    assert built.id2label == {i: f"LABEL_{i}" for i in range(7)}
    assert built.num_top_queries == 12  # min(300, num_queries)
    with torch.inference_mode():
        tout = built.module(torch.from_numpy(x))
    np.testing.assert_allclose(tout["pred_boxes"].numpy(), np.asarray(jout["pred_boxes"]),
                               atol=BOX_ATOL, rtol=RTOL)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_mid", [True, False])
def test_yolos_checkpoint_loads_as_jax(tmp_path, use_mid):
    path = tmp_path / "hustvl" / "yolos-tiny-test"
    save(YolosForObjectDetection, tiny_yolos(use_mid), path)
    jcfg, jparams = jloader.load_yolos_from_hf(str(path))
    cfg, params = loader.load_yolos_from_hf(path)
    assert_same_config(cfg, jcfg)
    assert_params_equal(params, jparams)
    # any YOLOS size builds from its directory: no preset is named here
    built = registry.build_detector(str(path), tiny=False)
    assert built.module.config == cfg and built.preprocess_spec.size == (32, 48)


@pytest.mark.parametrize("v2", [False, True], ids=["owlvit", "owlv2"])
def test_owl_checkpoint_loads_as_jax(tmp_path, v2):
    path = tmp_path / "google" / ("owlv2-tiny" if v2 else "owlvit-tiny")
    save(Owlv2ForObjectDetection if v2 else OwlViTForObjectDetection, tiny_owl(v2), path)
    jcfg, jparams = jloader.load_owlvit_from_hf(str(path))
    cfg, params = loader.load_owlvit_from_hf(path)
    assert_same_config(cfg, jcfg)
    assert cfg.objectness == v2
    assert_params_equal(params, jparams)


def test_owl_checkpoint_reads_its_prompts_by_the_same_name(tmp_path, monkeypatch):
    """The query ids come from tokenized.json keyed by MODEL_NAME (here the
    directory's path), as the JAX package keys its cache; a prompt the file
    lacks raises."""
    from spotter_tpu_torch.convert.tokens import tiny_tokenize, tokenization_path

    monkeypatch.setenv("SPOTTER_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv(tzoo.QUERIES_ENV, "sofa,bed")
    path = tmp_path / "google" / "owlv2-tiny"
    save(Owlv2ForObjectDetection, tiny_owl(True), path)
    prompts = ["a photo of a sofa", "a photo of a bed"]
    ids, mask = tiny_tokenize(prompts, 99, 8)
    token_file = tokenization_path(str(path))
    token_file.parent.mkdir(parents=True)
    token_file.write_text(json.dumps({prompts[0]: {"ids": ids[0].tolist(),
                                                   "mask": mask[0].tolist()}}))
    with pytest.raises(ValueError, match="has no ids for .*a photo of a bed"):
        registry.build_detector(str(path), tiny=False)
    token_file.write_text(json.dumps({p: {"ids": i.tolist(), "mask": m.tolist()}
                                      for p, i, m in zip(prompts, ids, mask)}))
    built = registry.build_detector(str(path), tiny=False)
    assert built.id2label == {0: "sofa", 1: "bed"} and built.query_embeds.shape == (2, 16)
    _, params = loader.load_owlvit_from_hf(path)
    assert_params_equal(hf_checkpoint_params(built.module), params)


def hf_checkpoint_params(module) -> dict:
    """`module`'s weights back in the flax-named tree (the fixture's inverse
    of from_jax), for comparing a built model with a loader's params."""
    state = module.state_dict()
    tree: dict = {}
    for path, key, kind in hf_checkpoint.rule_table(
            "owlvit", module.config).rules:
        value = hf_checkpoint.flax_leaf(path, state[hf_checkpoint.port_key(path)])
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value.numpy()
    return tree


# --- the config view: every key a from_hf reads, deleted one at a time


def _resnet_keys(prefix: str) -> list:
    return [f"{prefix}.{k}" for k in (
        "num_channels", "embedding_size", "hidden_sizes", "depths", "layer_type", "hidden_act",
        "downsample_in_first_stage", "downsample_in_bottleneck", "out_indices",
        "out_features")]


_RTDETR_KEYS = [
    "d_model", "num_queries", "encoder_hidden_dim", "encoder_in_channels", "feat_strides",
    "encoder_ffn_dim", "encode_proj_layers", "encoder_layers", "encoder_attention_heads",
    "encoder_activation_function", "activation_function", "hidden_expansion",
    "positional_encoding_temperature", "decoder_ffn_dim", "num_feature_levels",
    "decoder_n_points", "decoder_layers", "decoder_attention_heads",
    "decoder_activation_function", "learn_initial_query", "decoder_offset_scale",
    "decoder_method", "layer_norm_eps", "batch_norm_eps", "id2label", "backbone_config",
]
_YOLOS_KEYS = [
    "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
    "hidden_act", "image_size", "patch_size", "num_channels", "num_detection_tokens",
    "use_mid_position_embeddings", "qkv_bias", "layer_norm_eps", "id2label",
]
_OWL_TOWER = ["hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "hidden_act", "layer_norm_eps"]
_OWL_KEYS = (["projection_dim", "text_config", "vision_config"]
             + [f"text_config.{k}" for k in _OWL_TOWER + ["vocab_size",
                                                        "max_position_embeddings"]]
             + [f"vision_config.{k}" for k in _OWL_TOWER + ["image_size", "patch_size",
                                                          "num_channels"]])
# (case, HF config factory, JAX config class, port config class, keys)
CONFIG_CASES = {
    "rtdetr_v2": (tiny_rtdetr, jconfigs.RTDetrConfig, configs.RTDetrConfig,
                  _RTDETR_KEYS + _resnet_keys("backbone_config")),
    "rtdetr_v1": (lambda: tiny_rtdetr(1), jconfigs.RTDetrConfig, configs.RTDetrConfig,
                  ["d_model", "backbone_config", "id2label"]),
    "yolos": (tiny_yolos, jconfigs.YolosConfig, configs.YolosConfig, _YOLOS_KEYS),
    "owlvit": (tiny_owl, jconfigs.OwlViTConfig, configs.OwlViTConfig, _OWL_KEYS),
    "owlv2": (lambda: tiny_owl(True), jconfigs.OwlViTConfig, configs.OwlViTConfig,
              _OWL_KEYS),
}


def delete_key(data: dict, dotted: str) -> None:
    *parents, leaf = dotted.split(".")
    for p in parents:
        data = data[p]
    del data[leaf]


def config_pair(tmp_path, factory, dotted: str | None):
    """(path) of a saved tiny config with `dotted` deleted from config.json."""
    factory().save_pretrained(tmp_path)
    path = tmp_path / "config.json"
    data = json.loads(path.read_text())
    if dotted is not None:
        delete_key(data, dotted)
    path.write_text(json.dumps(data))
    return tmp_path


def check_config_case(tmp_path, case: str, key: str, cases: dict) -> None:
    """The port's config of the file with `key` deleted equals the JAX one;
    where transformers refuses that file, the port refuses it with HF's text."""
    factory, jcls, tcls, _ = cases[case]
    path = config_pair(tmp_path, factory, key)
    try:
        want = jcls.from_hf(AutoConfig.from_pretrained(path))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tcls.from_hf(read_hf_config(path))
        assert str(got.value) == str(exc)
        return
    got = tcls.from_hf(read_hf_config(path))
    assert_same_config(got, want)


@pytest.mark.parametrize("case,key", [(c, k) for c, v in CONFIG_CASES.items() for k in v[3]])
def test_missing_config_key_takes_the_hf_default(tmp_path, case, key):
    check_config_case(tmp_path, case, key, CONFIG_CASES)


def test_config_view_reads_labels_and_nested_configs(tmp_path):
    path = config_pair(tmp_path, tiny_rtdetr, None)
    hf = read_hf_config(path)
    assert hf.id2label == {i: f"LABEL_{i}" for i in range(7)} and hf.num_labels == 7
    assert hf.backbone_config.model_type == "rt_detr_resnet"
    assert hf.backbone_config.out_indices == [2, 3, 4]
    assert getattr(hf, "no_such_key", "default") == "default"
    with pytest.raises(ValueError, match="model_type 'bert'"):
        read_hf_config(config_pair(tmp_path, lambda: AutoConfig.for_model("bert"), None))


# --- transformers' load-time key renames


def test_no_rule_key_is_renamed_at_load():
    """PreTrainedModel._fix_state_dict_key_on_load (LayerNorm gamma/beta,
    weight-norm g/v) renames no key of any family's rule table, so the port
    reads the keys as written."""
    for family in loader.FAMILIES:
        seeded = registry.MODEL_REGISTRY[family].build(
            {"owlvit": "owlv2"}.get(family, family), tiny=True)
        rules = hf_checkpoint.rule_table(family, seeded.module.config)
        renamed = [k for _, k, _ in rules.rules if PreTrainedModel._fix_state_dict_key_on_load(k)[1]]
        assert renamed == [], family


# --- the safetensors reader and writer


def sample_tensors() -> dict:
    gen = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(7, generator=gen).half(),
        "bf16": torch.randn(2, 3, 4, generator=gen).bfloat16(),
        "i64": torch.randint(-2**40, 2**40, (6,), generator=gen),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file as load_numpy
    from safetensors.torch import load_file, save_file

    tensors = sample_tensors()
    save_file(tensors, tmp_path / "a.safetensors", metadata={"format": "pt"})
    got = checkpoint_io.read_safetensors(tmp_path / "a.safetensors")
    want = load_file(tmp_path / "a.safetensors")
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    for key, value in load_numpy(tmp_path / "a.safetensors").items():
        if key != "bf16":  # numpy has no bfloat16
            np.testing.assert_array_equal(got[key].numpy(), value)


def test_safetensors_writer_is_read_by_the_library(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    tensors = sample_tensors()
    size = checkpoint_io.write_safetensors(tmp_path / "b.safetensors", tensors,
                                           {"format": "pt"})
    assert size == (tmp_path / "b.safetensors").stat().st_size
    got = load_file(tmp_path / "b.safetensors")
    for key in tensors:
        assert torch.equal(got[key], tensors[key]), key
    with safe_open(tmp_path / "b.safetensors", "pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_safetensors_reader_copies_a_misaligned_tensor_and_refuses_other_dtypes(tmp_path):
    half = np.arange(3, dtype=np.float16)
    single = np.asarray([1.25, -2.5], dtype=np.float32)
    header = {"a": {"dtype": "F16", "shape": [3], "data_offsets": [0, 6]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [6, 14]}}
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    (tmp_path / "m.safetensors").write_bytes(
        struct.pack("<Q", len(text)) + text + half.tobytes() + single.tobytes())
    got = checkpoint_io.read_safetensors(tmp_path / "m.safetensors")
    np.testing.assert_array_equal(got["a"].numpy(), half)
    np.testing.assert_array_equal(got["b"].numpy(), single)
    header = {"u": {"dtype": "U8", "shape": [8], "data_offsets": [0, 8]}}
    text = json.dumps(header).encode()
    (tmp_path / "u.safetensors").write_bytes(struct.pack("<Q", len(text)) + text + bytes(8))
    with pytest.raises(ValueError, match="dtype U8"):
        checkpoint_io.read_safetensors(tmp_path / "u.safetensors")


def test_sharded_safetensors_and_torch_bin_load(tmp_path):
    """A sharded index and pytorch_model.bin give the same params as one
    model.safetensors (the fixture writes all three)."""
    seeded = tzoo.build_rtdetr("PekingU/rtdetr_v2_r18vd", tiny=True, seed=5)
    params = {}
    for fmt, shards in (("safetensors", 1), ("safetensors", 3), ("bin", 1)):
        path = tmp_path / f"{fmt}{shards}" / "rtdetr"
        info = hf_checkpoint.write_checkpoint(seeded.module, "rtdetr", path, fmt, shards)
        assert len(info["files"]) == (shards + 2 if shards > 1 else 2)
        params[fmt, shards] = loader.load_rtdetr_from_hf(path)[1]
    assert_params_equal(params["safetensors", 3], params["safetensors", 1])
    assert_params_equal(params["bin", 1], params["safetensors", 1])


# --- refusals: strict keys, no weights, params= beside a checkpoint


def test_missing_key_raises_with_the_jax_text(tmp_path):
    path = tmp_path / "PekingU" / "rtdetr_v2_tiny"
    save(RTDetrV2ForObjectDetection, tiny_rtdetr(), path)
    tensors = dict(checkpoint_io.read_safetensors(path / "model.safetensors"))
    for dropped in ("model.enc_score_head.weight", "model.decoder.class_embed.1.bias"):
        kept = {k: v for k, v in tensors.items() if k != dropped}
        checkpoint_io.write_safetensors(path / "model.safetensors", kept)
        # a tied key missing under both names is as missing as any other
        want = dropped.replace("model.decoder.", "")
        with pytest.raises(KeyError, match=f"torch keys missing from state_dict: \\['{want}'\\]"):
            loader.load_rtdetr_from_hf(path)
        with pytest.raises(KeyError, match="torch keys missing"):
            registry.build_detector(str(path), tiny=False)


def test_directory_without_weights_raises_and_never_seeds(tmp_path):
    path = tmp_path / "PekingU" / "rtdetr_v2_r101vd"
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(
        hf_checkpoint.config_json("rtdetr", tzoo.tiny_rtdetr_config())))
    with pytest.raises(FileNotFoundError, match="holds no weights"):
        registry.build_detector(str(path), tiny=False)
    with pytest.raises(FileNotFoundError, match="holds no weights"):
        registry.build_detector(str(path), tiny=False, seed=3)


def test_params_beside_a_checkpoint_raise(tmp_path):
    seeded = tzoo.build_rtdetr("rtdetr", tiny=True)
    path = tmp_path / "rtdetr_ckpt"
    hf_checkpoint.write_checkpoint(seeded.module, "rtdetr", path)
    _, params = loader.load_rtdetr_from_hf(path)
    with pytest.raises(ValueError, match="params= cannot replace them"):
        tzoo.build_rtdetr(str(path), tiny=False, params=params)


# --- the checkpoint fixture (tools/hf_checkpoint.py)


def test_fixture_config_gives_the_r101_preset_on_both_sides(tmp_path):
    """The fixture's config.json for rtdetr_v2_r101vd: the port's from_hf
    gives RTDETR_PRESETS["rtdetr_v2_r101vd"] (with the COCO labels), and the
    JAX package's RTDetrConfig.from_hf of AutoConfig gives its own preset."""
    name = "PekingU/rtdetr_v2_r101vd"
    preset = tzoo.rtdetr_preset(name)
    (tmp_path / "config.json").write_text(json.dumps(hf_checkpoint.config_json("rtdetr", preset)))
    assert configs.RTDetrConfig.from_hf(read_hf_config(tmp_path)) == preset
    assert preset.backbone == configs.RESNET_PRESETS["r101"]
    labels = tuple(coco_id2label_80().items())
    jpreset = dataclasses.replace(jconfigs.RTDETR_PRESETS["rtdetr_v2_r101vd"], id2label=labels)
    assert jconfigs.RTDetrConfig.from_hf(AutoConfig.from_pretrained(tmp_path)) == jpreset


# (registry family, a MODEL_NAME of it, weight format, config overrides)
FIXTURE_CASES = {
    "rtdetr": ("rtdetr", "PekingU/rtdetr_v2_r18vd", "safetensors", {}),
    "yolos": ("yolos", "hustvl/yolos-small", "safetensors", {}),
    "owlvit": ("owlvit", "google/owlvit-base-patch32", "safetensors", {}),
    "owlv2": ("owlvit", "google/owlv2-base-patch16", "safetensors", {"objectness": True}),
    "deformable_detr": ("deformable_detr", "SenseTime/deformable-detr", "safetensors",
                        {"with_box_refine": False}),
    "deformable_detr_refine": ("deformable_detr", "SenseTime/deformable-detr-with-box-refine",
                               "bin", {}),
    "detr": ("detr", "facebook/detr-resnet-50", "safetensors", {}),
    "table_transformer": ("detr", "microsoft/table-transformer-detection", "safetensors",
                          {"pre_norm": True}),
    "conditional_detr": ("conditional_detr", "microsoft/conditional-detr-resnet-50",
                         "safetensors", {}),
    "dab_detr": ("dab_detr", "IDEA-Research/dab-detr-resnet-50", "safetensors", {}),
}


@pytest.mark.parametrize("case", list(FIXTURE_CASES))
def test_fixture_round_trips_every_family(tmp_path, monkeypatch, case):
    """A seeded tiny model written by the fixture builds back from its
    directory bit for bit, with its config and labels, through the registry
    (the directory's path names the family)."""
    from spotter_tpu_torch.convert.tokens import tiny_tokenize, tokenization_path

    family, name, fmt, overrides = FIXTURE_CASES[case]
    build = registry.MODEL_REGISTRY[family].build
    seeded = build(name, tiny=True, seed=7)
    if overrides:  # the variant at the tiny widths: rebuild its module
        cfg = dataclasses.replace(seeded.module.config, **overrides)
        seeded.module = type(seeded.module)(cfg).eval()
        if family == "owlvit":
            tzoo.init_owlvit(seeded.module, 7)
        else:
            {"detr": tzoo.init_detr, "deformable_detr": tzoo.init_deformable_detr}[family](
                seeded.module, 7)
    path = tmp_path / name
    hf_checkpoint.write_checkpoint(seeded.module, family, path, fmt)
    if family == "owlvit":
        monkeypatch.setenv("SPOTTER_TPU_CACHE", str(tmp_path / "cache"))
        prompts = [tzoo.PROMPT_TEMPLATE.format(q) for q in tzoo.owlvit_query_labels()]
        ids, mask = tiny_tokenize(prompts, 99, 8)
        token_file = tokenization_path(str(path))
        token_file.parent.mkdir(parents=True)
        token_file.write_text(json.dumps({p: {"ids": i.tolist(), "mask": m.tolist()}
                                          for p, i, m in zip(prompts, ids, mask)}))
    loaded = registry.build_detector(str(path), tiny=False)
    assert loaded.module.config == seeded.module.config
    if family != "owlvit":
        assert loaded.id2label == seeded.id2label
    a, b = seeded.module.state_dict(), loaded.module.state_dict()
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_chip_smoke_load_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's `load` phase on the CPU with every model at the tiny
    width (the card runs them at full width): each checkpoint written,
    built back from its directory bit for bit, the loaded RT-DETR engine's
    forward and detections equal to the seeded one's, /detect answering
    under fused and kernel, each other family's B = 1 forward equal. The
    CPU launches no kernel, so the launch checks are recorded here with
    what they would hold on the card."""
    import chip_smoke
    from spotter_tpu_torch.convert.tokens import tiny_tokenize, tokenization_path
    from spotter_tpu_torch.ops.preprocess import PreprocessSpec
    from spotter_tpu_torch.serving import app

    build = registry.build_detector

    def tiny_unless_dir(name, **kw):  # the seeded models tiny; checkpoints as written
        return build(name, **{**kw, "tiny": kw.get("tiny") or not is_checkpoint_dir(name)})

    def tiny_token_cache(seed, names=()):
        prompts = chip_smoke.owl_prompts()
        ids, mask = tiny_tokenize(prompts, 99, 8)
        for name in names:
            path = tokenization_path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({p: {"ids": i.tolist(), "mask": m.tolist()}
                                        for p, i, m in zip(prompts, ids, mask)}))
        return list(names)

    checks = []
    monkeypatch.setattr(registry, "build_detector", tiny_unless_dir)
    monkeypatch.setattr(app, "build_detector", tiny_unless_dir)
    # a checkpoint's spec is the family's served one: the tiny one here
    monkeypatch.setattr(tzoo, "RTDETR_SPEC", PreprocessSpec(mode="fixed", size=(64, 64)))
    monkeypatch.setattr(tzoo, "DETR_SPEC", tzoo.TINY_DETR_SPEC)
    monkeypatch.setattr(tzoo, "OWLVIT_SPEC", PreprocessSpec(
        mode="fixed", size=(32, 32), mean=tzoo.CLIP_MEAN, std=tzoo.CLIP_STD))
    monkeypatch.setattr(chip_smoke, "write_token_cache", tiny_token_cache)
    monkeypatch.setattr(chip_smoke, "check_counts",
                        lambda counts, expected, what: checks.append((what, expected)))
    monkeypatch.setattr(chip_smoke, "check_launches",
                        lambda counts, name, n, what: checks.append((what, {name: n})))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = chip_smoke.phase_load([], 0, device="cpu")
    rtdetr = out["rtdetr"]
    assert rtdetr["state_dict_equal"] and rtdetr["batch8_forward"]["bit_equal"]
    assert rtdetr["detections_equal"] and rtdetr["tied_keys_in_file"]["class_embed."] == 0
    assert set(rtdetr["http"]["latency_ms"]) == {"fused:1", "fused:8", "kernel:1", "kernel:8"}
    assert [f["family"] for f in out["families"]] == [f for f, _, _ in chip_smoke.LOAD_FAMILIES]
    assert all(f["bit_equal"] and f["bytes"] > 0 for f in out["families"])
    expected = dict(checks)
    assert expected["the loaded engine"] == {"msda_gather_sum": 2 * 5}  # 2 tiny decoder layers
    assert expected["yolos loaded from its checkpoint"] == {"flash_attn_fp32": 2}
    assert expected["detr loaded from its checkpoint"] == {}


def test_checkpoint_loads_into_the_fp32_masters_under_int8(tmp_path, monkeypatch):
    """A tiny RT-DETR checkpoint written from the seeded fp32 model, loaded
    under "bfloat16" with every int8 knob on: the loaded state equals the
    seeded "bfloat16" model's bit for bit (the ConvNorm and QuantDense
    masters fp32, the rest bf16), and both quantized forwards are equal."""
    from spotter_tpu_torch.utils import quant as tquant
    from tests.test_torch_int8 import set_knobs

    set_knobs(monkeypatch)  # every knob on, floors the tiny model reaches
    name = "PekingU/rtdetr_v2_r18vd"
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "float32")
    path = tmp_path / "PekingU" / "rtdetr_v2_r18vd"
    hf_checkpoint.write_checkpoint(registry.build_detector(name, tiny=True, seed=5).module,
                                   "rtdetr", path)
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "bfloat16")
    seeded = registry.build_detector(name, tiny=True, seed=5).module.eval()
    loaded = registry.build_detector(str(path), tiny=False).module.eval()
    want, got = seeded.state_dict(), loaded.state_dict()
    assert set(got) == set(want)
    for key, tensor in want.items():
        assert got[key].dtype == tensor.dtype and torch.equal(got[key], tensor), key
    assert want["backbone.stem0.conv.weight"].dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    tquant.reset_calls()
    with torch.inference_mode():
        a, b = seeded(x), loaded(x)
    assert tquant.CALLS["conv"] > 0
    for key in a:
        assert torch.equal(a[key], b[key]), key
