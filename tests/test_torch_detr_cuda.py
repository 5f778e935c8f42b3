"""The DETR lineage on the card: DETR-R50, Table-Transformer, Conditional-DETR
and DAB-DETR at their published widths, B = 1, a photo staged into a
1088x1088 bucket with its pixel mask (34x34 = 1156 encoder tokens, past the
attention kernel's 1024-token cutover). The outputs must be finite and no
hand-written kernel may launch: the encoder's self-attention is masked, so
it stays on the materialised path, as the JAX package's does.

This file imports torch and the port only, so it runs on a machine with a
card and no JAX:

    python -m pytest -m cuda tests/test_torch_detr_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from spotter_tpu_torch.models import registry
from spotter_tpu_torch.ops import attention, msda, openvocab
from spotter_tpu_torch.ops.preprocess import batch_images_uint8, device_rescale_normalize_masked

MODELS = ("facebook/detr-resnet-50", "microsoft/table-transformer-detection",
          "microsoft/conditional-detr-resnet-50", "IDEA-Research/dab-detr-resnet-50")
BUCKET = (1088, 1088)
WRAPPERS = (msda.msda_gather_sum, msda.msda_loc_sum, msda.msda_fused_sum, msda.msda_sep_sum,
            msda.msda_hd_gather_sum, attention.flash_attn_fp32, attention.split_kv_tf32,
            attention.flash_attn_bf16, openvocab.owl_class_logits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
def test_preset_runs_on_the_card_and_launches_no_kernel(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    built = registry.build_detector(name, tiny=False, seed=0)
    spec = dataclasses.replace(built.preprocess_spec, size=(653, 1088), pad_to=BUCKET)
    photo = np.random.default_rng(0).integers(0, 256, (480, 800, 3), dtype=np.uint8)
    pixels, valid, _ = batch_images_uint8([photo], spec)
    x, mask = device_rescale_normalize_masked(
        torch.from_numpy(pixels).cuda(), torch.from_numpy(valid).cuda(), spec)
    assert mask.shape == (1, *BUCKET) and 0 < mask.mean().item() < 1
    model = built.module.cuda().eval()
    before = [fn.launches for fn in WRAPPERS]
    with torch.inference_mode():
        out = model(x, mask)
    torch.cuda.synchronize()
    assert [fn.launches for fn in WRAPPERS] == before
    for key, value in out.items():
        assert torch.isfinite(value).all(), key
        assert value.device.type == "cuda", key
    assert out["pred_boxes"].shape == (1, model.config.num_queries, 4)
