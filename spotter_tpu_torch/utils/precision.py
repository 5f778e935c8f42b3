"""Compute-precision policy names (port of spotter_tpu.utils.precision).

The same three policies and the same env knob as the JAX package:

- "float32" (serving default): exact fp32 end to end. On the card this
  needs more than fp32 tensors: PyTorch runs fp32 convolutions through
  cuDNN in TF32 (about three decimal digits) unless told otherwise, so the
  policy turns TF32 off for both matmuls and convolutions.
- "mixed": bf16 backbone, fp32 detection transformer.
- "bfloat16": bf16 activations everywhere.

Each family's build function (models/zoo.py) applies the policy as the JAX
package's does: the CNN backbone (or YOLOS's ViT body, OWL's vision tower)
at `backbone_dtype()`, the rest at `compute_dtype()`, with box refinement
and the outputs in fp32 under every policy. Under "mixed" and "bfloat16"
the MSDA sampling follows the policy too (SPOTTER_TPU_MSDA_PRECISION,
ops/msda.py), and under "bfloat16" RT-DETR fuses its RepVGG blocks
(SPOTTER_TPU_REP_FUSE, models/rtdetr.py). The fp32 half of every policy is
exact fp32 on the card (`use_exact_float32`), which the engine sets on
every card whatever the policy. The int8 knobs (SPOTTER_TPU_INT8,
_INT8_DENSE, _INT8_ATTN) combine with any policy: utils/quant.py.
"""

import os

import torch

DTYPE_ENV = "SPOTTER_TPU_DTYPE"

# name -> (compute dtype, backbone dtype)
_NAMED = {
    "bfloat16": (torch.bfloat16, torch.bfloat16),
    "bf16": (torch.bfloat16, torch.bfloat16),
    "float32": (torch.float32, torch.float32),
    "fp32": (torch.float32, torch.float32),
    "f32": (torch.float32, torch.float32),
    "mixed": (torch.float32, torch.bfloat16),
}


def _policy(override: str | None) -> tuple[torch.dtype, torch.dtype]:
    name = override or os.environ.get(DTYPE_ENV, "")
    if name:
        key = name.strip().lower()
        if key not in _NAMED:
            raise ValueError(
                f"Unsupported {DTYPE_ENV}={name!r}; expected one of {sorted(_NAMED)}"
            )
        return _NAMED[key]
    return (torch.float32, torch.float32)


def compute_dtype(override: str | None = None) -> torch.dtype:
    """Activation dtype of the transformer/decoder half.

    Priority: explicit `override` > SPOTTER_TPU_DTYPE env > float32.
    """
    return _policy(override)[0]


def backbone_dtype(override: str | None = None) -> torch.dtype:
    """CNN-backbone dtype: differs from compute_dtype only under "mixed"."""
    return _policy(override)[1]


def policy_name() -> str:
    """The SPOTTER_TPU_DTYPE value as the JAX package's policy defaults read
    it (stripped, lower case; "" when unset)."""
    return os.environ.get(DTYPE_ENV, "").strip().lower()


def use_exact_float32() -> None:
    """Make "float32" mean exact fp32 on the card, and bf16 products sum in
    fp32 as the TPU's matrix unit sums them.

    torch.backends.cuda.matmul.allow_tf32 is already False by default, but
    torch.backends.cudnn.allow_tf32 is True, which would round every fp32
    convolution's inputs to TF32. And cuBLAS may sum a bf16 matmul's partial
    products in bf16 (allow_bf16_reduced_precision_reduction, True by
    default), which no policy of the JAX package does. All are process-wide
    switches; set all three.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
