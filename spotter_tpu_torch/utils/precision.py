"""Compute-precision policy names (port of spotter_tpu.utils.precision).

The same three policies and the same env knob as the JAX package:

- "float32" (serving default): exact fp32 end to end. On the card this
  needs more than fp32 tensors: PyTorch runs fp32 convolutions through
  cuDNN in TF32 (about three decimal digits) unless told otherwise, so the
  policy turns TF32 off for both matmuls and convolutions.
- "mixed": bf16 backbone, fp32 detection transformer.
- "bfloat16": bf16 activations everywhere.

Each family's build function (models/zoo.py) applies the policy as the JAX
package's does. YOLOS takes all three: its ViT body runs at
`backbone_dtype()`, so bf16 under "mixed" and "bfloat16", with fp32 heads.
RT-DETR runs only "float32" so far and its build function refuses the other two
names (`require_float32`) rather than serve them as fp32. The int8 knobs
(SPOTTER_TPU_INT8, _INT8_DENSE, _INT8_ATTN) change what the JAX package
computes and are not ported: building any model with one of them set
raises (`refuse_int8`).
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


def require_float32(family: str) -> None:
    """Raise unless the policy is "float32": `family` runs no other yet."""
    if compute_dtype() != torch.float32 or backbone_dtype() != torch.float32:
        raise ValueError(
            f"{DTYPE_ENV}={os.environ.get(DTYPE_ENV)!r}: the port runs the {family} family "
            f"only under the float32 policy; its mixed and bfloat16 policies are "
            f"ROADMAP Queue 1 item 9"
        )


INT8_KNOBS = ("SPOTTER_TPU_INT8", "SPOTTER_TPU_INT8_DENSE", "SPOTTER_TPU_INT8_ATTN")


def refuse_int8() -> None:
    """Raise when an int8 knob is set (any value but "0", as the JAX package
    reads them): int8 quantization is not ported, and serving the float
    model under it would silently compute something else."""
    for knob in INT8_KNOBS:
        raw = os.environ.get(knob, "0")
        if raw.strip() != "0":
            raise ValueError(
                f"{knob}={raw!r}: int8 quantization is not ported "
                f"(ROADMAP Queue 1 item 9); unset it to serve the float model"
            )


def use_exact_float32() -> None:
    """Make "float32" mean exact fp32 on the card.

    torch.backends.cuda.matmul.allow_tf32 is already False by default, but
    torch.backends.cudnn.allow_tf32 is True, which would round every fp32
    convolution's inputs to TF32. Both are process-wide switches; set both.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
