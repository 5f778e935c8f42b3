"""Compute-precision policy names (port of spotter_tpu.utils.precision).

The same three policies and the same env knob as the JAX package:

- "float32" (serving default): exact fp32 end to end. On the card this
  needs more than fp32 tensors: PyTorch runs fp32 convolutions through
  cuDNN in TF32 (about three decimal digits) unless told otherwise, so the
  policy turns TF32 off for both matmuls and convolutions.
- "mixed": bf16 backbone, fp32 detection transformer.
- "bfloat16": bf16 activations everywhere.

Only "float32" is ported so far: the models run fp32, and the
engine refuses the other two names rather than serve them as fp32.
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


def use_exact_float32() -> None:
    """Make "float32" mean exact fp32 on the card.

    torch.backends.cuda.matmul.allow_tf32 is already False by default, but
    torch.backends.cudnn.allow_tf32 is True, which would round every fp32
    convolution's inputs to TF32. Both are process-wide switches; set both.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
