"""Image preprocess for the fixed-size RT-DETR spec (port of
spotter_tpu.ops.preprocess, uint8 path).

The split is the JAX package's uint8 ingest: the host only resizes uint8
pixels into the static bucket and stacks them; the rescale runs on the
device (`device_rescale_normalize`).

The host resize replaces PIL's `Image.resize(..., BILINEAR)` with
`torch.nn.functional.interpolate(mode="bilinear", antialias=True)` on a
CPU uint8 tensor, so the port needs no PIL. The two agree to within 1 LSB
on downscales and upscales to 640x640 (tests/test_torch_engine.py pins it
against the JAX package's PIL path).

Arrays are NHWC at this module's interface, as in the JAX package.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class PreprocessSpec:
    """How to turn an image into a model input array.

    Only mode "fixed" (warp-resize to `size` (h, w), RT-DETR's 640x640) is
    ported; the shortest-edge and pad-square modes and mean/std
    normalization come with their model families.
    """

    mode: str = "fixed"
    size: tuple[int, int] = (640, 640)
    rescale_factor: float = 1.0 / 255.0

    @property
    def input_hw(self) -> tuple[int, int]:
        """The static (h, w) every preprocessed array has."""
        if self.mode != "fixed":
            raise ValueError(f"preprocess mode {self.mode!r} is not ported")
        return self.size


RTDETR_SPEC = PreprocessSpec(mode="fixed", size=(640, 640))


def resize_uint8(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, bilinear with antialiasing.

    Runs on the CPU: it is the host half of preprocess, like PIL's resize
    in the JAX package. An image already at `size` is returned as a copy.
    """
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(
            f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}"
        )
    th, tw = size
    if image.shape[:2] == (th, tw):
        return image.copy()
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(th, tw), mode="bilinear", antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def batch_images_uint8(
    images: list[np.ndarray], spec: PreprocessSpec
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resize and stack -> (pixels (B,H,W,3) u8, valid (B,2) i32, sizes (B,2) f32 [orig h,w])."""
    hw = spec.input_hw
    pixels = np.stack([resize_uint8(img, hw) for img in images])
    valid = np.tile(np.asarray([hw], np.int32), (len(images), 1))
    sizes = np.asarray([img.shape[:2] for img in images], dtype=np.float32)
    return pixels, valid, sizes


def device_rescale_normalize(
    pixels_u8: torch.Tensor, spec: PreprocessSpec
) -> torch.Tensor:
    """uint8 NHWC on the device -> float32 NHWC, rescaled. RT-DETR's spec
    has no mean/std normalization, and fixed-mode images fill their canvas,
    so no pad mask is needed."""
    return pixels_u8.to(torch.float32) * spec.rescale_factor
