"""Image preprocess for the fixed-size specs of RT-DETR and YOLOS (port of
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

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class PreprocessSpec:
    """How to turn an image into a model input array.

    Only mode "fixed" (warp-resize to `size` (h, w): RT-DETR's 640x640,
    YOLOS's trained image size) is ported; the shortest-edge and pad-square
    modes come with their model families. `mean`/`std`, when set, normalize
    each channel after the rescale (YOLOS: ImageNet's).
    """

    mode: str = "fixed"
    size: tuple[int, int] = (640, 640)
    rescale_factor: float = 1.0 / 255.0
    mean: tuple[float, float, float] | None = None
    std: tuple[float, float, float] | None = None

    @property
    def input_hw(self) -> tuple[int, int]:
        """The static (h, w) every preprocessed array has."""
        if self.mode != "fixed":
            raise ValueError(f"preprocess mode {self.mode!r} is not ported")
        return self.size


RTDETR_SPEC = PreprocessSpec(mode="fixed", size=(640, 640))

MAX_IMAGE_PIXELS_ENV = "SPOTTER_TPU_MAX_IMAGE_PIXELS"
DEFAULT_MAX_IMAGE_PIXELS = 64_000_000  # ~64 MP; <= 0 disables the guard


class ImageTooLargeError(ValueError):
    """An image whose header declares more pixels than
    SPOTTER_TPU_MAX_IMAGE_PIXELS. A per-image error, never a host OOM."""


def check_image_pixels(image) -> None:
    """Reject decode bombs before any full decode touches them.

    `image` is anything with `width` and `height` (a PIL image opened but
    not yet decoded: PIL reads the dimensions from the header).
    """
    raw = os.environ.get(MAX_IMAGE_PIXELS_ENV, "").strip()
    try:
        cap = int(raw) if raw else DEFAULT_MAX_IMAGE_PIXELS
    except ValueError:
        raise ValueError(f"{MAX_IMAGE_PIXELS_ENV} must be an integer, got {raw!r}") from None
    if cap <= 0:
        return
    n = image.width * image.height
    if n > cap:
        raise ImageTooLargeError(
            f"image {image.width}x{image.height} = {n} px exceeds "
            f"{MAX_IMAGE_PIXELS_ENV}={cap} (decode-bomb guard)"
        )


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


@functools.lru_cache(maxsize=16)
def _channel_table(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """`values` as an fp32 tensor on `device`, made once: a fresh host copy on
    every forward would make the host wait for the stream. Made outside
    inference mode, so it also serves forwards that track gradients."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def device_rescale_normalize(
    pixels_u8: torch.Tensor, spec: PreprocessSpec
) -> torch.Tensor:
    """uint8 NHWC on the device -> float32 NHWC: rescaled, then normalized
    by the spec's mean/std when it has them. Fixed-mode images fill their
    canvas, so no pad mask is needed."""
    x = pixels_u8.to(torch.float32) * spec.rescale_factor
    if spec.mean is not None and spec.std is not None:
        x = (x - _channel_table(spec.mean, x.device)) / _channel_table(spec.std, x.device)
    return x
