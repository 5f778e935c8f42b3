"""Image preprocess for the fixed-size specs of RT-DETR, YOLOS and OWL-ViT,
Deformable-DETR's shortest-edge spec, and OWLv2's pad-to-square (port of
spotter_tpu.ops.preprocess).

Fixed and shortest-edge specs take the JAX package's uint8 ingest: the host
only resizes uint8 pixels and stages them into the static bucket; the
rescale runs on the device (`device_rescale_normalize`, and for
shortest-edge specs `device_rescale_normalize_masked`, which also zeroes
the pad and builds the pixel mask from each image's valid extent). The
resize is PIL's `Image.resize(..., BILINEAR)` (or `BICUBIC` for OWL-ViT's
spec), the call the JAX package makes, so the staged pixels equal the JAX
package's bit for bit (tests/test_torch_engine.py and
tests/test_torch_deformable_detr.py pin it); torch's antialiased
interpolation differs from PIL by up to 1 LSB (bilinear) and 2 LSB
(bicubic).

OWLv2's "pad_square" spec rescales before its warp, so its host work is
inherently float (`device_preprocess_supported`): pad with 0.5 grey to a
square, scipy's gaussian_filter + zoom with skimage's resize semantics,
then normalize; the engine ships float32 pixels (`batch_images_float`).

Ragged packing (engine/scheduler.py) stages a shortest-edge batch into a
`canvas_hw` smaller than the static bucket (`_canvas_for`, which refuses a
canvas that cannot hold an image's resize with the JAX package's text);
fixed and pad_square specs fill their canvas with signal and ignore it.

Arrays are NHWC at this module's interface, as in the JAX package.
"""

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
RESAMPLE_MODES = ("bilinear", "bicubic")


@dataclass(frozen=True)
class PreprocessSpec:
    """How to turn an image into a model input array.

    mode "fixed": warp-resize to `size` (h, w) (RT-DETR's 640x640, YOLOS's
    trained image size, OWL-ViT's 768x768). mode "pad_square": pad
    bottom/right to a square with mid-grey (0.5 before normalization), then
    warp to `size` (OWLv2's 960x960); the reported target size is the
    square's (side, side), as HF's Owlv2ImageProcessor scales its boxes.
    mode "shortest_edge": aspect-preserving resize so the short side is
    size[0] without the long side passing size[1] (`shortest_edge_size`),
    staged at the top left of the static `pad_to` bucket with a pixel mask
    (the DETR family's (800, 1333) in 1333x1333, which holds both
    orientations). `mean`/`std`, when set, normalize each channel after the
    rescale. `resample` is the resize filter: "bilinear" (the RT-DETR, DETR
    and YOLOS processors) or "bicubic" (OWL-ViT's).
    """

    mode: str = "fixed"
    size: tuple[int, int] = (640, 640)
    rescale_factor: float = 1.0 / 255.0
    mean: tuple[float, float, float] | None = None
    std: tuple[float, float, float] | None = None
    resample: str = "bilinear"
    pad_to: tuple[int, int] | None = None  # the static bucket of shortest_edge mode

    @property
    def input_hw(self) -> tuple[int, int]:
        """The static (h, w) every preprocessed array has."""
        if self.mode in ("fixed", "pad_square"):
            return self.size
        if self.mode == "shortest_edge" and self.pad_to is not None:
            return self.pad_to
        raise ValueError(f"preprocess mode {self.mode!r} (pad_to={self.pad_to}) is not ported")


RTDETR_SPEC = PreprocessSpec(mode="fixed", size=(640, 640))
OWLVIT_SPEC = PreprocessSpec(
    mode="fixed", size=(768, 768), mean=CLIP_MEAN, std=CLIP_STD, resample="bicubic"
)
OWLV2_SPEC = PreprocessSpec(mode="pad_square", size=(960, 960), mean=CLIP_MEAN, std=CLIP_STD)
# the bucket covers both orientations: a portrait photo resizes to up to
# (1333, 800), a landscape one to (800, 1333)
DETR_SPEC = PreprocessSpec(
    mode="shortest_edge", size=(800, 1333), mean=IMAGENET_MEAN, std=IMAGENET_STD,
    pad_to=(1333, 1333),
)


def device_preprocess_supported(spec: PreprocessSpec) -> bool:
    """pad_square (OWLv2) rescales before its skimage-style warp, so its host
    work is inherently float; fixed and shortest-edge specs defer
    rescale/normalize to the device."""
    return spec.mode in ("fixed", "shortest_edge")


def shortest_edge_size(hw: tuple[int, int], short: int, longest: int) -> tuple[int, int]:
    """Output (h, w) of the aspect-preserving shortest-edge resize with a
    long-side cap, with the HF DETR processor's `get_size_with_aspect_ratio`
    integer arithmetic (int truncation; a capped short side re-rounded
    before the long side is derived from the unrounded cap; the
    already-at-size case checked first), and the JAX package's two clamps:
    into the bucket (the equality case can keep a side one pixel over
    `longest`) and to at least 1 pixel."""
    h, w = hw
    raw_size = None
    size = short
    mn, mx = (h, w) if h <= w else (w, h)
    if mx / mn * size > longest:
        raw_size = longest * mn / mx
        size = int(round(raw_size))
    if (h <= w and h == size) or (w <= h and w == size):
        oh, ow = h, w
    elif w < h:
        ow = size
        oh = int(raw_size * h / w) if raw_size is not None else int(size * h / w)
    else:
        oh = size
        ow = int(raw_size * w / h) if raw_size is not None else int(size * w / h)
    return max(1, min(oh, longest)), max(1, min(ow, longest))

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


def _check_rgb_uint8(image: np.ndarray) -> None:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(
            f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}"
        )


def resize_uint8(
    image: np.ndarray, size: tuple[int, int], resample: str = "bilinear"
) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8 by PIL's bilinear or bicubic
    filter, as the JAX package resizes.

    Runs on the CPU: it is the host half of preprocess, like PIL's resize
    in the JAX package. An image already at `size` is returned as a copy.
    """
    _check_rgb_uint8(image)
    if resample not in RESAMPLE_MODES:
        raise ValueError(f"resample must be one of {RESAMPLE_MODES}, got {resample!r}")
    th, tw = size
    if image.shape[:2] == (th, tw):
        return image.copy()
    from PIL import Image  # the serving layer's decoder

    pil_filter = Image.BICUBIC if resample == "bicubic" else Image.BILINEAR
    return np.array(Image.fromarray(image).resize((tw, th), resample=pil_filter))


def ragged_canvas_supported(spec: PreprocessSpec) -> bool:
    """Only shortest_edge specs (the DETR family) have a variable valid
    region inside their static bucket, which ragged packing stages into a
    smaller canvas; fixed and pad_square specs fill their canvas."""
    return spec.mode == "shortest_edge"


def _canvas_for(
    spec: PreprocessSpec,
    canvas_hw: tuple[int, int] | None,
    resized_hw: tuple[int, int],
) -> tuple[int, int]:
    """The padded canvas a shortest_edge image stages into: `canvas_hw`
    when given (it must hold the resize: a too-small canvas is a caller's
    bug and raises rather than crop), else the static bucket."""
    if canvas_hw is None:
        return spec.input_hw
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    rh, rw = resized_hw
    if rh > ch or rw > cw:
        raise ValueError(
            f"ragged canvas {ch}x{cw} cannot hold resized image {rh}x{rw}"
        )
    return ch, cw


def stage_uint8(
    image: np.ndarray, spec: PreprocessSpec, canvas_hw: tuple[int, int] | None = None
) -> tuple[np.ndarray, tuple[int, int]]:
    """One image's host half: (H, W, 3) uint8 -> (uint8 in its canvas,
    valid (h, w)). Fixed specs warp to the bucket; shortest-edge specs
    resize by `shortest_edge_size` and stage at the top left of a zeroed
    canvas: `canvas_hw` (a ragged pack's) or the static bucket."""
    if spec.mode == "fixed":
        return resize_uint8(image, spec.size, spec.resample), spec.size
    rh, rw = shortest_edge_size(image.shape[:2], spec.size[0], spec.size[1])
    out = np.zeros((*_canvas_for(spec, canvas_hw, (rh, rw)), 3), dtype=np.uint8)
    out[:rh, :rw] = resize_uint8(image, (rh, rw), spec.resample)
    return out, (rh, rw)


DECODE_WORKERS_ENV = "SPOTTER_TPU_DECODE_WORKERS"


class DecodePool:
    """Thread pool for the host's per-photo work: the uint8 resize and
    staging, and OWLv2's float pad-to-square warp. PIL's resize and scipy's
    filters release the GIL, so threads scale with the cores. Workers:
    `workers`, else SPOTTER_TPU_DECODE_WORKERS, else the JAX package's
    heuristic, min(8, max(2, cores - 1)); one worker runs serially.
    `queue_depth()` (submitted but unfinished photos) feeds the
    `decode_pool_queue_depth` gauge, which shows when the host, not the
    device, binds."""

    def __init__(self, workers: int | None = None) -> None:
        if workers is None:
            raw = os.environ.get(DECODE_WORKERS_ENV, "").strip()
            workers = int(raw) if raw else min(8, max(2, (os.cpu_count() or 2) - 1))
        self.workers = max(1, workers)
        self._pool = (
            ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="spotter-decode")
            if self.workers > 1 else None
        )
        self._pending = 0
        self._lock = threading.Lock()

    def queue_depth(self) -> int:
        with self._lock:
            return self._pending

    def map(self, fn, items: list) -> list:
        """Ordered map over the pool (serial for 1 worker or 1 item)."""
        if self._pool is None or len(items) <= 1:
            return [fn(item) for item in items]
        with self._lock:
            self._pending += len(items)

        def run(item):
            try:
                return fn(item)
            finally:
                with self._lock:
                    self._pending -= 1

        return list(self._pool.map(run, items))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)


def batch_images_uint8(
    images: list[np.ndarray], spec: PreprocessSpec, pool: DecodePool | None = None,
    out: np.ndarray | None = None, canvas_hw: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resize and stack -> (pixels (B,H,W,3) u8, valid (B,2) i32, sizes (B,2) f32 [orig h,w]),
    the photos staged on `pool`'s threads (None: one after another). `out`,
    when given, receives the pixels (the engine's pinned buffer).
    `canvas_hw` is a ragged pack's canvas (shortest-edge specs; fixed specs
    ignore it)."""
    if not device_preprocess_supported(spec):
        raise ValueError(f"preprocess mode {spec.mode!r} has no uint8 path")
    stage = functools.partial(stage_uint8, spec=spec, canvas_hw=canvas_hw)
    staged = pool.map(stage, images) if pool is not None else [stage(img) for img in images]
    pixels = np.stack([px for px, _ in staged], out=out)
    valid = np.asarray([hw for _, hw in staged], dtype=np.int32).reshape(len(images), 2)
    sizes = np.asarray([img.shape[:2] for img in images], dtype=np.float32)
    return pixels, valid, sizes


def pad_square_float(image: np.ndarray, spec: PreprocessSpec) -> tuple[np.ndarray, tuple[int, int]]:
    """OWLv2's host preprocess, (H, W, 3) uint8 -> ((h, w, 3) float32
    normalized, (side, side)), as the JAX package computes it: rescale to
    [0, 1], pad bottom/right to a square with 0.5 grey, resize the padded
    square to `spec.size` with skimage.transform.resize's semantics as HF's
    Owlv2ImageProcessor vendors them (anti-aliasing gaussian of sigma
    (factor - 1) / 2, then an order-1 zoom, both "mirror" at the edges,
    clipped to the padded square's range), then normalize."""
    import scipy.ndimage as ndi  # the HF processor itself requires scipy

    _check_rgb_uint8(image)
    th, tw = spec.size
    h, w = image.shape[:2]
    side = max(h, w)
    padded = np.full((side, side, 3), 0.5, dtype=np.float32)
    padded[:h, :w] = image.astype(np.float32) * spec.rescale_factor
    factors = np.divide(padded.shape, (th, tw, 3))
    sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
    filtered = ndi.gaussian_filter(padded, sigma, mode="mirror") if sigma.any() else padded
    out = ndi.zoom(filtered, 1.0 / factors, order=1, mode="mirror", grid_mode=True)
    arr = np.clip(out, padded.min(), padded.max()).astype(np.float32)
    if spec.mean is not None and spec.std is not None:
        arr = (arr - np.asarray(spec.mean, dtype=np.float32)) / np.asarray(
            spec.std, dtype=np.float32
        )
    return arr, (side, side)


def batch_images_float(
    images: list[np.ndarray], spec: PreprocessSpec, pool: DecodePool | None = None,
    canvas_hw: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The host float path (pad_square) -> (pixels (B,H,W,3) f32 normalized,
    sizes (B,2) f32 [h, w] the boxes are scaled to), the photos warped on
    `pool`'s threads (None: one after another). `canvas_hw` is ignored: a
    pad_square canvas is all signal, as in the JAX package."""
    if spec.mode != "pad_square":
        raise ValueError(f"preprocess mode {spec.mode!r} takes the uint8 path")
    warp = functools.partial(pad_square_float, spec=spec)
    done = pool.map(warp, images) if pool is not None else [warp(img) for img in images]
    return (
        np.stack([arr for arr, _ in done]),
        np.asarray([hw for _, hw in done], dtype=np.float32),
    )


@functools.cache
def _channel_table(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """`values` as an fp32 tensor on `device`, made once: a fresh host copy on
    every forward would make the host wait for the stream. Made outside
    inference mode, so it also serves forwards that track gradients.
    Never evicted: a captured CUDA graph reads it in place."""
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


def device_rescale_normalize_masked(
    pixels_u8: torch.Tensor, valid_hw: torch.Tensor, spec: PreprocessSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC and per-image valid (h, w) (B, 2) on the device ->
    (float32 NHWC pixels, float32 (B, H, W) pixel mask): rescale, normalize,
    then zero the pad region, as the JAX package's device half does (the
    DETR processor pads after normalizing, so pad pixels are 0, not
    (0 - mean) / std)."""
    x = device_rescale_normalize(pixels_u8, spec)
    _, h, w = pixels_u8.shape[:3]
    rows = torch.arange(h, device=x.device)[None, :] < valid_hw[:, :1]  # (B, H)
    cols = torch.arange(w, device=x.device)[None, :] < valid_hw[:, 1:]  # (B, W)
    mask = (rows[:, :, None] & cols[:, None, :]).to(torch.float32)
    return x * mask[..., None], mask
