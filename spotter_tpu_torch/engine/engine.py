"""Inference engine: batch-bucket ladder, padded batching, device forward
(port of spotter_tpu.engine.engine, lean form).

What it keeps of the JAX engine: batch sizes come from a fixed ladder
(1, 2, 4, 8 by default) and each chunk pads up to its bucket, `warmup`
runs every bucket once ahead of traffic, the device returns fixed-k
(scores, labels, boxes) and the host thresholds them. It takes decoded
uint8 HWC images (numpy); the host resizes them to the spec and stacks
them, the device rescales, runs the model and the family's postprocess
(sigmoid top-k for RT-DETR and Deformable-DETR, per-query softmax for
YOLOS, per-patch sigmoid max for OWL-ViT). A model that takes a pixel mask
(`needs_mask`: Deformable-DETR's shortest-edge spec stages each photo at the
top left of a 1333x1333 bucket) gets it from each image's valid extent,
built on the device with the rescale; padded batch rows are zero pixels
with a mask of ones, as in the JAX engine; boxes are scaled to each
photo's own size.

Open-vocabulary families (OWL-ViT, OWLv2) bring a build-time query bank,
which the engine keeps on its device and passes to every forward, and a
text encoder: `detect(..., qset=)` runs the model against a request's own
resolved query set instead (caching/text_cache.py), keeping each set's
device copy per key, and labels its detections from that set. OWLv2's
pad-to-square spec preprocesses in float on the host, so its pixels cross
to the device as float32; the fixed specs ship uint8.

It takes what the batcher hands over (PIL images) or decoded uint8 HWC
arrays. `detect` runs the JAX engine's pipeline at depth 2: `_stage_host`
(the photos resized on the `DecodePool`, straight into pinned host
buffers) -> `_put_staged` (a non-blocking upload on the engine's stream)
-> `_dispatch` (the forward, then the D2H of the fixed-k outputs into
pinned buffers and a CUDA event) -> `_finish` (the wait on that event,
outside the H2D lock, then the thresholding). On the card each bucket's
forward is a replay of a captured CUDA graph (`engine/graphs.py`), keyed
by the JAX engine's shape key and every knob the forward reads; `warmup`
captures one per bucket after an eager run, and the CPU stays eager.
Failures are classified as the JAX engine classifies them
(`engine/errors.py`): an out-of-memory chunk is split in half and retried
once, serially (the next smaller bucket); a fatal device error, a poisoned
CUDA context included, raises `FatalEngineError`; anything else propagates
for the batcher's poison bisect.

The engine also keeps the JAX engine's identity and integrity seams:
`weights_digest()`, `attest()` (an integer checksum of every parameter and
buffer on the device against a trusted host copy taken at build) and
`corrupt_weights(n)`; and it feeds `metrics.perf` (the capture ledger,
FLOPs per shape key, device windows, memory gauges).

Not ported yet: sharding and the degraded-dp rebuild (ROADMAP Queue 1
item 10).
"""

import hashlib
import re
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from spotter_tpu_torch.engine import graphs
from spotter_tpu_torch.engine.errors import (
    FatalEngineError,
    TransientEngineError,
    as_typed,
    classify_engine_exception,
)
from spotter_tpu_torch.engine.metrics import Metrics
from spotter_tpu_torch.obs import perf as perf_mod
from spotter_tpu_torch.obs.perf import sample_hbm_once
from spotter_tpu_torch.ops.postprocess import (
    sigmoid_max_postprocess,
    sigmoid_topk_postprocess,
    softmax_postprocess,
    to_detections,
)
from spotter_tpu_torch.ops.preprocess import (
    DecodePool,
    PreprocessSpec,
    batch_images_float,
    batch_images_uint8,
    device_preprocess_supported,
    device_rescale_normalize,
    device_rescale_normalize_masked,
)
from spotter_tpu_torch.utils.precision import use_exact_float32

POSTPROCESS_KINDS = ("sigmoid_topk", "softmax", "sigmoid_max")  # RT-DETR; DETR/YOLOS; OWL-ViT
# ragged canvas packing (the JAX scheduler's smaller canvases for
# shortest-edge specs) is not ported
RAGGED_SHORTEST_EDGE_ERROR = (
    "ragged canvas packing for shortest_edge specs (SPOTTER_TPU_RAGGED=1 with the "
    "DETR family) is not ported: ROADMAP Queue 1 item 6"
)
# query sets whose device copies the engine keeps, least recently used
# dropped first (the text cache's default bound)
QSET_DEVICE_ENTRIES = 256


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device` as given, or `cuda` when None.

    With None and no GPU present this raises: the engine never carries on
    quietly on the CPU. The CPU runs only when the caller names it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@dataclass
class BuiltDetector:
    """Everything the engine needs for one loaded model (registry output)."""

    model_name: str
    module: nn.Module  # weights loaded; (B, H, W, 3) float pixels -> dict
    preprocess_spec: PreprocessSpec
    postprocess: str  # one of POSTPROCESS_KINDS
    id2label: dict[int, str]
    num_top_queries: int = 300
    # open-vocabulary families: the deployment vocabulary's normalized
    # (Q, proj) fp32 query bank, encoded once at build time, and the text
    # encoder for a request's own queries (list[str] -> (Q, proj) float32
    # numpy). Both None for closed-set families, which then refuse `qset`.
    query_embeds: Optional[torch.Tensor] = None
    text_encoder: Optional[Callable] = None
    # the module takes (pixels, pixel_mask): the shortest-edge families
    needs_mask: bool = False


def _bitpattern_words(x: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits as int64 words in [0, 2^32), the JAX package's
    `_bitpattern_u32`: 4-byte floats as their bits, 2-byte dtypes widened
    from their 16 bits, integer and bool dtypes cast with wraparound."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    elif x.element_size() == 2:
        x = x.view(torch.int16).to(torch.int64) & 0xFFFF
    return x.to(torch.int64) & 0xFFFFFFFF


def _attest_sum(x: torch.Tensor) -> int:
    """On-device checksum: the sum of the bit-pattern words mod 2^32, where
    `x` lives; only the scalar comes back. Integer addition is
    order-independent, so the result is exact under any reduction order (a
    float reduction's would not be), and a flipped bit changes it."""
    return int(_bitpattern_words(x.detach().contiguous()).sum() & 0xFFFFFFFF)


def _host_checksum(a: np.ndarray) -> int:
    """Host mirror of `_attest_sum` over the trusted copy (numpy, no device
    involved): the JAX package's `_host_checksum`, same words, same sum."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float32:
        u = a.view(np.uint32)
    elif a.dtype.itemsize == 2:
        u = a.view(np.uint16)
    else:
        u = a
    return int(u.astype(np.uint64).sum() % (2**32))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 (which numpy lacks) as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class InferenceEngine:
    """Owns the model on its device; turns uint8 images into detections."""

    def __init__(
        self,
        built: BuiltDetector,
        threshold: float = 0.5,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        device: str | torch.device | None = None,
        metrics: Optional[Metrics] = None,
        decode_pool: Optional[DecodePool] = None,
    ) -> None:
        """`device`: where the model runs; None means `cuda`, and raises
        where there is no GPU (pass "cpu" to run on the CPU). `decode_pool`
        runs the host's per-photo work (SPOTTER_TPU_DECODE_WORKERS); shared
        across engines when passed in, else the engine owns one."""
        if built.postprocess not in POSTPROCESS_KINDS:
            raise ValueError(f"postprocess {built.postprocess!r} is not ported")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        self.built = built
        self.threshold = threshold
        self.batch_buckets = tuple(sorted(batch_buckets))
        # the trusted host copy attestation compares the device against,
        # taken before the move (on the CPU the model's own tensors are the
        # device's, so this is always a copy)
        self._host_state = {
            name: t.detach().to("cpu", copy=True) for name, t in _named_tensors(built.module)
        }
        self.model = built.module.to(self.device).eval()
        # fixed specs ship uint8 and normalize on the device; pad_square is float on the host
        self.device_preprocess = device_preprocess_supported(built.preprocess_spec)
        self._query_embeds = (
            None if built.query_embeds is None else built.query_embeds.to(self.device)
        )
        self._qset_tensors: OrderedDict[str, tuple[torch.Tensor, torch.Tensor]] = OrderedDict()
        self.metrics = metrics or Metrics()
        self.decode_pool = decode_pool or DecodePool()
        # stage-put + dispatch are serialised by this lock, so concurrent
        # detect calls (the batcher's worker threads) never interleave their
        # uploads and replays; `_finish` (the wait on the D2H) runs outside
        # it, and so does the host staging
        self._h2d_lock = threading.Lock()
        # capture provenance: warmup / traffic / oom_downgrade
        self._compile_src = threading.local()
        self._cuda = self.device.type == "cuda"
        # per-key graphs, and the stream and memory pool every upload,
        # replay and D2H goes through (the card only)
        self.graphs: dict[tuple, graphs.ForwardGraph] = {}
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self.metrics.perf.set_device_info(
            torch.cuda.get_device_name(self.device) if self._cuda else "cpu", 1)
        sample_hbm_once(self.devices, self.metrics.perf)

    def devices(self) -> list[torch.device]:
        """The devices this engine places work on."""
        return [self.device]

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    # -- identity and attestation -------------------------------------------

    def weights_digest(self) -> str:
        """Structural fingerprint of the loaded weights: a digest over the
        model name and every state-dict entry's name, shape and dtype. Cheap
        (no device reads) and stable across processes; it catches a
        different checkpoint architecture or layout behind the same build
        tag. The port's own identity string (the JAX package's digests flax
        paths, so the two differ). SPOTTER_TPU_WEIGHTS_DIGEST overrides it
        in the replica's identity block."""
        h = hashlib.sha256()
        h.update(str(self.built.model_name).encode())
        for name, t in self.model.state_dict().items():
            h.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
        return h.hexdigest()[:12]

    def attest(self) -> dict:
        """On-device weights attestation: `_attest_sum` over every parameter
        and buffer where it lives, against `_host_checksum` of the trusted
        host copy taken at build. Bit exact by construction (an integer sum
        of the raw bits mod 2^32). Returns {"ok", "checked", "mismatched",
        "observed", "expected"} with per-device sums keyed `device:<index>`.

        It covers the module's parameters and buffers (the fp32 masters). The
        values derived from them and kept for speed (`models/layers.py`
        `kept`: the bf16 casts, folded BN pairs, int8 codes) are not
        covered: after `corrupt_weights` they still hold the uncorrupted
        values until their sources' versions change."""
        key = f"device:{self.device.index or 0}"
        observed = expected = 0
        for name, t in _named_tensors(self.model):
            observed = (observed + _attest_sum(t)) % 2**32
            expected = (expected + _host_checksum(_host_array(self._host_state[name]))) % 2**32
        mismatched = [] if observed == expected else [key]
        return {
            "ok": not mismatched,
            "checked": 1,
            "mismatched": mismatched,
            "observed": {key: observed},
            "expected": {key: expected},
        }

    @torch.no_grad()
    def corrupt_weights(self, n: int) -> None:
        """Fault seam: add one to the first element of each of the first `n`
        device parameters, in place. The host copy stays pristine: it is
        attestation's trusted reference."""
        params = [p for _, p in self.model.named_parameters()][: max(int(n), 0)]
        for p in params:
            p.view(-1)[:1] += 1

    @torch.no_grad()
    def reload_weights(self) -> None:
        """Copy the trusted host copy back into every device parameter and
        buffer, in place (the storage the captured graphs read stays the
        same)."""
        for name, t in _named_tensors(self.model):
            t.copy_(self._host_state[name])

    # -- capture provenance and keys ----------------------------------------

    @contextmanager
    def _compile_source(self, source: str):
        """Tag captures recorded while the context is active (thread-local:
        concurrent worker threads never see each other's provenance)."""
        prev = getattr(self._compile_src, "value", None)
        self._compile_src.value = source
        try:
            yield
        finally:
            self._compile_src.value = prev

    def _current_source(self) -> str:
        return getattr(self._compile_src, "value", None) or "traffic"

    def _shape_key(self, batch: int, h: int, w: int, qset=None) -> str:
        """The JAX engine's shape key: pixel dtype, batch, H, W and, for an
        open-vocabulary query set, its padded query count."""
        base = f"{'u8' if self.device_preprocess else 'f32'}:{batch}x{h}x{w}"
        if qset is not None:
            base += f":q{qset.embeds.shape[0]}"
        return base

    # -- the forward ------------------------------------------------------------

    def _forward(
        self,
        pixels: torch.Tensor,
        target_sizes: torch.Tensor,
        queries: Optional[tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
        valid: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The eager device half: (B, H, W, 3) pixels (uint8, or the float
        path's normalized float32) + (B, 2) sizes -> fixed-k outputs. An
        open-vocabulary model runs against `queries` (embeddings, mask),
        by default the build-time bank with no mask. A model that needs a
        pixel mask gets it from `valid` (B, 2), each image's (h, w) in the
        bucket (None: the whole bucket)."""
        spec = self.built.preprocess_spec
        if self.built.needs_mask:
            if valid is None:
                valid = torch.tensor([spec.input_hw], dtype=torch.int32,
                                     device=pixels.device).expand(pixels.shape[0], 2)
            pixels, mask = device_rescale_normalize_masked(pixels, valid, spec)
            out = self.model(pixels, mask)
        else:
            if pixels.dtype == torch.uint8:
                pixels = device_rescale_normalize(pixels, spec)
            if queries is None and self._query_embeds is not None:
                queries = (self._query_embeds, None)
            out = self.model(pixels) if queries is None else self.model(pixels, *queries)
        logits = out["logits"]
        if self.built.postprocess == "softmax":
            return softmax_postprocess(logits, out["pred_boxes"], target_sizes)
        if self.built.postprocess == "sigmoid_max":
            return sigmoid_max_postprocess(logits, out["pred_boxes"], target_sizes)
        kk = min(self.built.num_top_queries, logits.shape[1] * logits.shape[2])
        return sigmoid_topk_postprocess(logits, out["pred_boxes"], target_sizes, k=kk)

    def _forward_flat(self, pixels, sizes, valid=None, q_embeds=None, q_mask=None):
        """`_forward` on a flat argument list (what a graph captures)."""
        args = (pixels, sizes) if q_embeds is None else (pixels, sizes, (q_embeds, q_mask))
        return self._forward(*args, **({} if valid is None else {"valid": valid}))

    def _count_flops(self, shape: str, inputs: tuple) -> None:
        """Cache `shape`'s FLOPs in the perf ledger. A forward's FLOPs are
        linear in its batch, so they are counted once per image shape: one
        B = 1 forward under `FlopCounterMode`, with the kernels' noted FLOPs
        collected (the counter cannot see a ctypes launch), times the batch.
        The counting forward's outputs are dropped (under the counter some
        ops take another path and round differently), and its launches are
        not counted: it serves no chunk."""
        perf = self.metrics.perf
        one = re.sub(r":\d+x", ":1x", shape, count=1)

        def count():
            pixels, sizes, valid, q_embeds, q_mask = inputs
            queries = None if q_embeds is None else (q_embeds, q_mask)
            with graphs.uncounted(), perf_mod.collect_kernel_flops() as noted, \
                    FlopCounterMode(display=False) as counter:
                # the class's own forward: a stand-in for `_forward` (a
                # fault injected into it) sees served chunks only
                InferenceEngine._forward(self, pixels[:1], sizes[:1], queries,
                                         None if valid is None else valid[:1])
            return perf_mod.combine_flops(counter.get_total_flops(), noted.get("__total__"))

        per_image = perf.flops_for(one, count)
        if per_image is not None:
            perf.flops_for(shape, lambda: per_image * inputs[0].shape[0])

    def _capture(self, key: tuple, inputs: tuple) -> "graphs.ForwardGraph":
        """Capture `key`'s forward and record it in the capture ledger."""
        graph = graphs.capture(self._forward_flat, inputs, self._pool, self._stream,
                               self.model)
        self.graphs[key] = graph
        perf = self.metrics.perf
        if perf.enabled:
            ledger_key = graph_ledger_key(key)
            perf.compiles.record_dispatch(ledger_key)
            perf.compiles.record_compile(ledger_key, graph.capture_s, self._current_source())
        return graph

    def _run_forward(self, shape: str, inputs: tuple) -> tuple:
        """The forward of one staged chunk. On the CPU: eager. On the card:
        the replay of its key's graph; a key's first forward runs eager (its
        shape's FLOPs counted first) and its graph is captured right behind
        it, in the same thread: the eager run warms everything the capture
        needs, and cuDNN and cuBLAS keep their plans per thread, so a
        capture in another thread would have to build them under capture.
        Called under the H2D lock, on the engine's stream."""
        if not self._cuda:
            self._count_flops(shape, inputs)  # once per shape: the ledger caches it
            return self._forward_flat(*inputs)
        key = graphs.graph_key(shape)
        graph = self.graphs.get(key)
        if graph is None:
            self._count_flops(shape, inputs)
            outputs = self._forward_flat(*inputs)
            self._capture(key, inputs)
            return outputs
        if self.metrics.perf.enabled:
            self.metrics.perf.compiles.record_dispatch(graph_ledger_key(key))
        return graph.replay(inputs)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every bucket of the ladder once ahead of traffic and, on the
        card, capture its graph (`_run_forward`). The eager run (after the
        bucket's FLOPs are counted into the perf ledger) warms the
        allocator, the kernels' one-time attributes, cuDNN's algorithm choice
        and the kept casts and codes; each capture lands in the capture
        ledger with its wall time and provenance (`warmup`, or the caller's
        `_compile_source`). A bucket already captured replays."""
        h, w = self.built.preprocess_spec.input_hw
        dtype = torch.uint8 if self.device_preprocess else torch.float32
        source = getattr(self._compile_src, "value", None) or "warmup"
        with self._compile_source(source), self._h2d_lock, self._on_stream():
            for b in self.batch_buckets:
                pixels = torch.zeros((b, h, w, 3), dtype=dtype, device=self.device)
                sizes = torch.ones((b, 2), dtype=torch.float32, device=self.device)
                valid = (torch.tensor([[h, w]], dtype=torch.int32, device=self.device)
                         .repeat(b, 1) if self.built.needs_mask else None)
                self._run_forward(self._shape_key(b, h, w), (pixels, sizes, valid, None, None))
            if self._cuda:
                self._stream.synchronize()
        sample_hbm_once(self.devices, self.metrics.perf)

    @contextmanager
    def _on_stream(self):
        """The engine's stream as the current stream (the CPU: no-op)."""
        if self._stream is None:
            yield
        else:
            with torch.cuda.stream(self._stream):
                yield

    # -- the pipelined detect ------------------------------------------------

    def _qset_queries(self, qset) -> tuple[torch.Tensor, torch.Tensor]:
        """`qset`'s (embeddings, mask) on the device, copied once per query
        set and kept (least recently used dropped past QSET_DEVICE_ENTRIES)
        so a repeated vocabulary pays no host-to-device copy. Called under
        the H2D lock, on the engine's stream."""
        hit = self._qset_tensors.get(qset.key)
        if hit is not None:
            self._qset_tensors.move_to_end(qset.key)
            return hit
        hit = (torch.from_numpy(qset.embeds).to(self.device),
               torch.from_numpy(qset.mask).to(self.device))
        self._qset_tensors[qset.key] = hit
        while len(self._qset_tensors) > QSET_DEVICE_ENTRIES:
            self._qset_tensors.popitem(last=False)
        return hit

    def detect(
        self,
        images: list,
        canvas_hw: Optional[tuple[int, int]] = None,
        qset=None,
    ) -> list[list[dict]]:
        """Images -> per-image lists of {"label", "score", "box"}.

        `images` are PIL images (what the batcher hands over) or uint8
        (H, W, 3) arrays. Splits into chunks of the largest bucket, pads each
        chunk's batch to its bucket and drops the pad rows' results. Boxes
        are in each image's own pixel coordinates (OWLv2's: its padded
        square's).

        Several chunks run a depth-2 pipeline, as the JAX engine's: chunk
        N+1's host staging and upload overlap chunk N's forward and D2H, and
        results come back in order. Across concurrent calls the H2D lock
        covers only upload + dispatch; the wait for the D2H runs outside it.
        A chunk that fails is classified (`engine/errors.py`): an
        out-of-memory chunk is split in half and retried once, serially
        (the next smaller bucket); a fatal device error raises
        `FatalEngineError`; anything else propagates for the batcher's
        poison bisect.

        `canvas_hw` is the ragged scheduler's canvas: fixed-size specs
        ignore it, and a shortest-edge spec raises (the ragged canvas
        packing is not ported). `qset` (a `caching.text_cache.QuerySet`)
        runs an open-vocabulary model against that query set and labels
        from it; a closed-set family raises, as the JAX engine does.
        """
        if qset is not None and self.built.text_encoder is None:
            raise ValueError(
                f"{self.built.model_name} is a closed-set family: it has no "
                f"text encoder, so per-request `queries` are unsupported"
            )
        if canvas_hw is not None and self.built.preprocess_spec.mode == "shortest_edge":
            raise ValueError(RAGGED_SHORTEST_EDGE_ERROR)
        arrays = [as_uint8_rgb(img) for img in images]
        max_b = self.batch_buckets[-1]
        chunks = [arrays[i: i + max_b] for i in range(0, len(arrays), max_b)]
        results: list[list[dict]] = []
        pending = None  # (dispatched item, its chunk)
        for chunk in chunks:
            try:
                host = self._stage_host(chunk, qset)
                with self._h2d_lock:
                    dispatched = self._dispatch(self._put_staged(host))
            except Exception as exc:
                # keep the order: finish the older chunk in flight first,
                # then recover (or fail) this one
                if pending is not None:
                    results.extend(self._finish_or_recover(*pending, qset))
                    pending = None
                results.extend(self._recover_chunk(chunk, exc, qset))
                continue
            if pending is not None:
                results.extend(self._finish_or_recover(*pending, qset))
            pending = (dispatched, chunk)
        if pending is not None:
            results.extend(self._finish_or_recover(*pending, qset))
        return results

    def _finish_or_recover(self, dispatched, chunk: list[np.ndarray], qset=None):
        try:
            return self._finish(dispatched)
        except Exception as exc:
            return self._recover_chunk(chunk, exc, qset)

    def _recover_chunk(
        self, chunk: list[np.ndarray], exc: Exception, qset=None
    ) -> list[list[dict]]:
        """Classify a failed chunk and recover when the taxonomy allows it:
        an out-of-memory chunk drops to the next smaller bucket (split in
        half, retried once, serially); a second failure propagates typed."""
        kind = classify_engine_exception(exc)
        if kind is FatalEngineError:
            raise as_typed(exc) from exc
        if kind is not TransientEngineError:
            raise exc
        self.metrics.record_batch_retry()
        try:
            # the halves may land in a bucket traffic never ran: its capture
            # is an out-of-memory downgrade's cost, not traffic's
            with self._compile_source("oom_downgrade"):
                if len(chunk) <= 1:
                    return self._detect_chunk(chunk, qset)
                mid = (len(chunk) + 1) // 2
                return self._detect_chunk(chunk[:mid], qset) + self._detect_chunk(chunk[mid:], qset)
        except Exception as retry_exc:
            raise as_typed(retry_exc) from retry_exc

    def _detect_chunk(self, chunk: list[np.ndarray], qset=None) -> list[list[dict]]:
        """Serial stage -> dispatch -> fetch for one chunk (<= the top bucket)."""
        host = self._stage_host(chunk, qset)
        with self._h2d_lock:
            dispatched = self._dispatch(self._put_staged(host))
        return self._finish(dispatched)

    def _stage_host(self, chunk: list[np.ndarray], qset=None):
        """The host half: each photo resized (or, for OWLv2, warped in
        float) on the decode pool, straight into pinned (page-locked) host
        buffers of the chunk's bucket on the card; pad rows are zero pixels,
        sizes of ones, and (for a masked model) the whole bucket valid."""
        t0 = time.monotonic()
        n = len(chunk)
        bucket = self.bucket_for(n)
        spec = self.built.preprocess_spec
        h, w = spec.input_hw
        pixels = self._host_buffer((bucket, h, w, 3),
                                   torch.uint8 if self.device_preprocess else torch.float32)
        sizes = self._host_buffer((bucket, 2), torch.float32)
        px, sz = pixels.numpy(), sizes.numpy()
        sz[n:] = 1.0
        valid = None
        if self.device_preprocess:
            _, v, sz[:n] = batch_images_uint8(chunk, spec, pool=self.decode_pool, out=px[:n])
            if self.built.needs_mask:
                valid = self._host_buffer((bucket, 2), torch.int32)
                valid.numpy()[:n], valid.numpy()[n:] = v, (h, w)
        else:
            px[:n], sz[:n] = batch_images_float(chunk, spec, pool=self.decode_pool)
        px[n:] = 0
        meta = {"shape": self._shape_key(bucket, h, w, qset),
                "padded_px": bucket * h * w, "valid_px": n * h * w}
        return (pixels, sizes, valid), n, t0, time.monotonic(), meta, qset

    def _host_buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A new host tensor, pinned (page-locked) on the card: the H2D then
        copies without a bounce buffer, and the pinned-memory allocator
        keeps the buffer until its copy is done."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def _put_staged(self, host_item):
        """The upload half (caller holds the H2D lock): each staged tensor to
        the device, as a non-blocking copy on the engine's stream (ordered
        before the forward that reads it), plus the H2D accounting."""
        host_tensors, n, t0, t_decode, meta, qset = host_item
        with self._on_stream():
            staged = [None if t is None else t.to(self.device, non_blocking=True)
                      for t in host_tensors]
            staged += list(self._qset_queries(qset)) if qset is not None else [None, None]
        self.metrics.record_h2d_bytes(
            sum(t.nbytes for t in host_tensors if t is not None), n)
        self.metrics.set_decode_queue_depth(self.decode_pool.queue_depth())
        return tuple(staged), n, t0, t_decode, time.monotonic(), meta, qset

    def _dispatch(self, staged_item):
        """Run the chunk's forward (a graph replay on the card), then enqueue
        the D2H of its fixed-k outputs into pinned host buffers and record an
        event behind them. Nothing here waits for the card. Caller holds the
        H2D lock."""
        staged, n, t0, t_decode, t_pre, meta, qset = staged_item
        with torch.inference_mode(), self._on_stream():
            outputs = self._run_forward(meta["shape"], staged)
            if self._cuda:
                host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                             for o in outputs)
                for dst, src in zip(host, outputs):
                    dst.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            else:
                host, done = outputs, None
        return host, done, n, t0, t_decode, t_pre, time.monotonic(), meta, qset

    def _finish(self, dispatched_item) -> list[list[dict]]:
        """Wait for the chunk's D2H (outside the H2D lock), threshold on the
        host, record the stage windows and the dispatch's perf record."""
        host, done, n, t0, t_decode, t_pre, t_disp, meta, qset = dispatched_item
        if done is not None:
            done.synchronize()
        scores, labels, boxes = (t.numpy() for t in host)
        t_dev = time.monotonic()
        # a query set's detections label from its own (sorted) queries
        id2label = qset.id2label if qset is not None else self.built.id2label
        out = [
            to_detections(scores[j], labels[j], boxes[j], id2label, self.threshold)
            for j in range(n)
        ]
        t_post = time.monotonic()
        # decode = the decode pool's host work, h2d = the upload's enqueue,
        # device = dispatch -> outputs on the host (under pipelining the next
        # chunk's staging runs inside this window, and so does this chunk's
        # forward), postprocess = the thresholding
        stage_windows = (
            ("decode", t0, t_decode),
            ("h2d", t_decode, t_pre),
            ("device", t_disp, t_dev),
            ("postprocess", t_dev, t_post),
        )
        self.metrics.record_batch(
            n, t_post - t0, stages={name: end - start for name, start, end in stage_windows})
        perf = self.metrics.perf
        perf.record_dispatch(
            device_s=t_dev - t_disp, batch=n, padded_px=meta["padded_px"],
            valid_px=meta["valid_px"], flops=perf.flops_for(meta["shape"]),
            shape=meta["shape"],
        )
        return out


def _named_tensors(module: nn.Module):
    """Every parameter and buffer of `module`, by name."""
    yield from module.named_parameters()
    yield from module.named_buffers()


def graph_ledger_key(key: tuple) -> str:
    """A graph key as the capture ledger's shape string: the JAX engine's
    shape key, then the knob values after a `|`."""
    shape, knobs = key
    return shape + "|" + ";".join(",".join(map(str, k)) for k in knobs)


def as_uint8_rgb(image) -> np.ndarray:
    """A PIL image or a uint8 (H, W, 3) array -> uint8 (H, W, 3) array."""
    if isinstance(image, np.ndarray):
        return image
    if image.mode != "RGB":
        image = image.convert("RGB")
    return np.array(image)  # a writable copy: torch.from_numpy takes it as is
