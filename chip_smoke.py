#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spotter_tpu_torch) on one NVIDIA GPU.

Drives the port's default detection path, RT-DETRv2-R101 at full width
with weights drawn from --seed, through the entry points a user calls, and
holds its one hand-written kernel (csrc/msda.cu, MSDA sampling) against the
kernel's plain PyTorch version. Phases, each printing one JSON line:

1. device  — card name, `nvidia-smi` name and power limit, and whether the
             serving layer's packages (PIL, aiohttp, httpx, pydantic) import;
2. build   — nvcc build of the kernel library for sm_90a, with its seconds;
3. kernel  — msda_gather_sum against msda_gather_sum_reference at the decoder's
             shapes (B = 1 and 8; fp32 and bf16 rows; default and discrete corner
             prep): max abs error against the tolerance, kernel / plain /
             embedding_bag times (CUDA events, cold L2), and the memory bound
             for the rows this data samples;
4. parity  — the full-width forward at B = 1 on the card against the same
             model on the CPU, TF32 off, logits and boxes against a tolerance;
5. serve   — InferenceEngine on cuda, warmed over the bucket ladder, answering
             requests of 1, 3 and 8 synthetic photos (480x640 to 1080x1440) through
             detect + response assembly; the MSDA launch counter, reset just
             before, must grow by exactly 6 per forward (one per decoder layer).

Then a `{"kernels": [...]}` summary line, the `nvidia-smi` name/power line,
and last `{"ok": true, "device": {...}}`. Any failure raises and the exit
code is non-zero. Needs one CUDA card and the repository checkout around
this file; exits non-zero without either.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernel,parity,serve]

The full record is also written to build/chip_smoke.json (or --out).
"""

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernel", "parity", "serve")
MODEL_NAME = "PekingU/rtdetr_v2_r101vd"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# max |kernel - plain|: both sum the same fp32 products (bf16 rows widen
# exactly to fp32) over J <= 48 terms, in another order (FMA chain vs a
# pairwise reduction); weights are in [0, 1] and sum to <= 1 per query-head
KERNEL_ATOL = 1e-5
# card vs CPU, full-width forward: fp32 throughout with TF32 off on the card,
# but cuDNN and oneDNN pick different convolution algorithms, so every one of
# the ~140 convs and the dense layers sums in another order
PARITY_ATOL_LOGITS = 1e-3
PARITY_ATOL_BOXES = 1e-4


def emit(record: dict, log: list) -> None:
    log.append(record)
    print(json.dumps(record), flush=True)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def synthetic_photo(rng, h: int, w: int):
    """A smooth pattern plus noise, uint8 HWC: a stand-in listing photo."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6.28, 3).astype(np.float32)
    base = 127 + 90 * np.sin(xx[..., None] / rng.uniform(8, 40) + phase) * np.cos(
        yy[..., None] / rng.uniform(8, 40)
    )
    noise = rng.normal(0, 15, (h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def cuda_time_ms(fn, iters: int, flush) -> float:
    """Median milliseconds of `fn` by CUDA events, one launch per pair of
    events, with the L2 cache flushed before each (the decoder meets its
    inputs cold: they are written by the layer's projections just before)."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_device(log: list) -> dict:
    import torch

    packages = {}
    for name in ("PIL", "aiohttp", "httpx", "pydantic"):
        try:
            importlib.import_module(name)
            packages[name] = True
        except ImportError:
            packages[name] = False
    rec = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi("name,power.limit"),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "serving_packages": packages,
    }
    emit(rec, log)
    return rec


def phase_build(log: list) -> dict:
    from spotter_tpu_torch.ops.msda import build_msda_kernel

    lib = build_msda_kernel()
    ptxas = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln]
    rec = {
        "phase": "build", "library": str(lib.path.relative_to(REPO)),
        "seconds": lib.build_seconds, "ptxas": ptxas,
    }
    emit(rec, log)
    return rec


def msda_case(b: int, rows_dtype, method: str, seed: int, flush, device: str = "cuda") -> dict:
    """One kernel-vs-plain case at the R101 decoder's sampling shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from spotter_tpu_torch.ops.msda import (
        msda_gather_sum,
        msda_gather_sum_reference,
        prepare_msda_gather,
    )

    shapes = ((80, 80), (40, 40), (20, 20))  # 640x640 at strides 8/16/32
    heads, hd, q, points = 8, 32, 300, 4
    s = sum(h * w for h, w in shapes)
    lp = len(shapes) * points
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    value = torch.from_numpy(rng.standard_normal((b, s, heads, hd), dtype=np.float32)).to(dev)
    # decoder sampling points: around the reference boxes, a few outside [0, 1]
    loc = torch.from_numpy(rng.uniform(-0.05, 1.05, (b, q, heads, lp, 2)).astype(np.float32)).to(dev)
    attn = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, q, heads, lp), dtype=np.float32)).to(dev), dim=-1)
    rows = value.to(rows_dtype).permute(0, 2, 1, 3).reshape(b * heads, s, hd).contiguous()
    idx, w = prepare_msda_gather(loc, attn, shapes, points, method)
    bh, _, j = idx.shape

    launches_before = msda_gather_sum.launches
    got = msda_gather_sum(rows, idx, w)
    want = msda_gather_sum_reference(rows, idx, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"msda kernel vs plain: max abs err {err} > {KERNEL_ATOL}")

    flat_idx = (idx.long() + torch.arange(bh, device=dev).view(bh, 1, 1) * s).reshape(bh * q, j)
    flat_rows = rows.reshape(bh * s, hd)
    bag_w = w.reshape(bh * q, j).to(rows_dtype)

    def library():
        return F.embedding_bag(flat_idx, flat_rows, per_sample_weights=bag_w, mode="sum")

    lib_err = (library().float().reshape(bh, q, hd) - want).abs().max().item()
    # least traffic for this data: each value row that some term with a
    # non-zero weight samples, read once; idx and w read once; out written once
    needed = (idx >= 0) & (idx < s) & (w != 0)
    rows_needed = torch.unique(flat_idx.reshape(bh, q, j)[needed]).numel()
    nbytes = rows_needed * hd * rows.element_size() + idx.numel() * 4 + w.numel() * 4 \
        + got.numel() * 4
    flops = 2 * bh * q * j * hd
    bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    kernel_ms = cuda_time_ms(lambda: msda_gather_sum(rows, idx, w), 30, flush)
    return {
        "phase": "kernel", "batch": b, "rows_dtype": str(rows_dtype).removeprefix("torch."),
        "method": method, "shape": {"bh": bh, "s": s, "hd": hd, "q": q, "j": j},
        "max_abs_err": err, "atol": KERNEL_ATOL, "library_max_abs_err": lib_err,
        "kernel_ms": kernel_ms,
        "launches": msda_gather_sum.launches - launches_before,  # check + timing
        "plain_ms": cuda_time_ms(lambda: msda_gather_sum_reference(rows, idx, w), 10, flush),
        "library_ms": cuda_time_ms(library, 30, flush),
        "rows_needed": rows_needed, "rows_total": bh * s, "bytes": nbytes, "flops": flops,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_us": max(bound_bytes_ms, bound_ops_ms) * 1e3,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
    }


def phase_kernel(log: list, seed: int) -> list:
    import torch

    from spotter_tpu_torch.ops.msda import msda_gather_sum

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    before = msda_gather_sum.launches
    cases = []
    for b in (1, 8):
        for rows_dtype in (torch.float32, torch.bfloat16):
            for method in ("default", "discrete"):
                rec = msda_case(b, rows_dtype, method, seed, flush)
                emit(rec, log)
                cases.append(rec)
    if msda_gather_sum.launches == before:
        raise AssertionError("the kernel phase never launched the CUDA kernel")
    return cases


def canonical(out: dict):
    """Order a B=1 forward's queries by the source position each was selected
    from: the decoder is permutation-equivariant over queries, so two runs
    whose top-k picks near-equal scores in another order still compare."""
    import torch

    index = out["enc_topk_index"][0].cpu()
    order = torch.argsort(index)
    return index[order], out["logits"][0].cpu()[order], out["pred_boxes"][0].cpu()[order]


def phase_parity(log: list, seed: int, built, device: str = "cuda") -> dict:
    import copy

    import numpy as np
    import torch

    from spotter_tpu_torch.ops.preprocess import device_rescale_normalize, resize_uint8
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    spec = built.preprocess_spec
    img = resize_uint8(synthetic_photo(np.random.default_rng(seed + 1), 720, 960), spec.size)
    x = device_rescale_normalize(torch.from_numpy(img[None]), spec)
    cpu_model = copy.deepcopy(built.module).to("cpu").eval()
    gpu_model = copy.deepcopy(built.module).to(device).eval()
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_model(x)
        cpu_s = time.perf_counter() - t0
        got = gpu_model(x.to(device))
        torch.cuda.synchronize()
    del gpu_model, cpu_model
    ref_idx, ref_logits, ref_boxes = canonical(ref)
    got_idx, got_logits, got_boxes = canonical(got)
    same_selection = bool(torch.equal(ref_idx, got_idx))
    rec = {
        "phase": "parity", "model": MODEL_NAME, "batch": 1,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "same_query_selection": same_selection,
        "logits_max_abs_err": (got_logits - ref_logits).abs().max().item(),
        "boxes_max_abs_err": (got_boxes - ref_boxes).abs().max().item(),
        "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
        "logits_abs_max": ref_logits.abs().max().item(),
        "cpu_forward_s": cpu_s,
    }
    emit(rec, log)
    if not same_selection:
        raise AssertionError("card and CPU selected different query sets")
    if not (rec["logits_max_abs_err"] <= PARITY_ATOL_LOGITS
            and rec["boxes_max_abs_err"] <= PARITY_ATOL_BOXES):
        raise AssertionError(f"card vs CPU forward outside tolerance: {rec}")
    if not (torch.isfinite(got["logits"]).all() and torch.isfinite(got["pred_boxes"]).all()):
        raise AssertionError("non-finite outputs on the card")
    return rec


def check_response(resp: dict, raw: list, n: int) -> None:
    import math

    if len(resp["images"]) != n or len(raw) != n:
        raise AssertionError(f"expected {n} image results, got {len(resp['images'])}")
    for dets in raw:
        for d in dets:
            if not (0.0 <= d["score"] <= 1.0 and all(math.isfinite(v) for v in d["box"])):
                raise AssertionError(f"bad detection {d}")
    if not isinstance(resp["amenities_description"], str):
        raise AssertionError("missing amenities_description")


def phase_serve(log: list, seed: int, built, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.ops.msda import msda_gather_sum
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8
    from spotter_tpu_torch.serving.detector import assemble_response

    rng = np.random.default_rng(seed + 2)
    sizes = [(480, 640), (1080, 1440), (600, 800), (768, 1024), (1080, 810), (640, 480),
             (900, 1200), (720, 960)]
    photos = [synthetic_photo(rng, h, w) for h, w in sizes]
    requests = [photos[:1], photos[1:4], photos[:8]] + [photos[:8]] * 5

    engine = InferenceEngine(built, device=device)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    decoder_layers = built.module.config.decoder_layers

    msda_gather_sum.launches = 0  # count only the main path's launches from here
    latencies, forwards = [], 0
    for reqn, images in enumerate(requests):
        urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
        t0 = time.perf_counter()
        raw = engine.detect(images)
        resp = assemble_response(urls, raw)
        latencies.append(time.perf_counter() - t0)
        forwards += -(-len(images) // engine.batch_buckets[-1])
        check_response(resp, raw, len(images))
    launches = msda_gather_sum.launches
    if launches != decoder_layers * forwards:
        raise AssertionError(
            f"MSDA kernel launched {launches} times over {forwards} forwards, "
            f"expected {decoder_layers} per forward"
        )

    # where a batch-8 request's time goes: host resize vs device forward
    t0 = time.perf_counter()
    pixels, _, tsizes = batch_images_uint8(photos[:8], built.preprocess_spec)
    host_ms = (time.perf_counter() - t0) * 1e3
    px = torch.from_numpy(pixels).to(device)
    sz = torch.from_numpy(tsizes).to(device)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    with torch.inference_mode():
        device_ms = cuda_time_ms(lambda: engine._forward(px, sz), 5, flush)
    b8 = latencies[2:]
    rec = {
        "phase": "serve", "model": MODEL_NAME, "device": device, "warmup_s": warmup_s,
        "requests": [len(r) for r in requests],
        "latency_ms": [v * 1e3 for v in latencies],
        "batch8_p50_ms": statistics.median(b8) * 1e3,
        "batch8_img_per_s": 8 / statistics.median(b8),
        "batch8_host_resize_ms": host_ms,
        "batch8_device_forward_ms": device_ms,
        "forwards": forwards, "msda_launches": launches,
        "launches_per_forward": launches / forwards,
        "detections_per_image": [len(d) for d in raw],
        "amenities_description": resp["amenities_description"],
    }
    emit(rec, log)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=str(REPO / "build" / "chip_smoke.json"))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "spotter_tpu_torch" / "csrc" / "msda.cu").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from spotter_tpu_torch.models.registry import build_detector

    log: list = []
    t_start = time.perf_counter()
    device = phase_device(log)
    if "build" in phases:
        phase_build(log)
    cases = phase_kernel(log, args.seed) if "kernel" in phases else []
    built = None
    if "parity" in phases or "serve" in phases:
        built = build_detector(MODEL_NAME, tiny=False, seed=args.seed)
    if "parity" in phases:
        phase_parity(log, args.seed, built)
    serve = phase_serve(log, args.seed, built) if "serve" in phases else None

    if cases:
        main_case = next(c for c in cases if c["batch"] == 8 and c["rows_dtype"] == "float32"
                         and c["method"] == "default")
        summary = {"kernels": [{
            "name": "msda_gather_sum",
            "route": "cuda",
            "source": "spotter_tpu_torch/csrc/msda.cu",
            "replaces": "spotter_tpu/ops/msda.py:906",
            "launches": serve["msda_launches"] if serve else None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        }]}
        log.append(summary)
        print(json.dumps(summary), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"records": log, "seconds": time.perf_counter() - t_start}, indent=1))
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
