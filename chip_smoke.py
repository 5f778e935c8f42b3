#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spotter_tpu_torch) on one NVIDIA GPU.

Drives the port's paths through the entry points a user calls, at full
width with weights drawn from --seed: RT-DETRv2-R101, YOLOS (yolos-base,
800x1344, under the "float32" and "mixed" precision policies),
Deformable-DETR (SenseTime/deformable-detr, photos staged into the
1333x1333 bucket with a pixel mask, under each SPOTTER_TPU_MSDA backend),
the DETR lineage in the same bucket (DETR-R50, Table-Transformer,
Conditional-DETR, DAB-DETR: masked attention, no hand-written kernel), and
OWLv2 (owlv2-base-patch16-ensemble, 960x960, both policies) with
OWL-ViT B/32; RT-DETRv2-R101 and the other families with int8
quantization on (SPOTTER_TPU_INT8, _INT8_DENSE, _INT8_ATTN); then the
port's three measurement tools. Holds its fifteen hand-written kernels
against their plain PyTorch versions: csrc/msda.cu
(MSDA gather-sum, loc-prep and fused-prologue sampling),
csrc/msda_backends.cu (the pallas_sep separable sampling and the
pallas_gather lane gather), csrc/attention.cu (flash attention, fp32 and
bf16), csrc/class_logits.cu (the OWL class-logit head), csrc/quant.cu
(the int8 path's amax, quantize and dequant passes) with csrc/int8_conv.cu
(the int8 convolution) and csrc/int8_gemm.cu's K-major entry, and the
probes' csrc/int8_gemm.cu, csrc/pack_tile.cu and csrc/launch_probe.cu.
Phases, each printing JSON lines:

1. device  — card name, `nvidia-smi` name and power limit, and whether the
             serving layer's packages (PIL, aiohttp, httpx, pydantic) import;
2. build   — nvcc builds of the nine kernel libraries for sm_90a, started
             together, with their seconds;
3. kernel  — each kernel against its plain version: the MSDA kernels at the
             decoder's shapes (B = 1 and 8; fp32 and bf16 rows; default and
             discrete corner prep; the fused kernel also at each query tile
             it takes, and its fp32 SASS counted); the sep and lane-gather
             kernels at B = 8
             on one MSDA op of the RT-DETR decoder, the Deformable-DETR
             encoder at the 1333x1333 bucket (its densest level alone, and
             all four levels) and its decoder, default and discrete, with
             half the sep hit table's bits cleared (which must drop exactly
             those bands), and bf16 rows (sep: ms per op and per launch; the
             lane gather reads the value (B, S, H, hd) in place, and its fp32
             SASS must load value rows 128 bits at a time, LDG.E.128); the
             gather-sum and loc kernels again at the Deformable-DETR encoder
             and decoder ops (B = 8, fp32, default and discrete; the value,
             loc and attn read in place, and their fp32 SASS must show
             LDG.E.128 too); rows 1-4's one-pass mode (the policies'
             SPOTTER_TPU_MSDA_PRECISION=default) at B = 8 against their plain
             "default" versions: rows 1-3 at the RT-DETR decoder op, rows
             1, 2 and 4 at the Deformable-DETR encoder op, row 4 also at the
             RT-DETR decoder op, fp32 and bf16 rows (the one-pass gather-sum
             and loc fp32 SASS must show LDG.E.128 too);
             the attention kernels at YOLOS's shapes and more (B = 1 and 8,
             S = 4301 and 1100, hd = 64 and 128, fp32 and bf16; both
             kernels' SASS must show wgmma (HGMMA), no mma.sync (HMMA) and
             TMA loads (UTMALDG); the fp32 kernel's K/V split pass must
             equal its plain version bit for bit and launch once a call, and
             is timed alone; fp32 records both bounds, on the CUDA cores and
             as split TF32), the class-logit
             kernel at OWLv2's and OWL-ViT
             B/32's shapes (P = 3600 and 576; B = 1 and 8; fp32 and bf16
             features; 22 queries, 24 with 2 masked, 160; its SASS must show
             wgmma (HGMMA) and TMA loads (UTMALDG), no HMMA): max abs error
             against the tolerance, kernel / plain / library (embedding_bag,
             scaled_dot_product_attention; none for the others) times by CUDA
             events with a cold L2, and the bound;
4. parity  — the full-width forward at B = 1 on the card against the same
             model on the CPU, TF32 off, under each SPOTTER_TPU_MSDA_PREP
             setting (xla, kernel, fused) and under SPOTTER_TPU_MSDA=pallas_sep
             and =pallas_gather, and card kernel and card fused against
             card xla at B = 8: logits and boxes against a tolerance;
5. serve   — slice 1's path under xla: InferenceEngine on cuda, warmed,
             answering requests of 1, 3 and 8 synthetic photos (480x640 to
             1080x1440) through detect + response assembly; the gather-sum
             count, reset just before, must grow by 6 per forward (every
             forward past warmup is a replay of the bucket's CUDA graph,
             which adds its captured launches);
5b. engine — the engine's full form at full width, buckets (1, 2, 4, 8),
             under "float32" and "bfloat16" (and "bfloat16" +
             SPOTTER_TPU_INT8 at B = 8): warmup captures one CUDA graph per
             bucket (the capture ledger's count and wall per bucket); each
             replay bit equal to the eager forward; host, wall and kernel ms
             a forward and the busy share at B = 1 and 8, eager against
             replay (torch.profiler); a 24-photo detect (three B = 8 chunks
             in flight) equal to three serial calls, counts reset just
             before; mfu_pct and the HBM gauges; attest() ok, naming
             device:0 after corrupt_weights(1), ok after reload_weights();
             a knob change (MSDA_PREP xla -> kernel) capturing anew and
             launching row 2;
6. http    — the replica's entry point: the port's standalone server on
             localhost (full-width model) answering POST /detect for JPEGs
             served by a local HTTP server: 1, 3 and 8 URLs, then 4
             concurrent clients of 8 URLs, under fused; then 8 URLs under
             kernel. Each run's counts are reset just before it; the fused
             (resp. loc) kernel must launch 6 times per forward and no other
             kernel at all. p50/p99 per request size, img/s, images per
             forward (how well the batcher coalesced), /healthz 200 and no
             integrity snapshot in /metrics (the injected detector skips the
             verifying gate, as the JAX package's does);
6b. integrity — the replica's output-integrity plane on RT-DETRv2-R101 at
             full width, each replica brought up through make_app (its
             bring-up, not an injected detector): under "float32" /startupz
             passes loading -> warming -> verifying -> ready, the gate's
             attest and probe seconds and the pinned detections per bucket,
             the golden probe alone (msda_gather_sum 6 launches) and
             co-batched with 1, 3 and 7 photos (buckets 2, 4, 8), each
             within compare's tolerance of its bucket's pin (and its drift
             from the bucket-1 pin), a traced request's spans, Server-Timing
             and Prometheus /metrics, /detect p50/p99 over a burst with the
             plane's 1 s loop running and stopped, sdc=100 (/detect 200, the
             periodic probe exits 86) and one bit of a kept value flipped
             (the periodic attest exits 86); under "bfloat16" +
             SPOTTER_TPU_INT8 the gate and the probe by bucket;
             SPOTTER_TPU_FAULTS=corrupt_weights=1 (exit 86 before READY, no
             /detect answering 200) and corrupt_compile_cache=1 (attest
             clean, the probe fails, exit 86);
6c. planes — the replica's planes on RT-DETRv2-R101 (`phase_planes`),
             brought up through make_app with buckets (1, 8), the result
             cache, two tenants and the integrity gate: an 8-URL request
             missing then hitting (no forward, no launch on the hit; the miss
             within compare's tolerance of a cache-off detector), the golden
             probe with the cache full (6 msda_gather_sum launches), 8
             coalesced requests (one fetch, one forward), a tenant flooding
             at 5x its quota (429s with Retry-After and no fetch, none for
             the other tenant), and an SPTF frame equal to the JSON;
7. yolos_parity — yolos-base at B = 1 on the card against the same model on
             the CPU under "float32" (TF32 off), then the card under "mixed"
             (bf16 body) against the card under "float32" at B = 8; and at
             an off-native 640x960 (its position tables resized by
             ops/resize.py) under each policy, the kernels' route against
             the plain route (attention off the kernel) on the card;
8. yolos_serve — InferenceEngine.detect on 1 and 8 photos under "float32"
             and "mixed"; flash_attn_fp32 with its split pass (resp. _bf16)
             must launch 12 times per forward and no other kernel at all; p50/p99, img/s, device
             ms per forward;
9. yolos_http — the standalone server with yolos-base answering POST
             /detect for 1 and 8 URLs under each policy, with the same count
             check;
10. ddetr_parity — SenseTime/deformable-detr at B = 1, a landscape photo
             staged into the 1333x1333 bucket: the card under xla, pallas_sep
             and pallas_gather, each against the CPU under xla (TF32 off);
11. ddetr_serve — InferenceEngine.detect on 1 and 8 photos under each
             backend: msda_gather_sum (xla) or msda_hd_gather_sum
             (pallas_gather) must launch 12 times per forward (6 encoder and 6
             decoder ops), msda_sep_sum 48 (once per level of each), and no
             other kernel; p50/p99, img/s, device ms per forward (also under
             xla with SPOTTER_TPU_MSDA_PREP=kernel), host resize ms;
12. ddetr_http — the standalone server with Deformable-DETR answering POST
             /detect for 1 and 8 URLs under each backend, with the same count
             check;
13. detr_parity — facebook/detr-resnet-50, microsoft/table-transformer-detection,
             microsoft/conditional-detr-resnet-50 and IDEA-Research/dab-detr-resnet-50
             at B = 1, a landscape photo staged into the 1333x1333 bucket with
             its mask: the card against the CPU (TF32 off), logits, boxes and
             DAB-DETR's per-layer boxes; no kernel may launch (their encoder's
             1764-token self-attention is masked, so it stays off the
             attention kernel, as the JAX package stays off its Pallas one);
14. detr_serve — the four through InferenceEngine.detect on 1 and 8
             photos, no kernel launched; p50/p99, img/s, device ms per
             forward at B = 1 and 8;
15. detr_http — the standalone server with DETR-R50 answering POST /detect
             for 1 and 8 URLs, no kernel launched;
15b. ragged — ragged canvas packing (SPOTTER_TPU_RAGGED=1) on
             Deformable-DETR and DETR-R50, each a replica brought up through
             make_app with the integrity gate and its probe at 1 s
             (`phase_ragged`): a mix of listing-photo shapes, ragged (cold,
             then warm) and FIFO on one engine, with padding waste, p50,
             canvases, captures and their seconds, memory reserved; every
             ragged pack within compare's tolerance of the engine's eager
             forward at its canvas, one capture per new (bucket, canvas),
             the probe never failing; a B = 8 int8 forward at a ragged
             canvas bit equal to its plain witness; rows 1-5 at a ragged
             canvas's level shapes (768x1333: 96x167 ... 12x21) against
             their plain versions;
16. owl_parity — OWLv2 and OWL-ViT B/32 at B = 1, the card against the CPU
             under "float32" (TF32 off): logits, boxes and objectness; then
             OWLv2 at an off-native 768x768, the kernels' route against the
             plain route on the card; OWLv2 on the card under "mixed" against
             "float32" at B = 8, and SPOTTER_TPU_OWL_FUSED=0 (the unfused
             head) against auto;
17. owl_serve — OWLv2 through InferenceEngine.detect on 1 and 8 photos under
             "float32" and "mixed", plus requests with their own query set:
             owl_class_logits must launch once and flash_attn_fp32 with its
             split pass (resp. _bf16) 12 times per forward, and no other
             kernel; p50/p99,
             img/s, device ms per forward, host preprocess ms (the float
             pad-to-square warp) and detections per image;
18. owl_http — the standalone server with OWLv2 answering POST /detect for 1
             and 8 URLs under the default vocabulary and for 8 URLs with
             `queries`, with the same count check; the labels of a queries
             request must all be among its queries;
19. load  — every family built from a local HF checkpoint directory
             (MODEL_NAME=<dir>), the seeded model written there first by
             tools/hf_checkpoint.py (model.safetensors without the tied
             twins, config.json): RT-DETRv2-R101 at full width and depth,
             its loaded weights equal to the seeded ones bit for bit, 8
             photos through InferenceEngine.detect (xla) with the seeded
             engine's logits, boxes and detections, /detect for 1 and 8 URLs
             under fused and kernel, rows 1-3 launching 6 per forward; then
             YOLOS, Deformable-DETR with box refinement (pytorch_model.bin),
             DETR, Conditional-DETR, DAB-DETR and OWLv2 at full width, each
             built from its checkpoint with one B = 1 forward equal to the
             seeded model's and its kernels' launches; each load's seconds
             (config, file read and conversion, load_from_jax apart) and
             bytes;
20. precision — the "mixed" and "bfloat16" policies (`phase_precision`);
21. int8  — int8 quantization: tools/bench_int8_conv.py at the JAX probe's
             seven conv shapes in bf16 (and `csp80` in fp32), through the
             served three-kernel path (amax, NHWC quantize, conv_s8), the
             NHWC entry's coverage list (ragged H*W, C not a multiple of
             16 or wider than a tile, c_pad past C, NCHW and
             channels-last, fp32 and bf16, with the route at kernel sizes
             1, 3 and 7, strides 1 and 2), conv_s8 at every served conv
             shape of the seven families, the heads entries' coverage list
             (one launch and two, contiguous, packed and unaligned views),
             a dense shape (YOLOS-base's 34,408 rows, ragged) and an
             attention shape (B·H 64, Tq = Tk = 300, hd 32), every pass
             exact against its plain version (amax, codes, int32 products,
             dequant and conv_s8 bit for bit), timed beside its bound,
             cuDNN's bf16 conv, torch.linalg.vector_norm and
             torch._int_mm, and which path of the amax and quantize passes
             and which conv_s8 tile served each case; int8_gemm's and
             conv_s8's SASS with IGMMA and no IMMA;
             RT-DETRv2-R101 under "bfloat16" with
             SPOTTER_TPU_INT8=1, then with all three knobs, and under
             "float32" with INT8=1: the B = 8 quantized forward bit equal to
             its plain witness (every int8 wrapper routed to its plain
             version on the same card tensors) and beside the float one
             (encoder scores within the "bfloat16" policy's 25 %), its
             quantized calls equal to the module
             tree's count and each int8 kernel's launches to them, B = 1
             (below the batch floor) bit equal to the float forward, device
             ms and stages; the engine on 8 photos and /detect for 8 URLs in
             the throughput bucket (buckets (8,)); YOLOS-base "mixed" +
             INT8_DENSE against its float forward, and one B = 8 forward of
             each other family with every knob on, each bit equal to its
             plain witness;
22. probes — the three measurement tools through their `main`, each with
             its kernel's count set to 0 just before: bench_int8 (int8_gemm
             exactly equal to its plain version at n = 4096, 8192 and 4000,
             with its transpose pass equal to b.t().contiguous(), beside
             torch._int_mm and a bf16 mm; its SASS must show wgmma (IGMMA)
             and no mma.sync (IMMA)), bench_pack_probe (pack_tile's eight
             variants bit for bit at bh = 16; the fp32 base and hoist SASS
             must show no select, FSEL, past a chain's first element) and
             profile_r101 (RT-DETR's per-part ms at B = 8, and
             launch_probe equal to 2x, eager and in a CUDA graph). Each
             kernel's launches must equal the tool's calls of it.

The OWL families read their prompts' token ids from a tokenization cache;
the script writes one for its prompts under a temporary
SPOTTER_TPU_CACHE, with CLIP-shaped ids drawn from --seed (the weights are
random, so only the ids' shape matters). Every RT-DETR and Deformable-DETR
path must launch neither attention kernel, no RT-DETR, YOLOS or
Deformable-DETR path the class-logit kernel, and no DETR-lineage path any
kernel. Then each phase's seconds (`phase_seconds`), a
`{"kernels": [...]}` summary line, the `nvidia-smi` name/power line,
and last `{"ok": true, "device": {...}}`. Any failure raises and the exit
code is non-zero. Needs one CUDA card and the repository checkout around
this file; exits non-zero without either.

    python3 chip_smoke.py [--seed 0] [--phases device,build,kernel,parity,serve,engine,http,
                                            integrity,planes,yolos_parity,yolos_serve,yolos_http,
                                            ddetr_parity,ddetr_serve,ddetr_http,
                                            detr_parity,detr_serve,detr_http,ragged,
                                            owl_parity,owl_serve,owl_http,load,precision,
                                            int8,probes]

The full record is also written to build/chip_smoke.json (or --out).
"""

import argparse
import asyncio
import contextlib
import copy
import dataclasses
import functools
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernel", "parity", "serve", "engine", "http", "integrity",
          "planes", "yolos_parity",
          "yolos_serve", "yolos_http", "ddetr_parity", "ddetr_serve", "ddetr_http",
          "detr_parity", "detr_serve", "detr_http", "ragged", "owl_parity", "owl_serve",
          "owl_http",
          "load", "precision", "int8", "probes")
OWL_PHASES = ("owl_parity", "owl_serve", "owl_http")
MODEL_NAME = "PekingU/rtdetr_v2_r101vd"
YOLOS_NAME = "hustvl/yolos-base"
OWLV2_NAME = "google/owlv2-base-patch16-ensemble"
OWLVIT_NAME = "google/owlvit-base-patch32"
# a request's own vocabulary: 5 queries, padded to 8 with 3 masked slots
OWL_QUERIES = ("sofa", "floor lamp", "kitchen sink", "bed", "window")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate,
# dense bf16 and TF32 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# the fp32 attention kernel takes each product in three TF32 passes
# (hi.hi + hi.lo + lo.hi), so its operations bound is 3x the function's
# FLOPs at the TF32 rate
SPLIT_TF32_PASSES = 3

# max |kernel - plain|, every kernel and method: both sum the same fp32
# products (bf16 rows widen exactly to fp32) over J <= 48 terms, in another
# order (FMA chain vs a pairwise reduction); weights are in [0, 1] and sum to
# <= 1 per query-head. The loc kernel's corner arithmetic rounds as the plain
# version's does, and the fused kernel's plain version sums its prologue in
# the kernel's order, so the sample locations agree bit for bit and the
# discrete method (nearest cell, not continuous) is held to the same 1e-5
KERNEL_ATOL = 1e-5
# card vs CPU, full-width forward: fp32 throughout with TF32 off on the card,
# but cuDNN and oneDNN pick different convolution algorithms, so every one of
# the ~140 convs and the dense layers sums in another order. Card fused vs
# card xla is held to the same: the two prologues associate the offset scale
# differently (an ulp or so in the locations)
PARITY_ATOL_LOGITS = 1e-3
PARITY_ATOL_BOXES = 1e-4
# attention kernel vs plain, as a share of the largest |output|. fp32: both
# sum up to 4301 weighted values in fp32 in other orders (cuBLAS blocks, the
# kernel a running sum rescaled once per key tile), ~sqrt(S) * 2**-24 =
# 4e-6 of |out| typically; 2e-5 leaves room for the tail. The kernel's
# products are split TF32 (three passes of two-term operands, ~2**-21
# relative a product): tools/attention_rounding.py --precision fp32 puts
# that split at ~1e-7 of |out|, so the gate is the fp32 one. bf16: the kernel
# multiplies bf16 inputs on the tensor cores with fp32 sums, takes the softmax
# in fp32, feeds P to P.V as two bf16 terms (P_hi + P_lo, ~2**-17 relative)
# and rounds its output once, so it is held against the plain version run in
# fp32 on the same bf16 inputs and rounded to bf16 the same way: they may
# differ by one bf16 ulp, at most 2**-7 of the largest output
ATTN_RTOL = {"float32": 2e-5, "bfloat16": 2.0**-7}
# yolos-base, card vs CPU under "float32" at B = 1: the RT-DETR tolerances.
# fp32 throughout with TF32 off, but every product sums in another order
# (cuBLAS / cuDNN vs oneDNN), and the card's attention is the kernel (q scaled
# first, online softmax) against the CPU's materialised scores (scaled after):
# ~1e-6 relative per op through 12 residual layers; boxes are a sigmoid
# (slope <= 1/4) of the box head's output
# card "mixed" (bf16 body) vs card "float32" at B = 8: the bf16 residual
# stream rounds at 2**-8 relative some 40 times over 12 layers (every dense
# output, LayerNorm, GELU and residual add), ~sqrt(40) * 2**-9 = 1 % typical
# of the activations' scale, compounding through the heads: logits within
# 10 % of the largest |logit|, boxes within 0.05 (sigmoid slope <= 1/4)
MIXED_RTOL_LOGITS = 0.1
MIXED_ATOL_BOXES = 0.05
# class-logit kernel vs plain, as a share of the largest unmasked |logit|:
# both widen the features to fp32 and sum Dt = 512 products, in another
# order (the kernel's split-TF32 wgmmas, both operands as two TF32 terms,
# ~2**-21 relative a product, summed on the tensor cores 8 columns a step,
# and per-lane fp32 chains of squares finished by quad shuffles for the
# norm; the plain version's cuBLAS GEMM), and the kernel scales the
# product by the norm's reciprocal where the plain version divides the
# features first:
# tools/class_logits_rounding.py puts the split at well under 1e-6 of the
# largest logit, so the gate is the fp32 one. Masked columns must be
# NEG_INF bit for bit
CLASS_LOGITS_RTOL = 1e-5


T0 = time.perf_counter()  # the run's start: each record carries its seconds since (`t_s`)


def emit(record: dict, log: list) -> None:
    record.setdefault("t_s", time.perf_counter() - T0)
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
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6.28, 3).astype(np.float32)
    base = 127 + 90 * np.sin(xx[..., None] / rng.uniform(8, 40) + phase) * np.cos(
        yy[..., None] / rng.uniform(8, 40)
    )
    noise = rng.normal(0, 15, (h, w, 3)).astype(np.float32)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


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
    """The nine kernel libraries, one nvcc each, started together."""
    from spotter_tpu_torch.ops.attention import build_attention_kernel
    from spotter_tpu_torch.ops.int8 import (
        build_int8_conv_kernel,
        build_int8_gemm_kernel,
        build_quant_kernel,
    )
    from spotter_tpu_torch.ops.msda import build_msda_backends_kernel, build_msda_kernel
    from spotter_tpu_torch.ops.openvocab import build_class_logits_kernel
    from spotter_tpu_torch.tools.bench_pack_probe import build_pack_tile_kernel
    from spotter_tpu_torch.tools.profile_r101 import build_launch_probe_kernel

    builds = (build_msda_kernel, build_msda_backends_kernel, build_attention_kernel,
              build_class_logits_kernel, build_int8_gemm_kernel, build_int8_conv_kernel,
              build_quant_kernel, build_pack_tile_kernel, build_launch_probe_kernel)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = [pool.submit(build) for build in builds]
        libs = [f.result() for f in futures]
    rec = {"phase": "build", "wall_s": time.perf_counter() - t0, "libraries": [
        {"library": str(lib.path.relative_to(REPO)), "seconds": lib.build_seconds,
         "ptxas": [ln.strip() for ln in lib.log.splitlines()
                   if "registers" in ln or "spill" in ln or "warning" in ln]}
        for lib in libs
    ]}
    emit(rec, log)
    return rec


# the R101 decoder's sampling shapes: 640x640 at strides 8/16/32
SHAPES = ((80, 80), (40, 40), (20, 20))
HEADS, HD, QUERIES, POINTS, D_MODEL = 8, 32, 300, 4, 256
LP = len(SHAPES) * POINTS
S_TOTAL = sum(h * w for h, w in SHAPES)


def decoder_value(b: int, rows_dtype, rng, dev, s: int = S_TOTAL):
    """Decoder value maps as the model holds them, (B, S, H, hd) in
    `rows_dtype`, standard normal."""
    import torch

    value = torch.from_numpy(
        rng.standard_normal((b, s, HEADS, HD), dtype=np.float32)).to(dev)
    return value.to(rows_dtype)


def bound(value, idx, w, extra_bytes: int, flops: int) -> dict:
    """Least time for a gather-sum over these terms: each value row (b, s, h)
    that some term of (b*h, q) with a non-zero weight samples (idx/w
    (B*H, Q, J)), read once, plus `extra_bytes` (every other input read
    once, the output written once), against `flops` at the fp32 rate."""
    import torch

    b, s, h, hd = value.shape
    bh = b * h
    needed = (idx >= 0) & (idx < s) & (w != 0)
    flat = idx.long() + torch.arange(bh, device=idx.device).view(bh, 1, 1) * s
    rows_needed = touched_count(flat, needed, bh * s)
    nbytes = rows_needed * hd * value.element_size() + extra_bytes
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "rows_needed": rows_needed, "rows_total": bh * s, "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms), "bound_us": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def check_err(name: str, err: float) -> None:
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"{name} vs plain: max abs err {err} > {KERNEL_ATOL}")


def embedding_bag_call(value, idx, w):
    """The library yardstick of the gather-sum: one F.embedding_bag over the
    value's (B*S*H, hd) rows as they lie, its indices (b*S + idx)*H + h
    made beforehand; returns the call and how to bring its (B*H*Q, hd)
    result to the kernel's (B, Q, H, hd)."""
    import torch
    import torch.nn.functional as F

    b, s, h, hd = value.shape
    bh, q, j = idx.shape
    heads = torch.arange(bh, device=idx.device).view(bh, 1, 1)
    flat_idx = (((heads // h) * s + idx.long()) * h + heads % h).reshape(bh * q, j)
    flat_rows = value.reshape(b * s * h, hd)
    bag_w = w.reshape(bh * q, j).to(value.dtype)

    def library():
        return F.embedding_bag(flat_idx, flat_rows, per_sample_weights=bag_w, mode="sum")

    def as_output(out):
        return out.float().reshape(b, h, q, hd).permute(0, 2, 1, 3)

    return library, as_output


def sass_key(kernel: str, precision: str) -> str:
    """`msda_sass()`'s entry for `kernel` in `precision` (the one-pass
    instantiation under "default")."""
    return f"{kernel}_onepass" if precision == "default" else kernel


def msda_case(b: int, rows_dtype, method: str, seed: int, flush, device: str = "cuda",
              precision: str = "highest") -> dict:
    """msda_gather_sum against its plain version at the decoder's shapes, in
    `precision` (the one-pass mode under "default")."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        msda_gather_sum,
        msda_gather_sum_plain,
        prepare_msda_gather,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    value = decoder_value(b, rows_dtype, rng, dev)
    # decoder sampling points: around the reference boxes, a few outside [0, 1]
    loc = torch.from_numpy(
        rng.uniform(-0.05, 1.05, (b, QUERIES, HEADS, LP, 2)).astype(np.float32)).to(dev)
    attn = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, QUERIES, HEADS, LP), dtype=np.float32)).to(dev), dim=-1)
    idx, w = prepare_msda_gather(loc, attn, SHAPES, POINTS, method)
    bh, q, j = idx.shape

    got = msda_gather_sum(value, idx, w, precision)
    want = msda_gather_sum_plain(value, idx, w, precision)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check_err("msda_gather_sum", err)
    # embedding_bag computes the unrounded function: a yardstick of "highest"
    library, as_output = embedding_bag_call(value, idx, w)
    lib_err = (as_output(library()) - want).abs().max().item()
    if precision == "default":
        library = None
    return {
        "phase": "kernel", "kernel": "msda_gather_sum", "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "precision": precision,
        "shape": {"bh": bh, "s": S_TOTAL, "hd": HD, "q": q, "j": j},
        "max_abs_err": err, "atol": KERNEL_ATOL, "library_max_abs_err": lib_err,
        "sass": msda_sass()[sass_key("msda_gather_sum", precision)] if device == "cuda" else None,
        "kernel_ms": cuda_time_ms(lambda: msda_gather_sum(value, idx, w, precision), 30, flush),
        "plain_ms": cuda_time_ms(lambda: msda_gather_sum_plain(value, idx, w, precision), 10,
                                 flush),
        "library_ms": cuda_time_ms(library, 30, flush) if library else None,
        **bound(value, idx, w, idx.numel() * 4 + w.numel() * 4 + got.numel() * 4,
                2 * bh * q * j * HD),
    }


def loc_case(b: int, rows_dtype, method: str, seed: int, flush, device: str = "cuda",
             precision: str = "highest") -> dict:
    """msda_loc_sum (corner prep in the kernel) against its plain version."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        level_tables,
        msda_loc_sum,
        msda_loc_sum_plain,
        prepare_msda_gather,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    value = decoder_value(b, rows_dtype, rng, dev)
    bh = b * HEADS
    # loc (B, Q, H, LP, 2) and attn (B, Q, H, LP), as the model hands them over
    loc = torch.from_numpy(
        rng.uniform(-0.05, 1.05, (b, QUERIES, HEADS, LP, 2)).astype(np.float32)).to(dev)
    attn = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, QUERIES, HEADS, LP), dtype=np.float32)).to(dev), dim=-1)
    tables = level_tables(SHAPES, POINTS, dev, torch.float32)
    args = (value, loc, attn, *tables, method, precision)

    got = msda_loc_sum(*args)
    want = msda_loc_sum_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check_err("msda_loc_sum", err)
    idx, w = prepare_msda_gather(loc, attn, SHAPES, POINTS, method)
    j = idx.shape[2]
    extra = (loc.numel() + attn.numel() + got.numel()) * 4 + 3 * LP * 4
    return {
        "phase": "kernel", "kernel": "msda_loc_sum", "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "precision": precision,
        "shape": {"bh": bh, "s": S_TOTAL, "hd": HD, "q": QUERIES, "lp": LP, "j": j},
        "max_abs_err": err, "atol": KERNEL_ATOL,
        "sass": msda_sass()[sass_key("msda_loc_sum", precision)] if device == "cuda" else None,
        "kernel_ms": cuda_time_ms(lambda: msda_loc_sum(*args), 30, flush),
        "plain_ms": cuda_time_ms(lambda: msda_loc_sum_plain(*args), 10, flush),
        "library_ms": None,  # no one PyTorch call computes this function
        **bound(value, idx, w, extra, 2 * bh * QUERIES * j * HD),
    }


def fused_case(b: int, rows_dtype, method: str, seed: int, flush, device: str = "cuda",
               precision: str = "highest", shapes=SHAPES) -> dict:
    """msda_fused_sum (projections, softmax, locations and corners in the
    kernel) against its plain version, at the level `shapes` (RT-DETR's
    decoder's by default)."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        fused_anchors,
        fused_head_weights,
        fused_prologue_reference,
        level_tables,
        loc_corners,
        msda_fused_sum,
        msda_fused_sum_plain,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    s_total, lp = sum(h * w for h, w in shapes), len(shapes) * POINTS
    value = decoder_value(b, rows_dtype, rng, dev, s_total)
    bh = b * HEADS

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    hs = randn(b, QUERIES, D_MODEL)
    ref = torch.from_numpy(np.concatenate(
        [rng.uniform(0.05, 0.95, (b, QUERIES, 2)), rng.uniform(0.05, 0.5, (b, QUERIES, 2))],
        axis=-1).astype(np.float32)).to(dev)
    heads = fused_head_weights(
        randn(D_MODEL, HEADS * lp * 2, scale=D_MODEL**-0.5), randn(HEADS * lp * 2, scale=0.1),
        randn(D_MODEL, HEADS * lp, scale=D_MODEL**-0.5), randn(HEADS * lp, scale=0.1), HEADS,
    )
    base, scale = fused_anchors(ref, lp, POINTS, 0.5)
    tables = level_tables(shapes, POINTS, dev, torch.float32)
    args = (value, hs, *heads, base, scale, *tables, method, precision)

    got = msda_fused_sum(*args)
    want = msda_fused_sum_plain(*args)
    torch.cuda.synchronize()
    # the plain version sums the prologue in the kernel's order, so the
    # sample locations agree bit for bit and the discrete method's
    # nearest-cell rounding is compared on every row, like the bilinear one
    err = (got - want).abs().max().item()
    check_err("msda_fused_sum", err)
    xy, at = fused_prologue_reference(hs, *heads, base, scale, precision)
    idx, w = loc_corners(xy, at, *tables, method)
    j = idx.shape[2]
    extra = (hs.numel() + sum(t.numel() for t in heads) + base.numel() + scale.numel()
             + got.numel()) * 4 + 3 * lp * 4
    return {
        "phase": "kernel", "kernel": "msda_fused_sum", "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "precision": precision,
        "shape": {"bh": bh, "s": s_total, "hd": HD, "q": QUERIES, "lp": lp, "d": D_MODEL,
                  "j": j},
        "max_abs_err": err, "atol": KERNEL_ATOL,
        "sass": msda_sass()[sass_key("msda_fused_sum", precision)] if device == "cuda" else None,
        "kernel_ms": cuda_time_ms(lambda: msda_fused_sum(*args), 30, flush),
        "plain_ms": cuda_time_ms(lambda: msda_fused_sum_plain(*args), 10, flush),
        "library_ms": None,  # no one PyTorch call computes this function
        **bound(value, idx, w, extra,
                2 * bh * QUERIES * D_MODEL * 3 * lp + 2 * bh * QUERIES * j * HD),
    }


KERNEL_CASES = (msda_case, loc_case, fused_case)

# Deformable-DETR at the JAX package's static DETR bucket, 1333x1333: ResNet-50
# at strides 8/16/32 plus the extra stride-64 level, 37,150 tokens; 8 heads of
# 32, 4 points a level, 300 decoder queries
DDETR_SHAPES = ((167, 167), (84, 84), (42, 42), (21, 21))
DDETR_TOKENS = sum(h * w for h, w in DDETR_SHAPES)
# (label, level shapes, queries, levels run, encoder-like sampling): the
# RT-DETR decoder, the Deformable-DETR encoder (its densest level alone, and
# all four as the op runs them) and decoder
MSDA_OP_SHAPES = {
    "rtdetr_decoder": (SHAPES, QUERIES, (0, 1, 2), False),
    "ddetr_encoder_level0": (DDETR_SHAPES, DDETR_TOKENS, (0,), True),
    "ddetr_encoder": (DDETR_SHAPES, DDETR_TOKENS, (0, 1, 2, 3), True),
    "ddetr_decoder": (DDETR_SHAPES, QUERIES, (0, 1, 2, 3), False),
}
# Deformable-DETR at a ragged canvas (engine/scheduler.py): (768, 1333), the
# snapped canvas of a 2:1 panorama, whose levels are not square and two of
# them odd (167 and 21 wide), 21,324 tokens against the bucket's 37,150
RAGGED_OP_CANVAS = (768, 1333)


def ddetr_levels(hw) -> tuple:
    """Deformable-DETR's four level shapes at an (H, W) canvas: ResNet-50's
    strides 8, 16 and 32 and the extra stride-64 level, each a stride-2
    convolution that rounds up."""
    h, w, out = hw[0], hw[1], []
    for step in range(6):
        h, w = -(-h // 2), -(-w // 2)
        if step >= 2:
            out.append((h, w))
    return tuple(out)


RAGGED_DDETR_SHAPES = ddetr_levels(RAGGED_OP_CANVAS)
RAGGED_OP_SHAPES = {
    "ddetr_encoder_ragged": (RAGGED_DDETR_SHAPES, sum(h * w for h, w in RAGGED_DDETR_SHAPES),
                             (0, 1, 2, 3), True),
    "ddetr_decoder_ragged": (RAGGED_DDETR_SHAPES, QUERIES, (0, 1, 2, 3), False),
}


def op_shapes(label: str) -> tuple:
    """(level shapes, queries, levels run, encoder-like) of an MSDA op case."""
    return MSDA_OP_SHAPES[label] if label in MSDA_OP_SHAPES else RAGGED_OP_SHAPES[label]


def msda_samples(b: int, q: int, shapes, seed: int, dev, encoder: bool):
    """One MSDA op's sample points (B, Q, H, LP, 2) and softmaxed attention
    (B, Q, H, LP): each query samples around its reference point, in the
    encoder its own token's cell centre (tokens level-major, row-major), in
    the decoder a random point, with offsets N(0, 0.02^2) (encoder) or
    N(0, 0.05^2) (decoder), so a few land outside [0, 1]."""
    import torch

    from spotter_tpu_torch.models.deformable_detr import encoder_reference_base

    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = len(shapes) * POINTS
    if encoder:
        ref = torch.from_numpy(encoder_reference_base(shapes)).to(dev)[None, :, None, None, :]
        sigma = 0.02
    else:
        ref = torch.rand((b, q, 1, 1, 2), generator=gen, device=dev) * 0.9 + 0.05
        sigma = 0.05
    loc = ref + sigma * torch.randn((b, q, HEADS, lp, 2), generator=gen, device=dev)
    attn = torch.softmax(torch.randn((b, q, HEADS, lp), generator=gen, device=dev), dim=-1)
    return loc, attn


def msda_value(b: int, s: int, rows_dtype, seed: int, dev):
    """(B, S, H, hd) standard-normal value maps in `rows_dtype`."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randn((b, s, HEADS, HD), generator=gen, device=dev).to(rows_dtype)


def touched_count(flat, valid, size: int) -> int:
    """Distinct entries of `flat` (indices into a table of `size`) where `valid`."""
    import torch

    hit = torch.zeros(size, dtype=torch.bool, device=flat.device)
    hit[flat[valid]] = True
    return int(hit.sum().item())


def sep_work(ops, mask, hw, r_band) -> tuple[int, int]:
    """(terms, value rows) this level's operands need: corners with a
    non-zero weight inside the level and inside a band whose bit is set, and
    the distinct (b*h, row) they read."""
    import torch

    lh, lw = hw
    bh, n_qt, n_bands = mask.shape
    xi, xw0, xw1, yi, yw0, yw1 = (o.reshape(bh, n_qt, -1) for o in ops)
    band_on = mask.ne(0)
    base = torch.arange(bh, device=mask.device).view(bh, 1, 1) * (lh * lw)
    terms, flats, valids = 0, [], []
    for dy, yw in ((0, yw0), (1, yw1)):
        y = yi.long() + dy
        band = torch.div(y, r_band, rounding_mode="floor").clamp(0, n_bands - 1)
        row_on = (y >= 0) & (y < lh) & (yw != 0) & torch.gather(band_on, 2, band)
        for dx, xw in ((0, xw0), (1, xw1)):
            x = xi.long() + dx
            valid = row_on & (x >= 0) & (x < lw) & (xw != 0)
            terms += int(valid.sum().item())
            flats.append(base + y.clamp(0, lh - 1) * lw + x.clamp(0, lw - 1))
            valids.append(valid)
    rows = touched_count(torch.stack(flats), torch.stack(valids), bh * lh * lw)
    return terms, rows


def sep_case(label: str, b: int, rows_dtype, method: str, seed: int, flush,
             cleared: bool = False, device: str = "cuda", precision: str = "highest") -> dict:
    """msda_sep_sum against its plain version on one MSDA op's levels, each
    level's operands built as the model builds them; `cleared` clears half
    the hit table's bits at random (the kernel must drop exactly those
    bands, as its plain version does)."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        level_offsets,
        msda_sep_reference,
        msda_sep_sum,
        sep_level_operands,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    shapes, q, levels, encoder = op_shapes(label)
    dev = torch.device(device)
    s = sum(h * w for h, w in shapes)
    loc, attn = msda_samples(b, q, shapes, seed, dev, encoder)
    value = msda_value(b, s, rows_dtype, seed, dev)
    rows_all = value.permute(0, 2, 1, 3).reshape(b * HEADS, s, HD)
    offs = level_offsets(shapes)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    calls, full_masks = [], []
    for lvl in levels:
        lh, lw = shapes[lvl]
        pts = slice(lvl * POINTS, (lvl + 1) * POINTS)
        ops, mask, r_band = sep_level_operands(loc[:, :, :, pts], attn[:, :, :, pts], lh, lw,
                                               method)
        full_masks.append(mask)
        if cleared:
            mask = mask * (torch.rand(mask.shape, generator=gen, device=dev) < 0.5).to(mask.dtype)
        rows_l = rows_all[:, offs[lvl]:offs[lvl] + lh * lw].contiguous()
        calls.append((rows_l, *ops, mask, (lh, lw), r_band, POINTS, precision))
    del loc, attn, value, rows_all

    err, dropped = 0.0, 0.0
    for args, full in zip(calls, full_masks):
        got = msda_sep_sum(*args)
        want = msda_sep_reference(*args)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        if cleared:  # what the cleared bits took away: zero would test nothing
            unmasked = msda_sep_reference(*args[:7], full, *args[8:])
            dropped = max(dropped, (unmasked - want).abs().max().item())
        del got, want
    check_err(f"msda_sep_sum ({label})", err)
    if cleared and not dropped > KERNEL_ATOL:
        raise AssertionError(f"msda_sep_sum ({label}): clearing hit-table bits changed nothing")
    nbytes, terms = 0, 0
    for args in calls:
        rows_l, ops, mask = args[0], args[1:7], args[7]
        t, rows = sep_work(ops, mask, args[8], args[9])
        terms += t
        nbytes += (sum(o.numel() * 4 for o in ops) + mask.numel() * 4
                   + rows * HD * rows_l.element_size()
                   + b * HEADS * mask.shape[1] * 64 * HD * 4)
    flops = 3 * terms * HD  # x-weight product, y-weight FMA
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    big = label.startswith("ddetr_encoder")
    rec = {
        "phase": "kernel", "kernel": "msda_sep_sum", "case": label, "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "precision": precision, "cleared_mask_bits": cleared,
        "shape": {"bh": b * HEADS, "levels": [shapes[i] for i in levels], "hd": HD, "q": q,
                  "points": POINTS, "launches_per_op": len(levels)},
        "max_abs_err": err, "atol": KERNEL_ATOL,
        "cleared_bits_change_max": dropped if cleared else None,
        "kernel_ms": cuda_time_ms(lambda: [msda_sep_sum(*a) for a in calls], 10 if big else 30,
                                  flush),
        "plain_ms": cuda_time_ms(lambda: [msda_sep_reference(*a) for a in calls], 3 if big else 10,
                                 flush),
        "library_ms": None,  # no one PyTorch call computes this function
        "terms": terms, "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms), "bound_us": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    rec["kernel_ms_per_launch"] = rec["kernel_ms"] / len(calls)  # one launch a level
    del calls
    torch.cuda.empty_cache()
    return rec


def hd_gather_case(label: str, b: int, rows_dtype, method: str, seed: int, flush,
                   device: str = "cuda") -> dict:
    """msda_hd_gather_sum against its plain version on one MSDA op: the
    value (B, S, H, hd) as the model holds it, the lane prep's idx/w
    (B, H, 4, LP*Q), out (B, Q, H, hd)."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        msda_hd_gather_reference,
        msda_hd_gather_sum,
        prepare_msda_gather_lanes,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    shapes, q, _, encoder = op_shapes(label)
    dev = torch.device(device)
    s = sum(h * w for h, w in shapes)
    lp = len(shapes) * POINTS
    loc, attn = msda_samples(b, q, shapes, seed, dev, encoder)
    idx, w = prepare_msda_gather_lanes(loc, attn, shapes, POINTS, method)
    value = msda_value(b, s, rows_dtype, seed, dev)
    del loc, attn
    got = msda_hd_gather_sum(value, idx, w, lp, q)
    want = msda_hd_gather_reference(value, idx, w, lp, q)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # fp32: KERNEL_ATOL (both sum in one order with no contraction, so they
    # are expected equal bit for bit). bf16 sums in bf16 on both sides, in
    # one order: one bf16 ulp of the largest output allows for a rounding on
    # either side of a tie
    atol = KERNEL_ATOL if rows_dtype == torch.float32 else 2.0**-7 * want.float().abs().max().item()
    bit_equal = bool(torch.equal(got, want))
    del want
    if not err <= atol:
        raise AssertionError(f"msda_hd_gather_sum ({label}) vs plain: max abs err {err} > {atol}")
    live = w != 0
    terms = int(live.sum().item())
    bh_base = torch.arange(b * HEADS, device=dev).view(b, HEADS, 1, 1) * s
    touched = touched_count(idx.long() + bh_base, live, b * HEADS * s)
    nbytes = (idx.numel() + w.numel()) * 4 + (touched * HD + got.numel()) * value.element_size()
    flops = 2 * terms * HD
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    big = label.startswith("ddetr_encoder")
    rec = {
        "phase": "kernel", "kernel": "msda_hd_gather_sum", "case": label, "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "shape": {"b": b, "h": HEADS, "hd": HD, "s": s, "q": q, "lp": lp},
        "max_abs_err": err, "atol": atol, "bit_equal": bit_equal,
        "sass": msda_sass()["msda_hd_gather_sum"] if device == "cuda" else None,
        "kernel_ms": cuda_time_ms(lambda: msda_hd_gather_sum(value, idx, w, lp, q),
                                  10 if big else 30, flush),
        "plain_ms": cuda_time_ms(lambda: msda_hd_gather_reference(value, idx, w, lp, q),
                                 3 if big else 10, flush),
        "library_ms": None,  # no one PyTorch call computes this function in this layout
        "terms": terms, "value_elements_touched": touched * HD, "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms), "bound_us": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    del value, idx, w, got, live
    torch.cuda.empty_cache()
    return rec


WALK_PLAIN_CHUNK = 4096  # queries a plain-version call takes at a Deformable-DETR op


def walk_op_case(label: str, b: int, rows_dtype, method: str, seed: int, flush,
                 kernel: str = "msda_gather_sum", device: str = "cuda",
                 precision: str = "highest") -> dict:
    """msda_gather_sum or msda_loc_sum against its plain version on one
    Deformable-DETR MSDA op (`MSDA_OP_SHAPES`): the value (B, S, H, hd), loc
    (B, Q, H, LP, 2) and attn (B, Q, H, LP) as the model holds them, the
    gather-sum's idx/w (B*H, Q, J) from the corner prep. The plain version
    runs over WALK_PLAIN_CHUNK queries at a time (its per-term gather would
    take ~20 GB at the encoder's size in one call); the bound counts the
    value rows touched, every other input once and the output once, and the
    live terms' FMAs."""
    import torch

    from spotter_tpu_torch.ops.msda import (
        level_tables,
        msda_gather_sum,
        msda_gather_sum_plain,
        msda_loc_sum,
        msda_loc_sum_plain,
        prepare_msda_gather,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    shapes, q, _, encoder = op_shapes(label)
    dev = torch.device(device)
    s = sum(h * w for h, w in shapes)
    lp = len(shapes) * POINTS
    loc, attn = msda_samples(b, q, shapes, seed, dev, encoder)
    value = msda_value(b, s, rows_dtype, seed, dev)
    idx, w = prepare_msda_gather(loc, attn, shapes, POINTS, method)
    tables = level_tables(shapes, POINTS, dev, torch.float32)
    if kernel == "msda_gather_sum":
        def run():
            return msda_gather_sum(value, idx, w, precision)

        def plain_part(a, z):
            return msda_gather_sum_plain(value, idx[:, a:z], w[:, a:z], precision)

        inputs_bytes = (idx.numel() + w.numel()) * 4
    else:
        def run():
            return msda_loc_sum(value, loc, attn, *tables, method, precision)

        def plain_part(a, z):
            return msda_loc_sum_plain(value, loc[:, a:z], attn[:, a:z], *tables, method,
                                      precision)

        inputs_bytes = (loc.numel() + attn.numel()) * 4 + 3 * lp * 4

    def plain():
        return torch.cat([plain_part(a, min(a + WALK_PLAIN_CHUNK, q))
                          for a in range(0, q, WALK_PLAIN_CHUNK)], dim=1)

    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check_err(f"{kernel} ({label})", err)
    big = label.startswith("ddetr_encoder")
    library = None
    rec = {
        "phase": "kernel", "kernel": kernel, "case": label, "batch": b,
        "rows_dtype": str(rows_dtype).removeprefix("torch."), "method": method,
        "precision": precision,
        "shape": {"b": b, "h": HEADS, "hd": HD, "s": s, "q": q, "lp": lp, "j": idx.shape[2]},
        "max_abs_err": err, "atol": KERNEL_ATOL,
    }
    if kernel == "msda_gather_sum" and precision == "highest":
        library, as_output = embedding_bag_call(value, idx, w)
        rec["library_max_abs_err"] = (as_output(library()) - want).abs().max().item()
    del want
    live = (idx >= 0) & (idx < s) & (w != 0)
    terms = int(live.sum().item())
    rec.update({
        "kernel_ms": cuda_time_ms(run, 10 if big else 30, flush),
        "plain_ms": cuda_time_ms(plain, 3 if big else 10, flush),
        "library_ms": cuda_time_ms(library, 10 if big else 30, flush) if library else None,
        "terms": terms,
        **bound(value, idx, w, inputs_bytes + got.numel() * 4, 2 * terms * HD),
    })
    del value, idx, w, loc, attn, got, live, library
    torch.cuda.empty_cache()
    return rec


# the redesigned MSDA kernels' fp32 instantiations (vector path), "highest"
# and one-pass, by the library that holds them and a tag of their mangled
# names (template <float, kVec = true, kOnePass>)
MSDA_SASS_KERNELS = {
    **{name: ("msda", f"{name}_kernelIfLb1ELb0E")
       for name in ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum")},
    **{f"{name}_onepass": ("msda", f"{name}_kernelIfLb1ELb1E")
       for name in ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum")},
    "msda_hd_gather_sum": ("msda_backends", "msda_hd_gather_sum_kernelIfLb1E"),
}
# the kernels whose fp32 value rows must move 128 bits a load, in both modes
MSDA_WIDE_LOADS = ("msda_gather_sum", "msda_loc_sum", "msda_hd_gather_sum",
                   "msda_gather_sum_onepass", "msda_loc_sum_onepass")


@functools.cache
def msda_sass() -> dict:
    """Instructions, global loads and 128-bit global loads (LDG.E.128) in the
    SASS of the redesigned MSDA kernels (fp32 rows, vector path): the
    gather-sum, loc and lane-gather kernels, and the one-pass gather-sum and
    loc, must load their value rows 128 bits at a time. Read once a run."""
    from spotter_tpu_torch.ops.msda import build_msda_backends_kernel, build_msda_kernel
    from spotter_tpu_torch.utils.cuda_build import disassemble, sass_functions

    builds = {"msda": build_msda_kernel, "msda_backends": build_msda_backends_kernel}
    counts = {}
    for name, (library, tag) in MSDA_SASS_KERNELS.items():
        bodies = [b for fn, b in sass_functions(disassemble(builds[library]().path)).items()
                  if tag in fn]
        if len(bodies) != 1:
            raise AssertionError(f"{name}: {len(bodies)} SASS functions match {tag}")
        ops = [ln.split()[1] if ln.startswith("@") else ln.split()[0] for ln in bodies[0]]
        counts[name] = {"instructions": len(ops), "LDG": sum(op.startswith("LDG") for op in ops),
                        "LDG.E.128": sum(op.startswith("LDG.E.128") for op in ops)}
    narrow = [name for name in MSDA_WIDE_LOADS if not counts[name]["LDG.E.128"]]
    if narrow:
        raise AssertionError(f"{narrow}: fp32 SASS has no 128-bit global load: {counts}")
    return counts


# (kernel case, label, rows dtype, method, cleared hit-table bits)
def backend_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for label in MSDA_OP_SHAPES:
        for method in ("default", "discrete"):
            cases.append((sep_case, label, f32, method, False))
            if label != "ddetr_encoder_level0":
                cases.append((hd_gather_case, label, f32, method, False))
            if label in ("ddetr_encoder", "ddetr_decoder"):  # rows 1 and 2 at Deformable-DETR
                cases += [(functools.partial(walk_op_case, kernel=k), label, f32, method, False)
                          for k in ("msda_gather_sum", "msda_loc_sum")]
    cases += [(sep_case, "ddetr_encoder", f32, m, True) for m in ("default", "discrete")]
    cases += [(sep_case, "rtdetr_decoder", bf16, "default", False),
              (hd_gather_case, "rtdetr_decoder", bf16, "default", False)]
    return cases


# the one-pass ("default") mode of rows 1-4, at B = 8 with fp32 and bf16
# rows: rows 1-3 at RT-DETR's decoder op, rows 1, 2 and 4 at the
# Deformable-DETR encoder op, row 4 also at RT-DETR's decoder op
def one_pass_cases():
    import torch

    cases = []
    for rows_dtype in (torch.float32, torch.bfloat16):
        cases += [(functools.partial(case, precision="default"), None, rows_dtype)
                  for case in KERNEL_CASES]
        cases += [(functools.partial(walk_op_case, kernel=k, precision="default"),
                   "ddetr_encoder", rows_dtype) for k in ("msda_gather_sum", "msda_loc_sum")]
        cases += [(functools.partial(sep_case, precision="default"), label, rows_dtype)
                  for label in ("ddetr_encoder", "rtdetr_decoder")]
    return cases

# (B, S, H, hd): yolos-base (S = 1 + 50*84 + 100 = 4301, 12 heads of 64) at
# B = 1 and 8; a sequence just past the cutover that is a multiple of no
# tile (1100); hd = 128 at the JAX splash test's shape and at yolos-base width
ATTN_SHAPES = ((1, 4301, 12, 64), (8, 4301, 12, 64), (1, 1100, 12, 64), (8, 1100, 12, 64),
               (1, 1100, 2, 128), (8, 4301, 6, 128))
ATTN_MAIN_SHAPE = (8, 4301, 12, 64)


def attention_case(dtype, shape, seed: int, flush, device: str = "cuda") -> dict:
    """flash_attn_fp32 / _bf16 against the plain version, with SDPA's time
    at the same shape as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from spotter_tpu_torch.ops.attention import (
        flash_attn_bf16,
        flash_attn_fp32,
        self_attention_reference,
        split_kv_reference,
        split_kv_tf32,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    b, s, h, hd = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    # q pre-scaled and drawn twice as wide as hd**-0.5, so the scores spread
    # over ~N(0, 4) and the running max of the online softmax does real work
    q = (torch.randn(shape, generator=gen, device=device) * (2 * hd**-0.5)).to(dtype)
    k = torch.randn(shape, generator=gen, device=device).to(dtype)
    v = torch.randn(shape, generator=gen, device=device).to(dtype)
    wrapper = flash_attn_fp32 if dtype == torch.float32 else flash_attn_bf16
    name = wrapper.__name__
    fp32 = wrapper is flash_attn_fp32

    split_before = split_kv_tf32.launches
    got = wrapper(q, k, v)
    split_per_call = split_kv_tf32.launches - split_before
    want = self_attention_reference(q.float(), k.float(), v.float()).to(dtype).float()
    torch.cuda.synchronize()
    dname = str(dtype).removeprefix("torch.")
    err = (got.float() - want).abs().max().item()
    atol = ATTN_RTOL[dname] * want.abs().max().item()
    plain_err = (self_attention_reference(q, k, v).float() - want).abs().max().item()
    del want

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=1.0)

    lib_err = (library().transpose(1, 2).float() - got.float()).abs().max().item()
    sass = None
    if device == "cuda":
        tag = "flash_attn_tf32_kernel" if fp32 else "flash_attn_bf16_kernel"
        sass = {fn: c for fn, c in attention_sass().items() if tag in fn}
    flops = 4 * b * h * s * s * hd
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read once, out written once
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS) * 1e3
    if not err <= atol:
        raise AssertionError(f"{name} vs plain at {shape}: max abs err {err} > {atol}")
    split = None
    if fp32:  # the K/V split pass: bit for bit against its plain version, and alone
        terms, want_terms = split_kv_tf32(k, v), split_kv_reference(k, v)
        exact = all(torch.equal(a, w) for a, w in zip(terms, want_terms))
        del terms, want_terms
        if device == "cuda" and not (exact and split_per_call == 1):
            raise AssertionError(f"split_kv_tf32 at {shape}: equal to its plain version: "
                                 f"{exact}, launches a call {split_per_call}")
        split = {"exact": exact, "launches_per_call": split_per_call,
                 "ms": cuda_time_ms(lambda: split_kv_tf32(k, v), 10 if b == 8 else 30, flush),
                 "plain_ms": cuda_time_ms(lambda: split_kv_reference(k, v), 5, flush)}
        # the operations bound of the split-TF32 design, and the one of the
        # CUDA-core fp32 design it replaced
        cuda_core_ms = ops_ms
        ops_ms = SPLIT_TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    rec = {
        "phase": "kernel", "kernel": name, "batch": b, "dtype": dname,
        "shape": {"b": b, "s": s, "h": h, "hd": hd},
        "max_abs_err": err, "atol": atol, "rtol_of_max_out": ATTN_RTOL[dname],
        "plain_in_dtype_max_abs_err": plain_err, "library_max_abs_err": lib_err,
        "sass": sass,
        "kernel_ms": cuda_time_ms(lambda: wrapper(q, k, v), 10 if b == 8 else 30, flush),
        "plain_ms": cuda_time_ms(lambda: self_attention_reference(q, k, v), 5, flush),
        "library_ms": cuda_time_ms(library, 10 if b == 8 else 30, flush),
        "bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if fp32:
        rec["bound_name"] = (f"split TF32: {SPLIT_TF32_PASSES} passes of the FLOPs at "
                             f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s")
        rec["bound_cuda_cores_ms"] = max(bytes_ms, cuda_core_ms)
        rec["split_pass"] = split
    rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
    torch.cuda.empty_cache()  # the plain version's (B, H, S, S) scores
    return rec


ATTN_KERNELS = ("flash_attn_bf16_kernel", "flash_attn_tf32_kernel")


@functools.cache
def attention_sass() -> dict:
    """Opcode counts of both attention kernels' SASS (bf16, and fp32's split
    TF32), per head width: each must issue wgmma (HGMMA) and TMA loads
    (UTMALDG), and no mma.sync (HMMA). Read once a run."""
    from spotter_tpu_torch.ops.attention import HEAD_DIMS, build_attention_kernel
    from spotter_tpu_torch.utils.cuda_build import disassemble, sass_functions

    counts = {}
    for name, body in sass_functions(disassemble(build_attention_kernel().path)).items():
        if any(kernel in name for kernel in ATTN_KERNELS):
            ops = [line.split()[1] if line.startswith("@") else line.split()[0] for line in body]
            counts[name] = {kind: sum(op.startswith(kind) for op in ops)
                            for kind in ("HGMMA", "HMMA", "UTMALDG")}
    if len(counts) != len(ATTN_KERNELS) * len(HEAD_DIMS) or not all(
            c["HGMMA"] and c["UTMALDG"] and not c["HMMA"] for c in counts.values()):
        raise AssertionError(f"the attention kernels' SASS is not the wgmma + TMA design: {counts}")
    return counts


# (B, P, Q, masked slots): OWLv2 (960/16 = 60x60 patches) and OWL-ViT B/32
# (768/32 = 24x24), at B = 1 and 8, against the 22-label default
# vocabulary, a request's query set padded to 24 with 2 slots masked, and a
# vocabulary of 160 (5 tiles of 32 queries); the text width Dt is 512
OWL_TEXT_WIDTH = 512
CLASS_LOGITS_SHAPES = tuple((b, p, q, m) for p in (3600, 576) for b in (1, 8)
                            for q, m in ((22, 0), (24, 2), (160, 0)))
CLASS_LOGITS_MAIN = (8, 3600, 22, 0, "float32")
CLASS_LOGITS_MAIN_BF16 = (8, 3600, 22, 0, "bfloat16")  # the "mixed" policy's head


def class_logits_case(shape, img_dtype, seed: int, flush, device: str = "cuda") -> dict:
    """owl_class_logits against its plain version on the same inputs."""
    import torch

    from spotter_tpu_torch.ops.openvocab import (
        NEG_INF,
        class_logits_reference,
        owl_class_logits,
    )
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    b, p, q, n_masked = shape
    dt = OWL_TEXT_WIDTH
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn((b, p, dt), generator=gen, device=device).to(img_dtype)
    bank = torch.randn((q, dt), generator=gen, device=device)
    bank = bank / bank.norm(dim=-1, keepdim=True)
    shift = torch.randn((b, p), generator=gen, device=device)
    scale = torch.randn((b, p), generator=gen, device=device)
    mask = None
    if n_masked:
        mask = torch.ones(q, dtype=torch.int32, device=device)
        mask[q - n_masked:] = 0
    args = (img, bank, shift, scale, mask)

    got = owl_class_logits(*args)
    want = class_logits_reference(*args)
    torch.cuda.synchronize()
    real = slice(0, q - n_masked)
    err = (got[..., real] - want[..., real]).abs().max().item()
    atol = CLASS_LOGITS_RTOL * want[..., real].abs().max().item()
    masked_exact = bool((got[..., q - n_masked:] == NEG_INF).all()) if n_masked else True
    dname = str(img_dtype).removeprefix("torch.")
    if not (err <= atol and masked_exact):
        raise AssertionError(f"owl_class_logits vs plain at {shape} {dname}: max abs err "
                             f"{err} (atol {atol}), masked columns NEG_INF: {masked_exact}")
    # img read once, the bank, shift, scale and mask once, the logits written once
    nbytes = (img.numel() * img.element_size() + bank.numel() * 4 + 2 * b * p * 4
              + (q * 4 if n_masked else 0) + got.numel() * 4)
    # Operations, each at the rate of the unit that does it: the product on
    # the tensor cores as split TF32 (fp32 img: hi.hi + hi.lo + lo.hi; bf16
    # img is exact in TF32, so its hi and the bank's two terms), the norms
    # and the epilogue on the fp32 cores. The units run side by side, so the
    # operations take at least the longer of the two.
    product_flops = 2 * b * p * q * dt
    tf32_passes = SPLIT_TF32_PASSES if img_dtype == torch.float32 else 2
    fp32_flops = 2 * b * p * dt + 3 * b * p * q  # norms, epilogue
    flops = product_flops + fp32_flops
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(tf32_passes * product_flops / PEAK_TF32_FLOPS,
                 fp32_flops / PEAK_FP32_FLOPS) * 1e3
    return {
        "phase": "kernel", "kernel": "owl_class_logits", "batch": b, "img_dtype": dname,
        "shape": {"b": b, "p": p, "dt": dt, "q": q, "masked": n_masked},
        "max_abs_err": err, "atol": atol, "rtol_of_max_logit": CLASS_LOGITS_RTOL,
        "masked_columns_neg_inf": masked_exact,
        "kernel_ms": cuda_time_ms(lambda: owl_class_logits(*args), 30, flush),
        "plain_ms": cuda_time_ms(lambda: class_logits_reference(*args), 30, flush),
        "library_ms": None,  # no one PyTorch call computes this function
        "bytes": nbytes, "flops": flops, "tf32_passes": tf32_passes,
        "bound_ms": max(bytes_ms, ops_ms), "bound_us": max(bytes_ms, ops_ms) * 1e3,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


@functools.cache
def class_logits_sass() -> dict:
    """Opcode counts of every class-logit kernel instantiation's SASS (fp32
    and bf16 img, each query-tile width): each must issue wgmma (HGMMA) and
    TMA loads (UTMALDG), and no mma.sync (HMMA). Read once a run."""
    from spotter_tpu_torch.ops.openvocab import build_class_logits_kernel
    from spotter_tpu_torch.utils.cuda_build import disassemble, sass_functions

    counts = {}
    for name, body in sass_functions(disassemble(build_class_logits_kernel().path)).items():
        if "class_logits_kernel" in name:
            ops = [line.split()[1] if line.startswith("@") else line.split()[0] for line in body]
            counts[name] = {kind: sum(op.startswith(kind) for op in ops)
                            for kind in ("HGMMA", "HMMA", "UTMALDG")}
    return counts


def check_class_logits_design() -> dict:
    """owl_class_logits is the TMA-fed split-TF32 wgmma design: all eight
    instantiations (2 img dtypes x 4 query-tile widths) show HGMMA and
    UTMALDG and no HMMA."""
    counts = class_logits_sass()
    if len(counts) != 8 or not all(
            c["HGMMA"] and c["UTMALDG"] and not c["HMMA"] for c in counts.values()):
        raise AssertionError(f"the class-logit kernel's SASS is not the wgmma + TMA design: "
                             f"{counts}")
    return counts


def kernel_counters():
    from spotter_tpu_torch.ops import attention, int8, msda, openvocab
    from spotter_tpu_torch.tools import bench_int8, bench_pack_probe, profile_r101

    return {"msda_gather_sum": msda.msda_gather_sum, "msda_loc_sum": msda.msda_loc_sum,
            "msda_fused_sum": msda.msda_fused_sum, "msda_sep_sum": msda.msda_sep_sum,
            "msda_hd_gather_sum": msda.msda_hd_gather_sum,
            "flash_attn_fp32": attention.flash_attn_fp32,
            "split_kv_tf32": attention.split_kv_tf32,
            "flash_attn_bf16": attention.flash_attn_bf16,
            "owl_class_logits": openvocab.owl_class_logits,
            "int8_gemm": bench_int8.int8_gemm, "pack_tile": bench_pack_probe.pack_tile,
            "launch_probe": profile_r101.launch_probe,
            "amax_s8": int8.amax_s8, "quantize_s8": int8.quantize_s8,
            "quantize_nhwc_s8": int8.quantize_nhwc_s8,
            "int8_gemm_kmajor": int8.int8_gemm_kmajor, "dequant_s32": int8.dequant_s32,
            "conv_s8": int8.conv_s8}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def phase_kernel(log: list, seed: int) -> list:
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    # every kernel of a served path; the probes' and the int8 path's kernels
    # run in their own phases
    probes = {kernel for kernel, *_ in PROBE_TOOLS} | set(INT8_KERNELS)
    counters = {n: fn for n, fn in kernel_counters().items() if n not in probes}
    before = {name: fn.launches for name, fn in counters.items()}
    cases = []
    for case in KERNEL_CASES:
        for b in (1, 8):
            for rows_dtype in (torch.float32, torch.bfloat16):
                for method in ("default", "discrete"):
                    rec = case(b, rows_dtype, method, seed, flush)
                    emit(rec, log)
                    cases.append(rec)
    for case, label, rows_dtype, method, cleared in backend_cases():
        kw = {"cleared": cleared} if case is sep_case else {}
        rec = case(label, 8, rows_dtype, method, seed, flush, **kw)
        emit(rec, log)
        cases.append(rec)
    for case, label, rows_dtype in one_pass_cases():
        args = (8, rows_dtype, "default", seed, flush)
        rec = case(*args) if label is None else case(label, *args)
        emit(rec, log)
        cases.append(rec)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ATTN_SHAPES:
            rec = attention_case(dtype, shape, seed, flush)
            emit(rec, log)
            cases.append(rec)
    for img_dtype in (torch.float32, torch.bfloat16):
        for shape in CLASS_LOGITS_SHAPES:
            rec = class_logits_case(shape, img_dtype, seed, flush)
            emit(rec, log)
            cases.append(rec)
    emit({"phase": "kernel", "kernel": "owl_class_logits", "part": "sass",
          "counts": check_class_logits_design()}, log)
    idle = [name for name, fn in counters.items() if fn.launches == before[name]]
    if idle:
        raise AssertionError(f"the kernel phase never launched {idle}")
    return cases


def canonical(out: dict, i: int = 0):
    """Order image i's queries by the source position each was selected
    from: the decoder is permutation-equivariant over queries, so two runs
    whose top-k picks near-equal scores in another order still compare."""
    import torch

    index = out["enc_topk_index"][i].cpu()
    order = torch.argsort(index)
    return index[order], out["logits"][i].cpu()[order], out["pred_boxes"][i].cpu()[order]


def parity_record(ref: dict, got: dict, b: int) -> dict:
    """Max abs differences of two forwards' logits and boxes, per image
    canonicalised by selected source index; whether every image selected
    the same queries."""
    import torch

    same, d_logits, d_boxes = True, 0.0, 0.0
    for i in range(b):
        r_idx, r_logits, r_boxes = canonical(ref, i)
        g_idx, g_logits, g_boxes = canonical(got, i)
        same = same and bool(torch.equal(r_idx, g_idx))
        if r_idx.shape == g_idx.shape:
            d_logits = max(d_logits, (g_logits - r_logits).abs().max().item())
            d_boxes = max(d_boxes, (g_boxes - r_boxes).abs().max().item())
    return {"same_query_selection": same, "logits_max_abs_err": d_logits,
            "boxes_max_abs_err": d_boxes}


def check_parity(rec: dict, what: str) -> None:
    if not rec["same_query_selection"]:
        raise AssertionError(f"{what}: the two forwards selected different query sets")
    if not (rec["logits_max_abs_err"] <= PARITY_ATOL_LOGITS
            and rec["boxes_max_abs_err"] <= PARITY_ATOL_BOXES):
        raise AssertionError(f"{what}: outside tolerance: {rec}")


# the MSDA kernel each SPOTTER_TPU_MSDA_PREP setting runs
PREP_KERNEL = {"xla": "msda_gather_sum", "kernel": "msda_loc_sum", "fused": "msda_fused_sum"}
# the kernel each opt-in SPOTTER_TPU_MSDA backend runs, whatever the prep
BACKEND_KERNEL = {"pallas_sep": "msda_sep_sum", "pallas_gather": "msda_hd_gather_sum"}


def backend_launches(backend: str, levels: int) -> int:
    """Launches per MSDA op: the separable kernel runs once per level."""
    return levels if backend == "pallas_sep" else 1


def phase_parity(log: list, seed: int, built, device: str = "cuda") -> list:
    """The full-width forward, card against CPU at B = 1 under each MSDA prep
    setting, and card `fused` against card `xla` at B = 8."""
    import copy

    import torch

    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.ops.preprocess import device_rescale_normalize, resize_uint8
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    spec = built.preprocess_spec
    layers = built.module.config.decoder_layers
    rng = np.random.default_rng(seed + 1)
    imgs = [resize_uint8(synthetic_photo(rng, 720, 960), spec.size) for _ in range(8)]
    x8 = device_rescale_normalize(torch.from_numpy(np.stack(imgs)), spec)
    x = x8[:1]
    cpu_model = copy.deepcopy(built.module).to("cpu").eval()
    gpu_model = copy.deepcopy(built.module).to(device).eval()
    records = []
    try:
        for prep in msda.MSDA_PREP_VALUES:
            msda.MSDA_PREP = prep
            with torch.inference_mode():
                t0 = time.perf_counter()
                ref = cpu_model(x)
                cpu_s = time.perf_counter() - t0
                reset_counts()
                got = gpu_model(x.to(device))
                torch.cuda.synchronize()
            card_launches = read_counts()
            if not (torch.isfinite(got["logits"]).all() and torch.isfinite(got["pred_boxes"]).all()):
                raise AssertionError(f"non-finite outputs on the card under {prep}")
            rec = {
                "phase": "parity", "model": MODEL_NAME, "msda_prep": prep, "batch": 1,
                "compare": "card vs cpu",
                "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
                **parity_record(ref, got, 1),
                "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
                "logits_abs_max": ref["logits"].abs().max().item(),
                "cpu_forward_s": cpu_s, "card_launches": card_launches,
            }
            emit(rec, log)
            records.append(rec)
            check_parity(rec, f"card vs CPU under {prep}")
            check_launches(card_launches, PREP_KERNEL[prep], layers,
                           f"RT-DETR card forward under {prep}")
        msda.MSDA_PREP = "xla"
        levels = built.module.config.num_feature_levels
        for backend, name in BACKEND_KERNEL.items():
            msda.MSDA_BACKEND = backend
            with torch.inference_mode():
                t0 = time.perf_counter()
                ref = cpu_model(x)
                cpu_s = time.perf_counter() - t0
                reset_counts()
                got = gpu_model(x.to(device))
                torch.cuda.synchronize()
            card_launches = read_counts()
            rec = {
                "phase": "parity", "model": MODEL_NAME, "msda_backend": backend, "batch": 1,
                "compare": "card vs cpu (both under the backend)",
                **parity_record(ref, got, 1),
                "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
                "cpu_forward_s": cpu_s, "card_launches": card_launches,
            }
            emit(rec, log)
            records.append(rec)
            check_parity(rec, f"card vs CPU under SPOTTER_TPU_MSDA={backend}")
            check_launches(card_launches, name, layers * backend_launches(backend, levels),
                           f"RT-DETR card forward under {backend}")
        msda.MSDA_BACKEND = "auto"
        outs, launches = {}, {}
        for prep in msda.MSDA_PREP_VALUES:
            msda.MSDA_PREP = prep
            reset_counts()
            with torch.inference_mode():
                outs[prep] = gpu_model(x8.to(device))
            torch.cuda.synchronize()
            launches[prep] = read_counts()
        # the three kernels walk the same terms alike, so kernel and fused
        # are expected equal to xla (0.0); the tolerance is the one above
        for prep in ("kernel", "fused"):
            rec = {
                "phase": "parity", "model": MODEL_NAME, "msda_prep": f"{prep} vs xla",
                "batch": 8, "compare": "card vs card",
                **parity_record(outs["xla"], outs[prep], 8),
                "card_launches": {p: launches[p] for p in ("xla", prep)},
                "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
            }
            emit(rec, log)
            records.append(rec)
            check_parity(rec, f"card {prep} vs card xla at B = 8")
    finally:
        msda.MSDA_PREP = "xla"
        msda.MSDA_BACKEND = "auto"
        del gpu_model, cpu_model
    return records


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


# listing-photo sizes of the serve phases' requests
PHOTO_SIZES = [(480, 640), (1080, 1440), (600, 800), (768, 1024), (1080, 810), (640, 480),
               (900, 1200), (720, 960)]


def phase_serve(log: list, seed: int, built, device: str = "cuda") -> dict:
    """Slice 1's path under `xla`: the engine's detect plus the response
    assembly, on decoded photos."""
    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8
    from spotter_tpu_torch.serving.detector import assemble_response
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    msda.MSDA_PREP = "xla"
    rng = np.random.default_rng(seed + 2)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    requests = [photos[:1], photos[1:4], photos[:8]] + [photos[:8]] * 5

    engine = InferenceEngine(built, device=device)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    decoder_layers = built.module.config.decoder_layers

    reset_counts()  # count only this path's launches from here
    latencies, forwards = [], 0
    for reqn, images in enumerate(requests):
        urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
        t0 = time.perf_counter()
        raw = engine.detect(images)
        resp = assemble_response(urls, raw)
        latencies.append(time.perf_counter() - t0)
        forwards += -(-len(images) // engine.batch_buckets[-1])
        check_response(resp, raw, len(images))
    counts = read_counts()
    launches = counts.pop("msda_gather_sum")
    if launches != decoder_layers * forwards or any(counts.values()):
        raise AssertionError(
            f"MSDA kernels launched {launches} (+ {counts}) times over {forwards} forwards, "
            f"expected {decoder_layers} gather-sums per forward and nothing else"
        )

    # where a batch-8 request's time goes: host resize vs device forward
    t0 = time.perf_counter()
    pixels, _, tsizes = batch_images_uint8(photos[:8], built.preprocess_spec,
                                           pool=engine.decode_pool)
    host_ms = (time.perf_counter() - t0) * 1e3
    px = torch.from_numpy(pixels).to(device)
    sz = torch.from_numpy(tsizes).to(device)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    # the device forward at B = 1 and 8 under each prep setting, in turns,
    # after the counts were read (these launches are not the main path's)
    device_ms = {1: {}, 8: {}}
    with torch.inference_mode():
        for prep in ("xla", "kernel", "fused", "xla"):
            msda.MSDA_PREP = prep
            for b, by_prep in device_ms.items():
                by_prep.setdefault(prep, []).append(
                    cuda_time_ms(lambda b=b: engine._forward(px[:b], sz[:b]), 5, flush))
    msda.MSDA_PREP = "xla"
    b8 = latencies[2:]
    rec = {
        "phase": "serve", "model": MODEL_NAME, "device": device, "warmup_s": warmup_s,
        "requests": [len(r) for r in requests],
        "latency_ms": [v * 1e3 for v in latencies],
        "batch8_p50_ms": statistics.median(b8) * 1e3,
        "batch8_img_per_s": 8 / statistics.median(b8),
        "batch8_host_resize_ms": host_ms,
        "batch8_device_forward_ms": device_ms[8]["xla"][0],
        "device_forward_ms_by_prep": device_ms,
        "forwards": forwards, "msda_launches": launches,
        "launches_per_forward": launches / forwards,
        "detections_per_image": [len(d) for d in raw],
        "amenities_description": resp["amenities_description"],
    }
    emit(rec, log)
    return rec


ENGINE_POLICIES = ("float32", "bfloat16")
ENGINE_PROFILE_ITERS = 5  # forwards a profiled loop runs, back to back


def forward_profile(fn, iters: int = ENGINE_PROFILE_ITERS) -> dict:
    """`iters` calls of `fn` back to back, twice: by the host clock alone,
    host ms a forward (until the call returns, before any wait) and wall ms
    a forward (until the card is done); then under torch.profiler, kernel ms
    a forward (the device events' own time) and the busy share (kernel over
    that loop's wall). Where the profiler shows no device time (a graph's
    kernels untraced), CUDA events around one call give the kernel ms
    instead, and `kernel_ms_from` says so."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    def loop() -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return host, (time.perf_counter() - t0) * 1e3 / iters

    fn()
    host_ms, wall_ms = loop()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall_ms = loop()
    kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3 / iters
    source = "profiler"
    if kernel_ms <= 0:
        from spotter_tpu_torch.tools.timing import cuda_time_ms

        kernel_ms, source = cuda_time_ms(fn, iters, None, warmup=1), "cuda_events"
    return {"host_ms": host_ms, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "profiled_wall_ms": prof_wall_ms, "busy_share": kernel_ms / prof_wall_ms,
            "kernel_ms_from": source}


def replay_equal(engine, graph_key, px, sz, what: str) -> dict:
    """The captured graph of `graph_key` replayed on (px, sz) against the
    eager `_forward` on the same tensors: every output bit equal, else it
    raises. Counted launches of the replay are not this check's business:
    the caller resets the counts before the main path."""
    import torch

    graph = engine.graphs[graph_key]
    eager = engine._forward(px, sz)
    replayed = [t.clone() for t in graph.replay((px, sz, None, None, None))]
    torch.cuda.synchronize()
    diffs = [(e.float() - r.float()).abs().max().item() for e, r in zip(eager, replayed)]
    if not all(torch.equal(e, r) for e, r in zip(eager, replayed)):
        raise AssertionError(f"{what}: the graph replay differs from the eager forward: {diffs}")
    return {"bit_equal": True, "max_abs_diff": diffs}


def engine_photos(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [synthetic_photo(rng, *PHOTO_SIZES[i % len(PHOTO_SIZES)]) for i in range(n)]


def phase_engine(log: list, seed: int, built=None, device: str = "cuda") -> dict:
    """The engine's full form at full-width RT-DETRv2-R101, buckets (1, 2,
    4, 8), under `float32` and `bfloat16` (and `bfloat16` + SPOTTER_TPU_INT8
    at B = 8): `warmup` captures one graph per bucket; each replay is bit
    equal to the eager `_forward`; host, wall and kernel ms a forward, eager
    against replay, and the busy share at B = 1 and 8; the capture ledger
    and the perf gauges; a 24-photo `detect` (three B = 8 chunks in flight)
    equal to three serial 8-photo calls, the launch counts the forwards'
    (replays included); `attest()` ok, then naming `device:0` after
    `corrupt_weights(1)`, then ok after `reload_weights()`; and a knob change
    (MSDA_PREP xla -> kernel) that captures anew and launches row 2."""
    import torch

    from spotter_tpu_torch.engine import graphs
    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8

    msda.MSDA_PREP = "xla"
    photos = engine_photos(seed + 16, 24)
    rec = {"phase": "engine", "model": MODEL_NAME, "nvidia_smi": nvidia_smi("name,power.limit"),
           "policies": {}}
    for policy in ENGINE_POLICIES:
        leg = {}
        with precision_policy(policy):
            if policy != "float32" or built is None:
                built = build_detector(MODEL_NAME, tiny=False, seed=seed)
            engine = InferenceEngine(built, device=device)
            layers = built.module.config.decoder_layers
            t0 = time.perf_counter()
            engine.warmup()
            leg["warmup_s"] = time.perf_counter() - t0
            snap = engine.metrics.snapshot()
            leg["captures"] = [{k: s[k] for k in ("shape", "source", "wall_s", "count")}
                               for s in snap["compile_shapes"]]
            if len(engine.graphs) != len(engine.batch_buckets) or snap["compiles_total"] != len(
                    engine.batch_buckets) or {s["source"] for s in leg["captures"]} != {"warmup"}:
                raise AssertionError(f"engine {policy}: warmup captured {leg['captures']}")
            leg["flops_per_forward"] = {s: engine.metrics.perf.flops_for(s)
                                        for s in (engine._shape_key(b, 640, 640)
                                                  for b in engine.batch_buckets)}
            pixels, _, sizes = batch_images_uint8(photos[:8], built.preprocess_spec,
                                                  pool=engine.decode_pool)
            px = torch.from_numpy(pixels).to(device)
            sz = torch.from_numpy(sizes).to(device)
            leg["replay_vs_eager"], leg["profile"] = {}, {}
            with torch.inference_mode():
                for b in engine.batch_buckets:
                    key = graphs.graph_key(engine._shape_key(b, 640, 640))
                    leg["replay_vs_eager"][b] = replay_equal(engine, key, px[:b], sz[:b],
                                                             f"engine {policy} B = {b}")
                    if b in (1, 8):
                        graph = engine.graphs[key]
                        leg["profile"][b] = {
                            "eager": forward_profile(lambda: engine._forward(px[:b], sz[:b])),
                            "replay": forward_profile(
                                lambda: graph.replay((px[:b], sz[:b], None, None, None))),
                        }
            # the main path: 24 photos, three B = 8 chunks in flight two at a
            # time, against three serial calls; every forward a replay
            reset_counts()
            t0 = time.perf_counter()
            got = engine.detect(photos)
            leg["detect24_ms"] = (time.perf_counter() - t0) * 1e3
            serial = []
            for i in range(0, 24, 8):
                serial += engine.detect(photos[i:i + 8])
            counts = read_counts()
            if got != serial:
                raise AssertionError(f"engine {policy}: the pipelined detect of 24 photos "
                                     f"differs from three serial calls")
            check_counts(counts, {"msda_gather_sum": layers * 6}, f"engine {policy} detect")
            snap = engine.metrics.snapshot()
            leg["launches"] = {k: v for k, v in counts.items() if v}
            leg["perf"] = {k: snap[k] for k in (
                "mfu_pct", "useful_mfu_pct", "device_duty_cycle_pct", "peak_tflops",
                "device_kind", "hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes",
                "compiles_total", "program_cache_hits_total", "h2d_bytes_per_image",
                "decode_pool_queue_depth")}
            leg["stages_ms_p50"] = {k: v for k, v in snap.items() if k.startswith("stage_")
                                    and k.endswith("_p50")}
            if policy == "float32":
                leg["attest"] = engine_attest(engine)
                leg["knob_change"] = engine_knob_change(engine, photos[:8], layers)
            else:
                leg["int8_b8"] = engine_int8_b8(engine, photos[:8], px, sz, layers)
            del engine, px, sz
        rec["policies"][policy] = leg
        release_cuda_memory()
    emit(rec, log)
    return rec


def engine_attest(engine) -> dict:
    """attest() ok, then `device:0` named after corrupt_weights(1), then ok
    after reload_weights()."""
    ok = engine.attest()
    engine.corrupt_weights(1)
    bad = engine.attest()
    engine.reload_weights()
    again = engine.attest()
    if not ok["ok"] or bad["mismatched"] != ["device:0"] or not again["ok"]:
        raise AssertionError(f"attestation: {ok}, after corruption {bad}, after reload {again}")
    return {"fresh": ok["ok"], "corrupted_mismatched": bad["mismatched"],
            "reloaded": again["ok"], "digest": engine.weights_digest()}


def engine_knob_change(engine, photos: list, layers: int) -> dict:
    """SPOTTER_TPU_MSDA_PREP xla -> kernel: the first forward of the new key
    runs eager and its graph is captured behind it (source `traffic`), the
    second and third replay; row 2 launches every time and row 1 never."""
    from spotter_tpu_torch.engine import graphs
    from spotter_tpu_torch.ops import msda

    before = engine.metrics.snapshot()["compiles_total"]
    msda.MSDA_PREP = "kernel"
    try:
        reset_counts()
        for _ in range(3):
            engine.detect(photos)
        counts = read_counts()
        key = graphs.graph_key(engine._shape_key(8, 640, 640))
        graph = engine.graphs.get(key)
    finally:
        msda.MSDA_PREP = "xla"
    captures = engine.metrics.snapshot()["compiles_total"] - before
    check_counts(counts, {"msda_loc_sum": 3 * layers}, "engine knob change")
    if captures != 1 or graph is None or graph.counts != {"msda_loc_sum": layers}:
        raise AssertionError(f"knob change: {captures} captures, graph {graph and graph.counts}")
    return {"new_captures": captures, "msda_loc_sum_launches": counts["msda_loc_sum"],
            "graph_counts": graph.counts}


def engine_int8_b8(engine, photos: list, px, sz, layers: int) -> dict:
    """`bfloat16` + SPOTTER_TPU_INT8 at B = 8: the int8 key's graph, made
    behind its first forward, bit equal to the eager int8 forward, its
    counts the int8 kernels' once per quantized call."""
    import torch

    from spotter_tpu_torch.engine import graphs

    with int8_knobs("conv"):
        for _ in range(2):
            engine.detect(photos)
        key = graphs.graph_key(engine._shape_key(8, 640, 640))
        with torch.inference_mode():
            eq = replay_equal(engine, key, px, sz, "engine bfloat16 + INT8 B = 8")
            graph = engine.graphs[key]
            prof = {"eager": forward_profile(lambda: engine._forward(px, sz)),
                    "replay": forward_profile(lambda: graph.replay((px, sz, None, None, None)))}
    counts = graph.counts
    calls = {name: counts.get(f"quant.{name}", 0) for name in ("conv", "dense", "qk", "av")}
    want = {k: v for k, v in {"msda_gather_sum": layers, **int8_launches(calls)}.items() if v}
    if {k: v for k, v in counts.items() if not k.startswith("quant.")} != want:
        raise AssertionError(f"int8 graph counts {counts}, expected {want}")
    return {"replay_vs_eager": eq, "graph_counts": counts, "profile": prof}


async def drive_http(det, photo_dir: str, runs: list) -> dict:
    """Serve `det` through the port's standalone app and the photos in
    `photo_dir` through a static route, both on localhost, and drive POST
    /detect. `runs` holds (label, setup, plan): `setup()` is called, the
    kernel counts are set to 0, the plan's requests run, and the counts are
    read. A plan step (key, n_urls, rounds, clients[, queries]) sends
    `rounds` rounds of `clients` concurrent requests of `n_urls` URLs each,
    with free-text `queries` when given (whose labels must then be all the
    response holds)."""
    import asyncio
    import io

    import httpx
    from aiohttp import web
    from PIL import Image

    from spotter_tpu_torch.serving.standalone import make_app

    images = web.Application()
    images.router.add_static("/img", photo_dir)
    runners = []
    for app in (images, make_app(detector=det, fatal_exit_cb=None)):
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        runners.append((runner, runner.addresses[0][1]))
    (_, img_port), (_, api_port) = runners
    urls = [f"http://127.0.0.1:{img_port}/img/p{i}.jpg" for i in range(len(PHOTO_SIZES))]
    api = f"http://127.0.0.1:{api_port}"
    out = {"latency_ms": {}}
    try:
        async with httpx.AsyncClient(timeout=300.0) as client:
            async def post(n: int, queries=None) -> float:
                body = {"image_urls": urls[:n]}
                if queries is not None:
                    body["queries"] = list(queries)
                t = time.perf_counter()
                resp = await client.post(f"{api}/detect", json=body)
                resp.raise_for_status()
                ms = (time.perf_counter() - t) * 1e3
                check_http_response(resp.json(), urls[:n], PHOTO_SIZES[0], queries)
                return ms

            def batches() -> int:
                return det.engine.metrics.snapshot()["batches_total"]

            await post(1)  # first request through the server: not timed
            for label, setup, plan in runs:
                setup()
                batches0 = batches()
                reset_counts()
                images_per_forward = {}
                for key, n, rounds, clients, *queries in plan:
                    b0 = batches()
                    lat = []
                    for _ in range(rounds):
                        lat += await asyncio.gather(
                            *(post(n, *queries) for _ in range(clients)))
                    out["latency_ms"][f"{label}:{key}"] = lat
                    images_per_forward[key] = n * len(lat) / (batches() - b0)
                out[label] = {"launches": read_counts(), "forwards": batches() - batches0,
                              "images_per_forward": images_per_forward}
            health = await client.get(f"{api}/healthz")
            out["healthz"], out["healthz_keys"] = health.status_code, sorted(health.json())
            out["metrics"] = (await client.get(f"{api}/metrics")).json()
            # where a batch-8 request's host time goes: fetch and decode of
            # its 8 photos, one after another, as the server does them
            t = time.perf_counter()
            for url in urls:
                data = (await client.get(url)).content
                Image.open(io.BytesIO(data)).convert("RGB")
            out["fetch_decode_8_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        for runner, _ in reversed(runners):
            await runner.cleanup()
    return out


def write_photos(photo_dir: str, rng) -> None:
    from PIL import Image

    for i, (h, w) in enumerate(PHOTO_SIZES):
        Image.fromarray(synthetic_photo(rng, h, w)).save(f"{photo_dir}/p{i}.jpg", quality=90)


def latency_summary(lat: dict) -> dict:
    return {k: {"p50": statistics.median(v), "p99": percentile(v, 0.99), "n": len(v)}
            for k, v in lat.items()}


def check_launches(counts: dict, name: str, expected: int, what: str) -> None:
    """`name` launched `expected` times (with its companion pass, if it has
    one) and no other kernel at all."""
    check_counts(counts, {name: expected}, what)


def phase_http(log: list, seed: int, device: str = "cuda") -> dict:
    """The replica's own entry point: the port's standalone server on
    localhost with the full-width model, answering POST /detect for photos
    fetched from a local HTTP server. Under `fused`: requests of 1, 3 and 8
    URLs one at a time, then 4 concurrent clients of 8 URLs each; then a
    short run under `kernel`. Each run's kernel counts are set to 0 just
    before it and read just after."""
    import asyncio
    import tempfile

    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 3)
    t0 = time.perf_counter()
    det = build_detector_app(MODEL_NAME, device=device, seed=seed, warmup=True)
    bringup_s = time.perf_counter() - t0
    layers = det.engine.built.module.config.decoder_layers

    def prep(name: str):
        return lambda: setattr(msda, "MSDA_PREP", name)

    runs = [
        ("fused", prep("fused"), [("1", 1, 5, 1), ("3", 3, 5, 1), ("8", 8, 5, 1),
                                  ("4x8", 8, 3, 4)]),
        ("kernel", prep("kernel"), [("8", 8, 3, 1)]),
    ]
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        try:
            out = asyncio.run(drive_http(det, photo_dir, runs))
        finally:
            msda.MSDA_PREP = "xla"

    lat = out["latency_ms"]
    rec = {
        "phase": "http", "model": MODEL_NAME, "device": device, "bringup_s": bringup_s,
        "healthz": out["healthz"], "integrity": out["metrics"].get("integrity"),
        "latency_ms": latency_summary(lat),
        "img_per_s_8_urls": 8e3 / statistics.median(lat["fused:8"]),
        "img_per_s_4x8_concurrent": 32e3 / statistics.median(lat["fused:4x8"]),
        "fetch_decode_8_ms": out["fetch_decode_8_ms"],
        "fetch_decode_share_8_urls": out["fetch_decode_8_ms"] / statistics.median(lat["fused:8"]),
        "engine_stage_ms": {k: v for k, v in out["metrics"].items() if k.startswith("stage_")},
        "mean_batch_size": out["metrics"]["mean_batch_size"],
        "fused": out["fused"], "kernel": out["kernel"],
    }
    emit(rec, log)
    # the injected detector skips the verifying gate, as the JAX package's
    # does: no plane, so no integrity snapshot in /metrics and none in /healthz
    if out["healthz"] != 200 or "integrity" in out["metrics"] or "integrity" in out["healthz_keys"]:
        raise AssertionError(f"/healthz answered {out['healthz']} with keys {out['healthz_keys']}, "
                             f"/metrics integrity {out['metrics'].get('integrity')!r}")
    for prep_name, name in (("fused", "msda_fused_sum"), ("kernel", "msda_loc_sum")):
        run_rec = out[prep_name]
        check_launches(run_rec["launches"], name, layers * run_rec["forwards"],
                       f"under {prep_name}")
    return rec


# the periodic re-verification's cadence in the integrity phase (seconds)
INTEGRITY_INTERVAL_S = 1.0
# the latency burst: concurrent clients each POSTing /detect of 8 URLs, in
# segments of INTEGRITY_SEGMENT requests that alternate the loop at 1 s and
# the loop stopped over INTEGRITY_ROUNDS rounds; then the default cadence
# (probe 30 s, attest 60 s) for INTEGRITY_DEFAULT_S, which holds its first
# attest and two probes
INTEGRITY_CLIENTS = 4
INTEGRITY_SEGMENT = 25
INTEGRITY_ROUNDS = 2
INTEGRITY_DEFAULT_S = 62.0
# ~0.5 s of queued work on the engine's stream ahead of a fresh kept value
ATTEST_ORDER_SLEEP_CYCLES = 1_000_000_000


def brief(text):
    """The head of a reason text (a probe's holds its whole answer)."""
    return None if text is None else text[:200]


def probe_drift(ref: list, got: list) -> dict:
    """How far `got` (a probe's detections) sits from `ref`: the largest
    difference of their score-sorted scores, and over `got`'s detections
    the largest distance (max coordinate difference, px) to the nearest
    same-label detection of `ref`; and whether the label multisets agree."""
    scores = [abs(a - b) for a, b in zip(sorted(d["score"] for d in ref),
                                         sorted(d["score"] for d in got))]
    boxes = []
    for d in got:
        near = [max(abs(x - y) for x, y in zip(d["box"], r["box"]))
                for r in ref if r["label"] == d["label"]]
        if near:
            boxes.append(min(near))
    return {"n": len(got), "n_ref": len(ref), "score": max(scores, default=0.0),
            "box_px": max(boxes, default=0.0),
            "labels_equal": sorted(d["label"] for d in ref) == sorted(d["label"] for d in got)}


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition -> {sample name: count}; raises on a line
    that is neither a comment nor `name[{labels}] value [# exemplar]`."""
    import math
    import re

    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
    names: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.match(line.split(" # ", 1)[0])
        if m is None:
            raise AssertionError(f"unparsable exposition line {line!r}")
        value = float(m.group(3))
        if math.isnan(value):
            raise AssertionError(f"NaN sample {line!r}")
        names[m.group(1)] = names.get(m.group(1), 0) + 1
    return names


def flip_kept_bit(engine) -> str:
    """Flip the lowest bit of the first word of one kept value every graph
    reads (the first fp32 folded BN pair's scale), in place on the card.
    Returns its label."""
    import torch

    from spotter_tpu_torch.models.layers import kept_entries

    held = {id(entry) for graph in engine.graphs.values() for _, entry in graph.held}
    for label, entry in kept_entries(engine.model):
        if label.endswith("._folded") and id(entry) in held and entry[1][0].dtype == torch.float32:
            with torch.no_grad():
                entry[1][0].view(torch.int32).view(-1)[:1].bitwise_xor_(1)
            torch.cuda.synchronize()
            return label
    raise AssertionError("no fp32 folded BN pair held by the graphs")


@contextlib.contextmanager
def replica_env(env: dict):
    """Environment variables set for a bring-up (None unsets), restored
    after; the fault plan and the flight recorder start clean."""
    from spotter_tpu_torch import obs
    from spotter_tpu_torch.testing import faults

    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    faults._active = None
    obs.reset_recorder()
    try:
        yield
    finally:
        faults._active = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def bring_up_replica(photo_dir: str, exits: list, watch_detect: bool = False,
                           fetches: dict | None = None, model_name: str = MODEL_NAME):
    """The replica of `model_name` through `make_app(model_name=...,
    warmup=True, device="cuda")` (its bring-up, not an injected detector) behind a local
    server, with the photos on a static route. Polls /startupz every 50 ms
    until ready, failed or an exit code lands, recording the states seen;
    with `watch_detect`, also POSTs /detect at every poll and records the
    statuses. With `fetches` (a dict), the static route counts each path
    and query it serves there, and holds a photo whose name starts with
    "slow" for PLANES_SLOW_FETCH_S (a slow origin). Returns (runners, api
    url, photo urls, record)."""
    import httpx
    from aiohttp import web

    from spotter_tpu_torch.serving.standalone import make_app

    middlewares = []
    if fetches is not None:
        @web.middleware
        async def count(request, handler):
            fetches[request.path_qs] = fetches.get(request.path_qs, 0) + 1
            if request.path.startswith("/img/slow"):
                await asyncio.sleep(PLANES_SLOW_FETCH_S)
            return await handler(request)

        middlewares.append(count)
    images = web.Application(middlewares=middlewares)
    images.router.add_static("/img", photo_dir)
    app = make_app(model_name=model_name, warmup=True, device="cuda",
                   bringup_exit_cb=exits.append, integrity_exit_cb=exits.append,
                   fatal_exit_cb=exits.append)
    runners = []
    for a in (images, app):
        runner = web.AppRunner(a)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        runners.append(runner)
    img_port, api_port = (r.addresses[0][1] for r in runners)
    urls = [f"http://127.0.0.1:{img_port}/img/p{i}.jpg" for i in range(len(PHOTO_SIZES))]
    api = f"http://127.0.0.1:{api_port}"
    states, detect_statuses = [], []
    t0 = time.perf_counter()
    async with httpx.AsyncClient(timeout=300.0) as client:
        while time.perf_counter() - t0 < 600:
            snap = (await client.get(f"{api}/startupz")).json()
            if not states or states[-1] != snap["state"]:
                states.append(snap["state"])
            if watch_detect:
                resp = await client.post(f"{api}/detect", json={"image_urls": urls[:1]})
                detect_statuses.append(resp.status_code)
            if snap["state"] in ("ready", "failed") or exits:
                break
            await asyncio.sleep(0.05)
    rec = {"states": states, "bringup_s": time.perf_counter() - t0, "exits": list(exits),
           "startupz": snap, "detect_statuses": sorted(set(detect_statuses))}
    return runners, app, api, urls, rec


async def wait_for_exit(exits: list, timeout_s: float) -> float:
    """Seconds until an exit code lands in `exits` (raises past the timeout)."""
    t0 = time.perf_counter()
    while not exits:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"no exit within {timeout_s} s")
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def probe_buckets(plane, batcher, photos: list) -> dict:
    """The golden probe alone (bucket 1, its kernel launches counted) and
    co-batched with 1, 3 and 7 live photos (buckets 2, 4 and 8) through the
    real batcher: each answer held by the plane's own comparison to the pin
    of the bucket it ran in (which must pass), and its drift from the
    bucket-1 pin recorded; where the engine puts the bucket in bucket 1's
    answer class (every bucket of one function under `float32`), the
    answer must also pass the comparison with bucket 1's pin."""
    from spotter_tpu_torch.obs import compare
    from spotter_tpu_torch.serving.overload import BULK

    probe = plane.probe
    engine = batcher.engine
    reset_counts()
    if await probe.run(batcher) is not None:
        raise AssertionError(f"the probe alone failed: {probe.last_error}")
    launches = read_counts()
    out = {"alone_launches": launches, "buckets": {}}
    for k in (1, 3, 7):
        info = {}
        dets, *_ = await asyncio.gather(
            batcher.submit(probe.image, cls=BULK, info=info),
            *(batcher.submit(p) for p in photos[:k]))
        bucket = info["bucket"]
        pin = probe.pins[bucket]
        reason = probe._diff(pin, dets)
        cls = engine.answer_class(bucket)
        held_to_1 = cls is not None and cls == engine.answer_class(1)
        vs_1 = compare.diff_detections(probe.pins[1], dets)
        out["buckets"][str(bucket)] = {
            "with_photos": k, "vs_bucket_pin": brief(reason),
            "drift_vs_bucket_pin": probe_drift(pin, dets),
            "answer_class": cls, "held_to_bucket1": held_to_1,
            "drift_vs_bucket1_pin": probe_drift(probe.pins[1], dets),
            "bucket1_pin_diff": brief(vs_1),
        }
        if (bucket != engine.bucket_for(k + 1) or reason is not None
                or (held_to_1 and vs_1 is not None)):
            raise AssertionError(f"probe with {k} photos (bucket {bucket}): {reason or vs_1}")
    return out


async def detect_burst(client, api: str, urls: list, n: int = 0,
                       seconds: float = 0.0) -> list:
    """/detect latencies (ms) of 8-URL requests from INTEGRITY_CLIENTS
    concurrent clients: `n` requests in all, or (with `seconds`) every
    request started within that many seconds."""
    lat: list = []
    t_end = time.perf_counter() + seconds
    left = [n]

    async def one_client():
        while (time.perf_counter() < t_end) if seconds else left[0] > 0:
            left[0] -= 1
            t = time.perf_counter()
            resp = await client.post(f"{api}/detect", json={"image_urls": urls[:8]})
            resp.raise_for_status()
            lat.append((time.perf_counter() - t) * 1e3)

    await asyncio.gather(*(one_client() for _ in range(INTEGRITY_CLIENTS)))
    return lat


async def integrity_burst(client, api: str, urls: list, plane) -> dict:
    """/detect latency with the plane's loop at 1 s and stopped, in
    alternating segments over INTEGRITY_ROUNDS rounds, then at the default
    cadence; each mode's p50/p99 over all its requests, and the probes and
    attests that ran while it was measured."""
    from spotter_tpu_torch.serving import integrity

    lat = {"loop_1s": [], "stopped": [], "default_cadence": []}
    ran = {mode: {"probes": 0, "attests": 0} for mode in lat}
    segments = []

    async def segment(mode: str, probe_s: float, attest_s: float, **burst) -> None:
        if probe_s or attest_s:
            plane.probe_interval_s, plane.attest_interval_s = probe_s, attest_s
            await plane.start()
        before = plane.snapshot()
        t0 = time.perf_counter()
        got = await detect_burst(client, api, urls, **burst)
        after = plane.snapshot()
        await plane.aclose()
        probes = after["probe"]["probes_total"] - before["probe"]["probes_total"]
        attests = after["attest"]["attests_total"] - before["attest"]["attests_total"]
        lat[mode] += got
        ran[mode]["probes"] += probes
        ran[mode]["attests"] += attests
        segments.append({"mode": mode, "seconds": time.perf_counter() - t0, "probes": probes,
                         "attests": attests, **latency_summary({mode: got})[mode]})

    await plane.aclose()
    await client.post(f"{api}/detect", json={"image_urls": urls[:8]})
    for _ in range(INTEGRITY_ROUNDS):
        await segment("loop_1s", INTEGRITY_INTERVAL_S, INTEGRITY_INTERVAL_S,
                      n=INTEGRITY_SEGMENT)
        await segment("stopped", 0.0, 0.0, n=INTEGRITY_SEGMENT)
    await segment("default_cadence", integrity.DEFAULT_PROBE_INTERVAL_S,
                  integrity.DEFAULT_ATTEST_INTERVAL_S, seconds=INTEGRITY_DEFAULT_S)
    plane.probe_interval_s = plane.attest_interval_s = INTEGRITY_INTERVAL_S
    out = {"clients": INTEGRITY_CLIENTS, "urls": 8, "segments": segments,
           "attest_last_s": plane.snapshot()["attest"]["last_duration_s"]}
    for mode, summary in latency_summary(lat).items():
        out[mode] = {**summary, **ran[mode]}
    if ran["default_cadence"]["attests"] < 1 or ran["default_cadence"]["probes"] < 2:
        raise AssertionError(f"the default cadence's segment missed its checks: {ran}")
    return out


def attest_after_engine_stream(engine) -> dict:
    """A kept value made on the engine's stream behind ~0.5 s of queued
    work (a statistic's version moved, then the BN layer run there), then
    `engine.attest()` at once from this thread: it must wait for that
    stream, re-derive the new value bit equal and pin it."""
    import torch

    from spotter_tpu_torch.models.layers import FrozenBatchNorm

    bn = next(m for m in engine.model.modules() if isinstance(m, FrozenBatchNorm))
    old = vars(bn)["_folded"]
    with torch.cuda.stream(engine._stream):
        torch.cuda._sleep(ATTEST_ORDER_SLEEP_CYCLES)
        with torch.no_grad():
            bn.running_var.add_(0)
        with torch.inference_mode():
            bn(torch.zeros((1, bn.running_var.shape[0], 1, 1), device=engine.device,
                           dtype=bn.dtype))
    t0 = time.perf_counter()
    result = engine.attest()
    out = {"attest_s": time.perf_counter() - t0, "ok": result["ok"],
           "mismatched": result["mismatched"][:4], "kept_checked": result["kept_checked"],
           "new_entry_pinned": id(vars(bn)["_folded"]) in engine._kept_pins}
    if vars(bn)["_folded"] is old or not result["ok"] or not out["new_entry_pinned"]:
        raise AssertionError(f"attest after the engine's stream: {out}")
    return out


def phase_integrity(log: list, seed: int) -> dict:
    """The replica's output-integrity plane on RT-DETRv2-R101 at full width
    with seed-0 weights, each replica brought up through `make_app` (its
    bring-up path, not an injected detector):

    1. float32, the full ladder, probe and attest every second: /startupz
       passes loading -> warming -> verifying -> ready; the gate's attest
       and probe seconds and the pinned detections per bucket; the probe
       alone (msda_gather_sum 6 launches) and co-batched with 1, 3 and 7
       photos, each within the tolerance of its bucket's pin; a traced
       request (X-Request-ID) whose trace holds every stage's span, its
       Server-Timing, and /metrics?format=prometheus parsed with the
       integrity counters; /detect p50/p99 of 8-URL requests from
       concurrent clients, the loop at 1 s and stopped alternating over
       rounds, then at the default cadence (`integrity_burst`); then
       `sdc=100`: /detect answers 200 and the periodic probe exits 86; a
       kept value made on the engine's stream behind queued work, attested
       at once from another stream (`attest_after_engine_stream`); then a
       new plane on the same engine and one bit of a kept value flipped:
       the periodic attest exits 86;
    2. "bfloat16" + SPOTTER_TPU_INT8: the gate and the probe by bucket;
    3. SPOTTER_TPU_FAULTS=corrupt_weights=1 (buckets (1,)): exit 86 before
       READY, no /detect answering 200 on the way;
    4. corrupt_compile_cache=1 (buckets (1,)): the gate's attest clean, the
       probe failing, exit 86.
    """
    import tempfile

    import httpx
    import torch

    from spotter_tpu_torch.serving import integrity
    from spotter_tpu_torch.testing import faults
    from spotter_tpu_torch.utils import quant

    from PIL import Image

    rng = np.random.default_rng(seed + 20)
    photos = [Image.fromarray(synthetic_photo(rng, 480, 640)) for _ in range(7)]
    intervals = {"SPOTTER_TPU_PROBE_INTERVAL_S": str(INTEGRITY_INTERVAL_S),
                 "SPOTTER_TPU_ATTEST_INTERVAL_S": str(INTEGRITY_INTERVAL_S),
                 "SPOTTER_TPU_INTEGRITY": None, "SPOTTER_TPU_FAULTS": None,
                 "SPOTTER_TPU_BATCH_BUCKETS": None}
    rec: dict = {"phase": "integrity", "model": MODEL_NAME,
                 "nvidia_smi": nvidia_smi("name,power.limit")}

    def gate_record(plane, bring: dict) -> dict:
        snap = plane.snapshot()
        pins = {str(b): len(p) for b, p in sorted(plane.probe.pins.items())}
        return {**bring, "verify_s": snap["last_verify_s"],
                "attest_s": snap["attest"]["last_duration_s"],
                "probe_s": snap["last_verify_s"] - snap["attest"]["last_duration_s"],
                "pinned_detections": len(plane.probe.reference), "pins_by_bucket": pins,
                "kept_checked": plane.engine.attest()["kept_checked"]}

    def check_ready(bring: dict, what: str) -> None:
        if bring["states"] != ["loading", "warming", "verifying", "ready"] or bring["exits"]:
            raise AssertionError(f"{what}: bring-up states {bring['states']}, exits "
                                 f"{bring['exits']}")

    async def float32_replica(photo_dir: str) -> dict:
        exits: list = []
        runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits)
        out = {}
        try:
            check_ready(bring, "float32")
            det, plane = app["detector"], app["integrity"]
            out["gate"] = gate_record(plane, bring)
            if not plane.probe.reference:
                emit({"phase": "integrity", "note": "the float32 pin is empty"}, log)
            # the loop stays off while the probe is held by bucket: a
            # periodic probe would join those batches and the counts
            await plane.aclose()
            out["probe"] = await probe_buckets(plane, det.batcher, photos)
            await plane.start()
            check_counts(out["probe"]["alone_launches"],
                         {"msda_gather_sum": det.engine.built.module.config.decoder_layers},
                         "the probe alone")
            async with httpx.AsyncClient(timeout=300.0) as client:
                # one traced request: its spans, Server-Timing, Prometheus view
                rid = f"chip-smoke-{seed}"
                resp = await client.post(f"{api}/detect", json={"image_urls": urls[:2]},
                                         headers={"X-Request-ID": rid})
                resp.raise_for_status()
                traces = (await client.get(f"{api}/debug/traces",
                                           params={"request_id": rid})).json()["traces"]
                spans = sorted({s["name"] for t in traces for s in t["spans"]})
                prom_text = (await client.get(f"{api}/metrics",
                                              params={"format": "prometheus"})).text
                names = parse_prometheus(prom_text)
                out["trace"] = {
                    "request_id": resp.headers.get("X-Request-ID"), "spans": spans,
                    "server_timing": resp.headers.get("Server-Timing"),
                    "prometheus_samples": len(names),
                    "integrity_samples": sorted(n for n in names if "_integrity_" in n),
                }
                want = {"fetch", "decode", "queue_wait", "h2d", "device", "postprocess"}
                if (out["trace"]["request_id"] != rid or not want <= set(spans)
                        or not out["trace"]["server_timing"]
                        or "spotter_tpu_integrity_verifications_total" not in names
                        or "spotter_tpu_integrity_attest_attests_total" not in names):
                    raise AssertionError(f"trace / exposition check: {out['trace']}")
                out["burst"] = await integrity_burst(client, api, urls, plane)
                await plane.start()
                # sdc=100: answers stay 200, the periodic probe exits 86
                with faults.inject(sdc=100):
                    resp = await client.post(f"{api}/detect", json={"image_urls": urls[:1]})
                    out["sdc"] = {"detect_status": resp.status_code,
                                  "exit_after_s": await wait_for_exit(exits, 10.0),
                                  "exits": list(exits), "last_error": brief(plane.last_error)}
                if (resp.status_code != 200 or exits != [86]
                        or "periodic-probe" not in (plane.last_error or "")):
                    raise AssertionError(f"sdc check: {out['sdc']}")
            await plane.aclose()
            out["attest_order"] = attest_after_engine_stream(det.engine)
            # a new plane on the same engine (its gate re-pins nothing the
            # engine pinned), then one bit of a kept value flipped: the next
            # periodic attest exits 86
            exits.clear()
            plane = integrity.IntegrityPlane(det.engine, det.batcher, probe_interval_s=0,
                                             attest_interval_s=INTEGRITY_INTERVAL_S,
                                             exit_cb=exits.append)
            if not await plane.verify("cold-start"):
                raise AssertionError(f"re-verification failed: {plane.last_error}")
            await plane.start()
            label = flip_kept_bit(det.engine)
            out["kept_bit_flip"] = {"kept": label,
                                    "exit_after_s": await wait_for_exit(exits, 10.0),
                                    "exits": list(exits), "last_error": brief(plane.last_error)}
            await plane.aclose()
            if exits != [86] or label not in (plane.last_error or ""):
                raise AssertionError(f"kept-value check: {out['kept_bit_flip']}")
        finally:
            for runner in reversed(runners):
                await runner.cleanup()
        return out

    async def policy_replica(photo_dir: str) -> dict:
        exits: list = []
        runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits)
        try:
            check_ready(bring, "bfloat16 + INT8")
            plane = app["integrity"]
            return {"gate": gate_record(plane, bring),
                    "probe": await probe_buckets(plane, app["detector"].batcher, photos)}
        finally:
            for runner in reversed(runners):
                await runner.cleanup()

    async def corrupt_weights_replica(photo_dir: str) -> dict:
        exits: list = []
        runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits,
                                                                watch_detect=True)
        try:
            await wait_for_exit(exits, 60.0)
            out = {**bring, "exits": list(exits), "error": brief(app["startup"].error)}
            if (exits != [86] or "ready" in bring["states"] or 200 in bring["detect_statuses"]
                    or "checksum mismatch" not in (out["error"] or "")):
                raise AssertionError(f"corrupt_weights check: {out}")
            return out
        finally:
            for runner in reversed(runners):
                await runner.cleanup()

    async def corrupt_cache_replica(photo_dir: str) -> dict:
        exits: list = []
        runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits)
        try:
            plane = app["integrity"]
            attest_clean = plane.attestor.failures_total == 0 and plane.attestor.attests_total >= 1
            exit_s = await wait_for_exit(exits, 10.0)
            out = {**bring, "attest_clean": attest_clean, "exit_after_s": exit_s,
                   "exits": list(exits), "probe_failures": plane.probe.failures_total,
                   "last_error": brief(plane.last_error)}
            if exits != [86] or not attest_clean or plane.probe.failures_total != 1:
                raise AssertionError(f"corrupt_compile_cache check: {out}")
            return out
        finally:
            for runner in reversed(runners):
                await runner.cleanup()

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        steps = (
            ("float32", intervals, float32_replica, False),
            ("bfloat16_int8", {**intervals, "SPOTTER_TPU_PROBE_INTERVAL_S": "0",
                               "SPOTTER_TPU_ATTEST_INTERVAL_S": "0"}, policy_replica, True),
            ("corrupt_weights", {**intervals, "SPOTTER_TPU_FAULTS": "corrupt_weights=1",
                                 "SPOTTER_TPU_BATCH_BUCKETS": "1"},
             corrupt_weights_replica, False),
            ("corrupt_compile_cache", {**intervals, "SPOTTER_TPU_FAULTS":
                                       "corrupt_compile_cache=1",
                                       "SPOTTER_TPU_BATCH_BUCKETS": "1"},
             corrupt_cache_replica, False),
        )
        for name, env, fn, bf16_int8 in steps:
            t0 = time.perf_counter()
            saved_int8 = quant.INT8
            policy = precision_policy("bfloat16") if bf16_int8 else contextlib.nullcontext()
            try:
                with replica_env(env), policy:
                    quant.INT8 = bf16_int8 or saved_int8
                    rec[name] = asyncio.run(fn(photo_dir))
            finally:
                quant.INT8 = saved_int8
                release_cuda_memory()
            rec[name]["seconds"] = time.perf_counter() - t0
            emit({"phase": "integrity", "step": name, **rec[name]}, log)
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "integrity", "seconds": rec["seconds"]}, log)
    return rec


# the planes phase: rounds of 8-URL miss-then-hit requests (each round a
# fresh set of photos); the tenants (acme far above its use, hobby at 2 rps
# with a burst of 4) and their load: acme POSTs a 1-URL request at
# PLANES_ACME_RPS for PLANES_LOAD_S alone, then beside hobby's flood at
# `tenant_flood`'s multiple of its quota, every request a photo of its own
# (a cache miss, so each admitted one runs a forward); how long the origin
# holds the coalesced photo, so the 8 concurrent requests all find its fetch
# in flight
PLANES_ROUNDS = 3
PLANES_TENANTS = {"default": {"rps": 1000, "burst": 1000},
                  "tenants": {"acme": {"rps": 1000, "burst": 1000, "weight": 4},
                              "hobby": {"rps": 2, "burst": 4}}}
PLANES_FLOOD = "hobby:5"
PLANES_ACME_RPS = 4.0
PLANES_LOAD_S = 3.0
PLANES_SLOW_FETCH_S = 0.3


async def open_loop(rate: float, seconds: float, send) -> list:
    """`send(i)` started at `rate` a second for `seconds` (open loop: a slow
    answer delays no later request); the results in order."""
    t0 = time.perf_counter()
    tasks = []
    for i in range(int(rate * seconds)):
        await asyncio.sleep(max(t0 + i / rate - time.perf_counter(), 0.0))
        tasks.append(asyncio.create_task(send(i)))
    return await asyncio.gather(*tasks)


def phase_planes(log: list, seed: int) -> dict:
    """The replica's planes on RT-DETRv2-R101 at full width, float32,
    seed-0 weights, brought up through `make_app` (its bring-up, the
    integrity gate included) with buckets (1, 8), the result cache
    (SPOTTER_TPU_CACHE_MAX_MB=64), two tenants from an inline
    SPOTTER_TPU_TENANT_CONFIG and a key file (acme, hobby):

    1. miss, then hit: an 8-URL request twice, over PLANES_ROUNDS sets of
       photos: the first answers `X-Cache: miss` (8 misses counted), its
       detections within the integrity comparator's tolerance of a
       cache-off detector's on the same engine; the second `hit`, the same
       body, no forward and no kernel launched; p50 of each;
    2. the golden probe (one loop tick) after 1 and after a user /detect
       of the probe image's own bytes, twice (a miss, then a hit): one
       forward, 6 msda_gather_sum launches, with the cache full of its
       bytes and 24 other entries;
    3. coalescing: 8 concurrent requests for one new photo from a slow
       origin: one fetch, one forward (6 launches), one `miss` and seven
       `coalesced`, equal bodies;
    4. tenancy: acme at a steady rate alone, then beside hobby at 5x its
       quota (`tenant_flood=hobby:5`), every request a fresh photo (acme's
       all misses; each admitted hobby request a miss, a forward beside
       acme's): every hobby shed a 429 with Retry-After and no fetch of its
       photo, no acme 429; acme's p50 and max (n beside them) with and
       without the flood (a reading);
    5. frame: `Accept: application/x-spotter-frame` decodes to the JSON
       body of the same request; both sizes.
    """
    import json
    import tempfile

    import httpx
    from PIL import Image

    from spotter_tpu_torch.engine.batcher import MicroBatcher
    from spotter_tpu_torch.obs import compare
    from spotter_tpu_torch.serving import integrity, wire
    from spotter_tpu_torch.serving.detector import AmenitiesDetector
    from spotter_tpu_torch.testing import faults

    rng = np.random.default_rng(seed + 21)
    acme, hobby = {"X-API-Key": "key-acme"}, {"X-API-Key": "key-hobby"}
    rec: dict = {"phase": "planes", "model": MODEL_NAME,
                 "nvidia_smi": nvidia_smi("name,power.limit")}

    async def run(photo_dir: str) -> dict:
        exits, fetches = [], {}
        runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits,
                                                                fetches=fetches)
        out = {"bring_up": {k: bring[k] for k in ("states", "bringup_s", "exits")}}
        try:
            if bring["states"] != ["loading", "warming", "verifying", "ready"] or exits:
                raise AssertionError(f"planes bring-up: {bring}")
            det, plane = app["detector"], app["integrity"]
            engine = det.engine
            layers = engine.built.module.config.decoder_layers
            base = urls[0].rsplit("/", 1)[0]
            sets = [urls[:8]] + [[f"{base}/r{k}_{i}.jpg" for i in range(8)]
                                 for k in range(1, PLANES_ROUNDS)]

            def snap() -> dict:
                return engine.metrics.snapshot()

            def delta(before: dict, key: str) -> int:
                return snap()[key] - before[key]

            async with httpx.AsyncClient(timeout=300.0) as client:
                async def post(request_urls, headers=None):
                    t = time.perf_counter()
                    resp = await client.post(f"{api}/detect",
                                             json={"image_urls": request_urls},
                                             headers=headers or acme)
                    return resp, (time.perf_counter() - t) * 1e3

                # 1. miss, then hit
                miss_ms, hit_ms, first = [], [], None
                for set_urls in sets:
                    before = snap()
                    resp, ms = await post(set_urls)
                    resp.raise_for_status()
                    body = resp.json()
                    check_http_response(body, set_urls, PHOTO_SIZES[0])
                    misses = (resp.headers.get(wire.X_CACHE_HEADER),
                              delta(before, "cache_misses_total"),
                              delta(before, "cache_hits_total"))
                    if misses != ("miss", 8, 0):
                        raise AssertionError(f"the first request's cache outcome: {misses}")
                    before = snap()
                    reset_counts()
                    again, ms_hit = await post(set_urls)
                    hit = {"x_cache": again.headers.get(wire.X_CACHE_HEADER),
                           "hits": delta(before, "cache_hits_total"),
                           "forward_images": delta(before, "images_total"),
                           "launches": sum(read_counts().values()),
                           "same_body": again.content == resp.content}
                    if hit != {"x_cache": "hit", "hits": 8, "forward_images": 0,
                               "launches": 0, "same_body": True}:
                        raise AssertionError(f"the repeat is not a clean hit: {hit}")
                    miss_ms.append(ms)
                    hit_ms.append(ms_hit)
                    first = first or body
                off = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=5.0), cache=None)
                try:
                    ref = (await off.detect({"image_urls": sets[0]})).model_dump(exclude_none=True)
                finally:
                    await off.aclose()
                agree = compare.images_equivalent(first["images"], ref["images"])
                out["miss_hit"] = {
                    "rounds": len(sets), "miss_ms": miss_ms, "hit_ms": hit_ms,
                    "miss_p50_ms": statistics.median(miss_ms),
                    "hit_p50_ms": statistics.median(hit_ms),
                    "detections": sum(len(i["detections"]) for i in first["images"]),
                    "agrees_with_cache_off": agree,
                }
                if not agree:
                    raise AssertionError("the cache-on answer left the comparator's tolerance "
                                         "of the cache-off one")
                # 2. the probe runs a forward with the cache full of its bytes
                Image.fromarray(np.asarray(integrity.probe_image(plane.probe.family))).save(
                    f"{photo_dir}/probe.png")
                own = []
                for _ in range(2):
                    resp, _ = await post([f"{base}/probe.png"])
                    resp.raise_for_status()
                    own.append(resp.headers.get(wire.X_CACHE_HEADER))
                reset_counts()
                before = snap()
                reason = await plane.probe.run(det.batcher)
                out["probe"] = {"reason": brief(reason), "launches": read_counts(),
                                "forward_images": delta(before, "images_total"),
                                "own_bytes_x_cache": own,
                                "cache_entries": det.cache.stats()["entries"]}
                if (reason is not None or out["probe"]["forward_images"] != 1
                        or own != ["miss", "hit"]):
                    raise AssertionError(f"the probe with the cache full: {out['probe']}")
                check_counts(out["probe"]["launches"], {"msda_gather_sum": layers},
                             "the probe with the cache full")
                # 3. coalescing
                slow = f"{base}/slow_c.jpg"
                reset_counts()
                before = snap()
                resps = await asyncio.gather(*(post([slow]) for _ in range(8)))
                out["coalesced"] = {
                    "fetches": fetches.get("/img/slow_c.jpg", 0),
                    "forward_images": delta(before, "images_total"),
                    "launches": read_counts(),
                    "x_cache": sorted(r.headers.get(wire.X_CACHE_HEADER) for r, _ in resps),
                    "equal_bodies": len({r.content for r, _ in resps}) == 1,
                    "statuses": sorted({r.status_code for r, _ in resps}),
                    "p50_ms": statistics.median(ms for _, ms in resps),
                }
                c = out["coalesced"]
                if (c["fetches"], c["forward_images"], c["x_cache"], c["equal_bodies"],
                        c["statuses"]) != (1, 1, ["coalesced"] * 7 + ["miss"], True, [200]):
                    raise AssertionError(f"coalescing: {c}")
                check_counts(c["launches"], {"msda_gather_sum": layers}, "8 coalesced requests")

                # 4. tenancy, every request a photo of its own (a miss)
                def fresh(prefix: str, n: int) -> list:
                    photo = synthetic_photo(rng, 480, 640)
                    for i in range(n):
                        Image.fromarray(np.roll(photo, 7 * (i + 1), axis=1)).save(
                            f"{photo_dir}/{prefix}{i}.jpg", quality=90)
                    return [f"{prefix}{i}.jpg" for i in range(n)]

                def reading(ms: list) -> dict:
                    return {"n": len(ms), "p50_ms": statistics.median(ms), "max_ms": max(ms)}

                async def acme_send(name):
                    resp, ms = await post([f"{base}/{name}"])
                    return resp.status_code, ms, resp.headers.get(wire.X_CACHE_HEADER)

                async def hobby_send(name):
                    resp, _ = await post([f"{base}/{name}"], hobby)
                    return (resp.status_code, "Retry-After" in resp.headers, f"/img/{name}",
                            resp.headers.get(wire.X_CACHE_HEADER))

                n_acme = int(PLANES_ACME_RPS * PLANES_LOAD_S)
                acme_alone, acme_beside = fresh("ta", n_acme), fresh("tb", n_acme)
                alone = await open_loop(PLANES_ACME_RPS, PLANES_LOAD_S,
                                        lambda i: acme_send(acme_alone[i]))
                with faults.inject(tenant_flood=PLANES_FLOOD):
                    tenant, factor = faults.tenant_flood_spec()
                    rate = factor * PLANES_TENANTS["tenants"][tenant]["rps"]
                    hobby_names = fresh("th", int(rate * PLANES_LOAD_S))
                    before = snap()
                    flood, beside = await asyncio.gather(
                        open_loop(rate, PLANES_LOAD_S, lambda i: hobby_send(hobby_names[i])),
                        open_loop(PLANES_ACME_RPS, PLANES_LOAD_S,
                                  lambda i: acme_send(acme_beside[i])))
                    flood_forwards = delta(before, "images_total")
                shed = [f for f in flood if f[0] == 429]
                out["tenancy"] = {
                    "flood": PLANES_FLOOD, "hobby_rps": rate, "acme_rps": PLANES_ACME_RPS,
                    "seconds": PLANES_LOAD_S,
                    "hobby_statuses": {str(k): sum(1 for f in flood if f[0] == k)
                                       for k in sorted({f[0] for f in flood})},
                    "hobby_admitted_x_cache": sorted({f[3] for f in flood if f[0] == 200}),
                    "hobby_shed_without_retry_after": sum(1 for f in shed if not f[1]),
                    "hobby_shed_fetched": sum(fetches.get(f[2], 0) for f in shed),
                    "acme_statuses": sorted({s for s, _, _ in alone + beside}),
                    "acme_x_cache": sorted({x for _, _, x in alone + beside}),
                    "forward_images_beside_flood": flood_forwards,
                    "acme_alone_ms": reading([ms for _, ms, _ in alone]),
                    "acme_beside_flood_ms": reading([ms for _, ms, _ in beside]),
                    "tenants": (await client.get(f"{api}/metrics")).json()["tenants"],
                }
                t = out["tenancy"]
                admitted = sum(1 for f in flood if f[0] == 200)
                if (not shed or t["hobby_shed_without_retry_after"] or t["hobby_shed_fetched"]
                        or t["acme_statuses"] != [200] or not admitted
                        or t["acme_x_cache"] != ["miss"]
                        or t["hobby_admitted_x_cache"] != ["miss"]
                        or flood_forwards != admitted + n_acme):
                    raise AssertionError(f"tenancy: {t}")
                # 5. frame
                framed, _ = await post(sets[0], {**acme, "Accept": wire.FRAME_CONTENT_TYPE})
                plain, _ = await post(sets[0])
                decoded = wire.decode_frame(framed.content)
                out["frame"] = {"frame_bytes": len(framed.content), "json_bytes": len(plain.content),
                                "content_type": framed.headers.get("Content-Type"),
                                "equal": decoded == plain.json()}
                if not out["frame"]["equal"]:
                    raise AssertionError(f"frame: {out['frame']}")
            out["exits"] = list(exits)
            if exits:
                raise AssertionError(f"the planes replica exited: {exits}")
        finally:
            for runner in reversed(runners):
                await runner.cleanup()
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        for k in range(1, PLANES_ROUNDS):
            for i, (h, w) in enumerate(PHOTO_SIZES):
                Image.fromarray(synthetic_photo(rng, h, w)).save(f"{photo_dir}/r{k}_{i}.jpg",
                                                                quality=90)
        Image.fromarray(synthetic_photo(rng, 480, 640)).save(f"{photo_dir}/slow_c.jpg",
                                                             quality=90)
        keys = f"{photo_dir}/tenant_keys.json"
        with open(keys, "w") as f:
            json.dump({"key-acme": "acme", "key-hobby": "hobby"}, f)
        env = {"SPOTTER_TPU_BATCH_BUCKETS": "1,8", "SPOTTER_TPU_CACHE_MAX_MB": "64",
               "SPOTTER_TPU_TENANT_CONFIG": json.dumps(PLANES_TENANTS),
               "SPOTTER_TPU_TENANT_KEYS": keys, "SPOTTER_TPU_INTEGRITY": None,
               "SPOTTER_TPU_PROBE_INTERVAL_S": "0", "SPOTTER_TPU_ATTEST_INTERVAL_S": "0",
               "SPOTTER_TPU_FAULTS": None}
        try:
            with replica_env(env):
                rec.update(asyncio.run(run(photo_dir)))
        finally:
            release_cuda_memory()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec, log)
    return rec


# the attention instantiation each precision policy's YOLOS body runs
POLICY_KERNEL = {"float32": "flash_attn_fp32", "mixed": "flash_attn_bf16"}


@contextlib.contextmanager
def precision_policy(name: str, rep_fuse=None):
    """SPOTTER_TPU_DTYPE=`name` and SPOTTER_TPU_REP_FUSE=`rep_fuse` (unset
    for None) while the block builds and runs models: the zoo reads the
    policy when it builds one, and the MSDA precision and RepVGG fusion
    defaults are read when a forward runs."""
    saved = {k: os.environ.get(k) for k in ("SPOTTER_TPU_DTYPE", "SPOTTER_TPU_REP_FUSE")}
    os.environ["SPOTTER_TPU_DTYPE"] = name
    if rep_fuse is None:
        os.environ.pop("SPOTTER_TPU_REP_FUSE", None)
    else:
        os.environ["SPOTTER_TPU_REP_FUSE"] = rep_fuse
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build_yolos_under(policy: str, seed: int):
    from spotter_tpu_torch.models.registry import build_detector

    with precision_policy(policy):
        return build_detector(YOLOS_NAME, tiny=False, seed=seed)


# off-native inputs (the position tables resized by ops/resize.py's bicubic):
# YOLOS-base at 640x960, 40x60 patches (2,501 tokens against the trained
# 4,301, past the attention cutover); OWLv2 at 768x768, 48x48 patches
YOLOS_OFF_NATIVE_HW = (640, 960)
OWL_OFF_NATIVE_HW = (768, 768)


@contextlib.contextmanager
def plain_route(owl: bool = False):
    """Every kernel a YOLOS or OWL forward reaches routed to its plain
    version on the card while the block runs: the attention's (the
    SPOTTER_TPU_FLASH_ATTN switch, read at each forward) and, for OWL, the
    class-logit head's (SPOTTER_TPU_OWL_FUSED=0)."""
    from spotter_tpu_torch.models import layers
    from spotter_tpu_torch.ops import openvocab

    saved = layers.FLASH_ATTN_ENABLED, openvocab.OWL_FUSED
    layers.FLASH_ATTN_ENABLED = False
    if owl:
        openvocab.OWL_FUSED = "0"
    try:
        yield
    finally:
        layers.FLASH_ATTN_ENABLED, openvocab.OWL_FUSED = saved


def off_native_record(model, inputs, expected: dict, owl: bool, atol: dict, what: str) -> dict:
    """One forward at an off-native input on the kernels' route against the
    plain route on the same card tensors: the kernels launch as `expected`
    (none on the plain route), every output within `atol` (by output name)."""
    import torch

    with torch.inference_mode():
        reset_counts()
        got = model(*inputs)
        torch.cuda.synchronize()
        launches = read_counts()
        with plain_route(owl):
            reset_counts()
            plain = model(*inputs)
            torch.cuda.synchronize()
            plain_launches = read_counts()
    check_counts(launches, expected, f"{what}, kernels' route")
    check_counts(plain_launches, {}, f"{what}, plain route")
    rec = {"compare": "kernels vs plain route (card)", "input_hw": list(inputs[0].shape[1:3]),
           "card_launches": {k: v for k, v in launches.items() if v},
           **{f"{k}_max_abs_err": (got[k].float() - plain[k].float()).abs().max().item()
              for k in atol},
           **{f"atol_{k}": v for k, v in atol.items()}}
    bad = [k for k, v in atol.items() if not rec[f"{k}_max_abs_err"] <= v]
    if bad or not all(torch.isfinite(got[k].float()).all() for k in atol):
        raise AssertionError(f"{what}: {bad} outside tolerance, or not finite: {rec}")
    return rec


def release_cuda_memory() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_yolos_parity(log: list, seed: int, device: str = "cuda") -> list:
    """yolos-base at full width: the card against the CPU at B = 1 under
    "float32", then the card's "mixed" body against its "float32" one at
    B = 8 (same seed, so the same weights before the bf16 cast)."""
    import copy

    import torch

    from spotter_tpu_torch.ops.preprocess import device_rescale_normalize, resize_uint8
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    built = build_yolos_under("float32", seed)
    layers = built.module.config.num_hidden_layers
    gh, gw = built.module.config.grid_hw
    spec = built.preprocess_spec
    rng = np.random.default_rng(seed + 4)
    imgs = [resize_uint8(synthetic_photo(rng, 720, 960), spec.size) for _ in range(8)]
    x8 = device_rescale_normalize(torch.from_numpy(np.stack(imgs)), spec)
    cpu_model = built.module.eval()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_model(x8[:1])
        cpu_s = time.perf_counter() - t0
        reset_counts()
        got = gpu_model(x8[:1].to(device))
        torch.cuda.synchronize()
    launches = read_counts()
    for key in ("logits", "pred_boxes"):
        if not torch.isfinite(got[key]).all():
            raise AssertionError(f"non-finite {key} on the card")
    rec = {
        "phase": "yolos_parity", "model": YOLOS_NAME, "policy": "float32", "batch": 1,
        "compare": "card vs cpu", "tokens": got["logits"].shape[1] + 1 + gh * gw,
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "logits_max_abs_err": (got["logits"].cpu() - ref["logits"]).abs().max().item(),
        "boxes_max_abs_err": (got["pred_boxes"].cpu() - ref["pred_boxes"]).abs().max().item(),
        "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
        "logits_abs_max": ref["logits"].abs().max().item(),
        "same_argmax": bool(torch.equal(got["logits"].cpu()[..., :-1].argmax(-1),
                                        ref["logits"][..., :-1].argmax(-1))),
        "cpu_forward_s": cpu_s, "card_launches": launches,
    }
    emit(rec, log)
    records = [rec]
    check_launches(launches, "flash_attn_fp32", layers, "yolos card forward under float32")
    if not (rec["logits_max_abs_err"] <= PARITY_ATOL_LOGITS
            and rec["boxes_max_abs_err"] <= PARITY_ATOL_BOXES):
        raise AssertionError(f"yolos card vs CPU outside tolerance: {rec}")
    del cpu_model, built, ref
    x_off = torch.from_numpy(np.random.default_rng(seed + 5).uniform(
        -2, 2, (1, *YOLOS_OFF_NATIVE_HW, 3)).astype(np.float32)).to(device)
    rec = {"phase": "yolos_parity", "model": YOLOS_NAME, "policy": "float32", "batch": 1,
           **off_native_record(gpu_model, (x_off,), {"flash_attn_fp32": layers}, False,
                               {"logits": PARITY_ATOL_LOGITS, "pred_boxes": PARITY_ATOL_BOXES},
                               "yolos off-native under float32")}
    emit(rec, log)
    records.append(rec)

    mixed_model = build_yolos_under("mixed", seed).module.to(device).eval()
    outs, counts = {}, {}
    with torch.inference_mode():
        for policy, model in (("float32", gpu_model), ("mixed", mixed_model)):
            reset_counts()
            outs[policy] = model(x8.to(device))
            torch.cuda.synchronize()
            counts[policy] = read_counts()
    for policy in outs:
        check_launches(counts[policy], POLICY_KERNEL[policy], layers,
                       f"yolos card forward under {policy}")
    scale = outs["float32"]["logits"].abs().max().item()
    rec = {"phase": "yolos_parity", "model": YOLOS_NAME, "policy": "mixed", "batch": 1,
           **off_native_record(mixed_model, (x_off,), {"flash_attn_bf16": layers}, False,
                               {"logits": MIXED_RTOL_LOGITS * scale,
                                "pred_boxes": MIXED_ATOL_BOXES},
                               "yolos off-native under mixed")}
    emit(rec, log)
    records.append(rec)
    o32, o16 = outs["float32"], outs["mixed"]
    scale = o32["logits"].abs().max().item()
    rec = {
        "phase": "yolos_parity", "model": YOLOS_NAME, "policy": "mixed vs float32", "batch": 8,
        "compare": "card vs card",
        "logits_max_abs_err": (o16["logits"] - o32["logits"]).abs().max().item(),
        "boxes_max_abs_err": (o16["pred_boxes"] - o32["pred_boxes"]).abs().max().item(),
        "logits_abs_max": scale,
        "atol_logits": MIXED_RTOL_LOGITS * scale, "atol_boxes": MIXED_ATOL_BOXES,
        "argmax_agreement": (o16["logits"][..., :-1].argmax(-1)
                             == o32["logits"][..., :-1].argmax(-1)).float().mean().item(),
        "card_launches": counts,
    }
    emit(rec, log)
    records.append(rec)
    if not (rec["logits_max_abs_err"] <= rec["atol_logits"]
            and rec["boxes_max_abs_err"] <= MIXED_ATOL_BOXES):
        raise AssertionError(f"yolos mixed vs float32 outside tolerance: {rec}")
    del gpu_model, mixed_model, outs, got, x_off
    release_cuda_memory()
    return records


def phase_yolos_serve(log: list, seed: int, device: str = "cuda") -> dict:
    """yolos-base through InferenceEngine.detect and the response assembly,
    on requests of 1 and 8 decoded photos, under "float32" and "mixed". The
    counts are set to 0 after warmup and read after the requests."""
    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8
    from spotter_tpu_torch.serving.detector import assemble_response
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed + 5)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    requests = [photos[:1]] * 5 + [photos[:8]] * 5
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    rec = {"phase": "yolos_serve", "model": YOLOS_NAME, "device": device}
    for policy in ("float32", "mixed"):
        built = build_yolos_under(policy, seed)
        layers = built.module.config.num_hidden_layers
        engine = InferenceEngine(built, device=device)
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()  # count only this path's launches from here
        latencies, forwards = {1: [], 8: []}, 0
        for reqn, images in enumerate(requests):
            urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
            t0 = time.perf_counter()
            raw = engine.detect(images)
            resp = assemble_response(urls, raw)
            latencies[len(images)].append(time.perf_counter() - t0)
            forwards += -(-len(images) // engine.batch_buckets[-1])
            check_response(resp, raw, len(images))
        counts = read_counts()
        check_launches(counts, POLICY_KERNEL[policy], layers * forwards,
                       f"yolos engine path under {policy}")
        # device time per forward, after the counts were read
        t0 = time.perf_counter()
        pixels, _, sizes = batch_images_uint8(photos[:8], built.preprocess_spec,
                                           pool=engine.decode_pool)
        host_ms = (time.perf_counter() - t0) * 1e3
        px = torch.from_numpy(pixels).to(device)
        sz = torch.from_numpy(sizes).to(device)
        with torch.inference_mode():
            device_ms = {b: cuda_time_ms(lambda b=b: engine._forward(px[:b], sz[:b]), 5, flush)
                         for b in (1, 8)}
        rec[policy] = {
            "warmup_s": warmup_s, "forwards": forwards, "launches": counts,
            "launches_per_forward": counts[POLICY_KERNEL[policy]] / forwards,
            "latency_ms": {n: {"p50": statistics.median(v) * 1e3,
                               "p99": percentile(v, 0.99) * 1e3, "n": len(v)}
                           for n, v in latencies.items()},
            "img_per_s_8": 8 / statistics.median(latencies[8]),
            "batch8_host_resize_ms": host_ms,
            "device_forward_ms": device_ms,
            "detections_per_image": [len(d) for d in raw],
        }
        del engine, built, px, sz
        release_cuda_memory()
    emit(rec, log)
    return rec


def phase_yolos_http(log: list, seed: int, device: str = "cuda") -> dict:
    """yolos-base behind the port's standalone server, under "float32" and
    then "mixed": requests of 1 and 8 URLs, one at a time; each run's counts
    are set to 0 just before it and read just after."""
    import asyncio
    import tempfile

    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 6)
    rec = {"phase": "yolos_http", "model": YOLOS_NAME, "device": device}
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        for policy in ("float32", "mixed"):
            t0 = time.perf_counter()
            with precision_policy(policy):
                det = build_detector_app(YOLOS_NAME, device=device, seed=seed, warmup=True)
            bringup_s = time.perf_counter() - t0
            layers = det.engine.built.module.config.num_hidden_layers
            runs = [(policy, lambda: None, [("1", 1, 5, 1), ("8", 8, 5, 1)])]
            out = asyncio.run(drive_http(det, photo_dir, runs))
            lat = out["latency_ms"]
            rec[policy] = {
                "bringup_s": bringup_s, "healthz": out["healthz"],
                "latency_ms": latency_summary(lat),
                "img_per_s_8_urls": 8e3 / statistics.median(lat[f"{policy}:8"]),
                "fetch_decode_8_ms": out["fetch_decode_8_ms"],
                "engine_stage_ms": {k: v for k, v in out["metrics"].items()
                                    if k.startswith("stage_")},
                "mean_batch_size": out["metrics"]["mean_batch_size"],
                **out[policy],
            }
            del det
            release_cuda_memory()
            if out["healthz"] != 200:
                raise AssertionError(f"/healthz answered {out['healthz']} under {policy}")
            check_launches(out[policy]["launches"], POLICY_KERNEL[policy],
                           layers * out[policy]["forwards"], f"yolos /detect under {policy}")
    emit(rec, log)
    return rec


# --- Deformable-DETR ----------------------------------------------------------

DDETR_NAME = "SenseTime/deformable-detr"
# the kernel each SPOTTER_TPU_MSDA backend runs in both the encoder and the
# decoder ("xla": the gather-sum, under the default prep)
DDETR_BACKENDS = {"xla": "msda_gather_sum", **BACKEND_KERNEL}


def ddetr_expected(model, backend: str, forwards: int) -> dict:
    """Each kernel's launches over `forwards` Deformable-DETR forwards: one
    MSDA op per encoder and decoder layer (the separable kernel once per
    level of each), and no attention or class-logit kernel (the decoder's
    300-query self-attention is below the attention cutover)."""
    cfg = model.config
    ops = cfg.encoder_layers + cfg.decoder_layers
    per_op = backend_launches(backend, cfg.num_feature_levels)
    return {DDETR_BACKENDS[backend]: ops * per_op * forwards}


def ddetr_inputs(spec, photos, device=None):
    """Photos through the shortest-edge staging into the 1333x1333 bucket:
    (normalized NHWC pixels with the pad at exactly 0, pixel mask, valid
    (h, w), original sizes), on `device` (the CPU by default)."""
    import torch

    from spotter_tpu_torch.ops.preprocess import (
        batch_images_uint8,
        device_rescale_normalize_masked,
    )

    pixels, valid, sizes = batch_images_uint8(photos, spec)
    x, mask = device_rescale_normalize_masked(
        torch.from_numpy(pixels).to(device or "cpu"), torch.from_numpy(valid).to(device or "cpu"),
        spec)
    return x, mask, valid, sizes


def phase_ddetr_parity(log: list, seed: int, device: str = "cuda") -> list:
    """SenseTime/deformable-detr at full width, B = 1, a landscape listing
    photo staged into the 1333x1333 bucket (so the pixel mask, the valid
    ratios and the masked value tokens are the served path's): the card
    under xla, pallas_sep and pallas_gather, each against the CPU under xla
    (every backend computes the same function; the CPU sep plain version at
    this size is the slow part)."""
    import copy

    import torch

    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    built = build_detector(DDETR_NAME, tiny=False, seed=seed)
    rng = np.random.default_rng(seed + 11)
    x, mask, valid, _ = ddetr_inputs(built.preprocess_spec, [synthetic_photo(rng, 720, 960)])
    cpu_model = built.module.eval()
    gpu_model = copy.deepcopy(cpu_model).to(device)
    records = []
    try:
        msda.MSDA_BACKEND = "xla"
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(x, mask)
            cpu_s = time.perf_counter() - t0
        for backend in DDETR_BACKENDS:
            msda.MSDA_BACKEND = backend
            with torch.inference_mode():
                reset_counts()
                got = gpu_model(x.to(device), mask.to(device))
                torch.cuda.synchronize()
            launches = read_counts()
            for key in ("logits", "pred_boxes"):
                if not torch.isfinite(got[key]).all():
                    raise AssertionError(f"non-finite {key} on the card under {backend}")
            rec = {
                "phase": "ddetr_parity", "model": DDETR_NAME, "msda_backend": backend,
                "batch": 1, "compare": "card vs cpu (xla)", "bucket": list(x.shape[1:3]),
                "valid_hw": valid[0].tolist(), "mask_valid_share": mask.mean().item(),
                "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
                "logits_max_abs_err": (got["logits"].cpu() - ref["logits"]).abs().max().item(),
                "boxes_max_abs_err":
                    (got["pred_boxes"].cpu() - ref["pred_boxes"]).abs().max().item(),
                "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
                "logits_abs_max": ref["logits"].abs().max().item(),
                "cpu_forward_s": cpu_s, "card_launches": launches,
            }
            emit(rec, log)
            records.append(rec)
            check_counts(launches, ddetr_expected(gpu_model, backend, 1),
                         f"Deformable-DETR card forward under {backend}")
            if not (rec["logits_max_abs_err"] <= PARITY_ATOL_LOGITS
                    and rec["boxes_max_abs_err"] <= PARITY_ATOL_BOXES):
                raise AssertionError(f"Deformable-DETR card vs CPU outside tolerance: {rec}")
    finally:
        msda.MSDA_BACKEND = "auto"
        del gpu_model, cpu_model, built
        release_cuda_memory()
    return records


def phase_ddetr_serve(log: list, seed: int, device: str = "cuda") -> dict:
    """SenseTime/deformable-detr through InferenceEngine.detect and the
    response assembly: requests of 1 and 8 listing photos under xla,
    pallas_sep and pallas_gather. Each backend's counts are set to 0 just
    before its requests and read just after; then the device ms per forward
    at B = 1 and 8 and the host resize of 8 photos."""
    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8
    from spotter_tpu_torch.serving.detector import assemble_response
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed + 12)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    requests = [photos[:1]] * 3 + [photos[:8]] * 3
    built = build_detector(DDETR_NAME, tiny=False, seed=seed)
    engine = InferenceEngine(built, device=device)
    t0 = time.perf_counter()
    engine.warmup()
    rec = {"phase": "ddetr_serve", "model": DDETR_NAME, "device": device,
           "warmup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    pixels, valid, sizes = batch_images_uint8(photos[:8], built.preprocess_spec,
                                             pool=engine.decode_pool)
    rec["batch8_host_resize_ms"] = (time.perf_counter() - t0) * 1e3
    rec["valid_hw"] = valid.tolist()
    px, vd, sz = (torch.from_numpy(a).to(device) for a in (pixels, valid, sizes))
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    try:
        for backend in DDETR_BACKENDS:
            msda.MSDA_BACKEND = backend
            reset_counts()  # count only this backend's requests from here
            latencies, forwards = {1: [], 8: []}, 0
            for reqn, images in enumerate(requests):
                urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
                t0 = time.perf_counter()
                raw = engine.detect(images)
                resp = assemble_response(urls, raw)
                latencies[len(images)].append(time.perf_counter() - t0)
                forwards += -(-len(images) // engine.batch_buckets[-1])
                check_response(resp, raw, len(images))
            counts = read_counts()
            check_counts(counts, ddetr_expected(built.module, backend, forwards),
                         f"Deformable-DETR engine path under {backend}")
            with torch.inference_mode():
                device_ms = {b: cuda_time_ms(
                    lambda b=b: engine._forward(px[:b], sz[:b], valid=vd[:b]), 5, flush)
                    for b in (1, 8)}
            rec[backend] = {
                "forwards": forwards, "launches": counts,
                "launches_per_forward": {k: v / forwards for k, v in counts.items() if v},
                "latency_ms": {n: {"p50": statistics.median(v) * 1e3,
                                   "p99": percentile(v, 0.99) * 1e3, "n": len(v)}
                               for n, v in latencies.items()},
                "img_per_s_8": 8 / statistics.median(latencies[8]),
                "device_forward_ms": device_ms,
                "detections_per_image": [len(d) for d in raw],
            }
        # the default backend with the corner prep in the loc kernel: the
        # plain-torch prep is most of the encoder's MSDA time under xla
        msda.MSDA_BACKEND, msda.MSDA_PREP = "xla", "kernel"
        with torch.inference_mode():
            rec["device_forward_ms_xla_prep_kernel"] = {b: cuda_time_ms(
                lambda b=b: engine._forward(px[:b], sz[:b], valid=vd[:b]), 5, flush)
                for b in (1, 8)}
    finally:
        msda.MSDA_BACKEND, msda.MSDA_PREP = "auto", "xla"
    emit(rec, log)
    del engine, built, px, vd, sz
    release_cuda_memory()
    return rec


def phase_ddetr_http(log: list, seed: int, device: str = "cuda") -> dict:
    """SenseTime/deformable-detr behind the port's standalone server:
    requests of 1 and 8 URLs under xla, pallas_sep and pallas_gather; each
    run's counts are set to 0 just before it and read just after."""
    import asyncio

    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 13)
    t0 = time.perf_counter()
    det = build_detector_app(DDETR_NAME, device=device, seed=seed, warmup=True)
    bringup_s = time.perf_counter() - t0
    model = det.engine.built.module

    def backend(name: str):
        return lambda: setattr(msda, "MSDA_BACKEND", name)

    runs = [(name, backend(name), [("1", 1, 3, 1), ("8", 8, 3, 1)]) for name in DDETR_BACKENDS]
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        try:
            out = asyncio.run(drive_http(det, photo_dir, runs))
        finally:
            msda.MSDA_BACKEND = "auto"
    lat = out["latency_ms"]
    rec = {
        "phase": "ddetr_http", "model": DDETR_NAME, "device": device, "bringup_s": bringup_s,
        "healthz": out["healthz"], "latency_ms": latency_summary(lat),
        "img_per_s_8_urls": {name: 8e3 / statistics.median(lat[f"{name}:8"])
                             for name in DDETR_BACKENDS},
        "fetch_decode_8_ms": out["fetch_decode_8_ms"],
        "engine_stage_ms": {k: v for k, v in out["metrics"].items() if k.startswith("stage_")},
        "mean_batch_size": out["metrics"]["mean_batch_size"],
        **{name: out[name] for name in DDETR_BACKENDS},
    }
    emit(rec, log)
    del det
    release_cuda_memory()
    if out["healthz"] != 200:
        raise AssertionError(f"/healthz answered {out['healthz']}")
    for name in DDETR_BACKENDS:
        check_counts(out[name]["launches"],
                     ddetr_expected(model, name, out[name]["forwards"]),
                     f"Deformable-DETR /detect under {name}")
    return rec


# --- the DETR lineage: DETR, Table-Transformer, Conditional-DETR, DAB-DETR ----

DETR_NAME = "facebook/detr-resnet-50"
# the four models of slice 12, each at full width and depth: DETR-R50,
# Table-Transformer (ResNet-18, pre-norm, 15 queries), Conditional-DETR-R50
# and DAB-DETR-R50. No hand-written kernel may launch on their paths: the
# JAX package reaches no Pallas kernel there, and the encoder's masked
# self-attention (1764 tokens at the 1333x1333 bucket, past the attention
# cutover) must take the materialised path, as it does there.
DETR_LINEAGE = (DETR_NAME, "microsoft/table-transformer-detection",
                "microsoft/conditional-detr-resnet-50", "IDEA-Research/dab-detr-resnet-50")


def phase_detr_parity(log: list, seed: int, device: str = "cuda") -> list:
    """The four DETR-lineage models at full width, B = 1, a landscape listing
    photo staged into the 1333x1333 bucket with its pixel mask: the card
    against the CPU (TF32 off), logits and boxes (DAB-DETR: every decoder
    layer's boxes too) against the family gates; no kernel may launch."""
    import copy

    import torch

    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    photo = synthetic_photo(np.random.default_rng(seed + 14), 720, 960)
    records = []
    for name in DETR_LINEAGE:
        built = build_detector(name, tiny=False, seed=seed)
        x, mask, valid, _ = ddetr_inputs(built.preprocess_spec, [photo])
        cpu_model = built.module.eval()
        gpu_model = copy.deepcopy(cpu_model).to(device)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(x, mask)
            cpu_s = time.perf_counter() - t0
            reset_counts()
            got = gpu_model(x.to(device), mask.to(device))
            torch.cuda.synchronize()
        launches = read_counts()
        for key, value in got.items():
            if not torch.isfinite(value).all():
                raise AssertionError(f"{name}: non-finite {key} on the card")
        errs = {key: (got[key].cpu() - ref[key]).abs().max().item() for key in ref}
        rec = {
            "phase": "detr_parity", "model": name, "batch": 1, "compare": "card vs cpu",
            "bucket": list(x.shape[1:3]), "valid_hw": valid[0].tolist(),
            "encoder_tokens": -(-x.shape[1] // 32) * -(-x.shape[2] // 32),
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
            **{f"{key}_max_abs_err": err for key, err in errs.items()},
            "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
            "logits_abs_max": ref["logits"].abs().max().item(),
            "cpu_forward_s": cpu_s, "card_launches": launches,
        }
        if "aux_boxes" in ref:  # DAB-DETR: the smallest box side over the layers
            rec["aux_boxes_min_wh"] = ref["aux_boxes"][..., 2:].min().item()
        emit(rec, log)
        records.append(rec)
        check_counts(launches, {}, f"{name} card forward")
        bad = {k: e for k, e in errs.items()
               if e > (PARITY_ATOL_LOGITS if k == "logits" else PARITY_ATOL_BOXES)}
        if bad:
            raise AssertionError(f"{name} card vs CPU outside tolerance: {bad}")
        del gpu_model, cpu_model, built
        release_cuda_memory()
    return records


def phase_detr_serve(log: list, seed: int, device: str = "cuda", rounds: int = 3,
                     timing_iters: int = 5) -> list:
    """The four DETR-lineage models through InferenceEngine.detect and the
    response assembly: `rounds` requests of 1 listing photo and of 8, the
    counts set to 0 just before each model's requests and read just after
    (no kernel may launch); then the device ms per forward at B = 1 and 8,
    the median of `timing_iters`."""
    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops.preprocess import batch_images_uint8
    from spotter_tpu_torch.serving.detector import assemble_response
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed + 15)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    requests = [photos[:1]] * rounds + [photos[:8]] * rounds
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    records = []
    for name in DETR_LINEAGE:
        built = build_detector(name, tiny=False, seed=seed)
        engine = InferenceEngine(built, device=device)
        t0 = time.perf_counter()
        engine.warmup()
        rec = {"phase": "detr_serve", "model": name, "device": device,
               "warmup_s": time.perf_counter() - t0}
        pixels, valid, sizes = batch_images_uint8(photos[:8], built.preprocess_spec)
        px, vd, sz = (torch.from_numpy(a).to(device) for a in (pixels, valid, sizes))
        reset_counts()  # count only this model's requests from here
        latencies, forwards = {1: [], 8: []}, 0
        for reqn, images in enumerate(requests):
            urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
            t0 = time.perf_counter()
            raw = engine.detect(images)
            resp = assemble_response(urls, raw)
            latencies[len(images)].append(time.perf_counter() - t0)
            forwards += -(-len(images) // engine.batch_buckets[-1])
            check_response(resp, raw, len(images))
        counts = read_counts()
        check_counts(counts, {}, f"{name} engine path")
        with torch.inference_mode():
            device_ms = {b: cuda_time_ms(
                lambda b=b: engine._forward(px[:b], sz[:b], valid=vd[:b]), timing_iters, flush)
                for b in (1, 8)}
        rec.update({
            "forwards": forwards, "launches": counts,
            "latency_ms": {n: {"p50": statistics.median(v) * 1e3,
                               "p99": percentile(v, 0.99) * 1e3, "n": len(v)}
                           for n, v in latencies.items()},
            "img_per_s_8": 8 / statistics.median(latencies[8]),
            "device_forward_ms": device_ms,
            "detections_per_image": [len(d) for d in raw],
        })
        emit(rec, log)
        records.append(rec)
        del engine, built, px, vd, sz
        release_cuda_memory()
    return records


def phase_detr_http(log: list, seed: int, device: str = "cuda", rounds: int = 3) -> dict:
    """facebook/detr-resnet-50 behind the port's standalone server: `rounds`
    requests of 1 URL and of 8, the counts set to 0 just before and read just after (no
    kernel may launch). The score threshold stays the reference's: with
    random weights DETR's softmax over 92 classes keeps few boxes or none,
    and the response schema is checked all the same."""
    import asyncio

    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 16)
    t0 = time.perf_counter()
    det = build_detector_app(DETR_NAME, device=device, seed=seed, warmup=True)
    bringup_s = time.perf_counter() - t0
    runs = [("detr", lambda: None, [("1", 1, rounds, 1), ("8", 8, rounds, 1)])]
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        out = asyncio.run(drive_http(det, photo_dir, runs))
    lat = out["latency_ms"]
    rec = {
        "phase": "detr_http", "model": DETR_NAME, "device": device, "bringup_s": bringup_s,
        "healthz": out["healthz"], "latency_ms": latency_summary(lat),
        "img_per_s_8_urls": 8e3 / statistics.median(lat["detr:8"]),
        "fetch_decode_8_ms": out["fetch_decode_8_ms"],
        "engine_stage_ms": {k: v for k, v in out["metrics"].items() if k.startswith("stage_")},
        "mean_batch_size": out["metrics"]["mean_batch_size"],
        "detr": out["detr"],
    }
    emit(rec, log)
    del det
    release_cuda_memory()
    if out["healthz"] != 200:
        raise AssertionError(f"/healthz answered {out['healthz']}")
    check_counts(out["detr"]["launches"], {}, "DETR /detect")
    return rec


# --- ragged canvas packing --------------------------------------------------

# the ragged phase's mix of listing photos (h, w): 4:3 landscape (its resize
# 800x1066 snaps to 896x1152), 3:2 landscape (800x1200 -> 896x1280), 3:4
# portrait, a square and a 2:1 panorama (666x1333 -> 768x1333), a few photos
# of each; requests of 1-8 of them, drawn from --seed, from concurrent clients
RAGGED_SHAPES = ((768, 1024), (800, 1200), (1024, 768), (1000, 1000), (800, 1600))
RAGGED_PHOTOS_PER_SHAPE = 3
RAGGED_REQUESTS = 12
RAGGED_CLIENTS = 4
RAGGED_MODELS = (DDETR_NAME, DETR_NAME)
# the op-level check's batch: every kernel of rows 1-5 at one ragged canvas
RAGGED_OP_BATCH = 2


def ragged_requests(seed: int) -> list:
    """The mix: RAGGED_REQUESTS lists of photo names, 1-8 each."""
    rng = np.random.default_rng(seed + 22)
    names = [f"m{k}_{i}.jpg" for k in range(len(RAGGED_SHAPES))
             for i in range(RAGGED_PHOTOS_PER_SHAPE)]
    return [[str(n) for n in rng.choice(names, size=int(rng.integers(1, 9)))]
            for _ in range(RAGGED_REQUESTS)]


def write_ragged_photos(photo_dir: str, seed: int) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed + 23)
    for k, (h, w) in enumerate(RAGGED_SHAPES):
        for i in range(RAGGED_PHOTOS_PER_SHAPE):
            Image.fromarray(synthetic_photo(rng, h, w)).save(f"{photo_dir}/m{k}_{i}.jpg",
                                                             quality=90)


async def mix_burst(client, api: str, base: str, requests: list) -> list:
    """The mix's requests from RAGGED_CLIENTS concurrent clients, each
    answer checked against the wire schema; their latencies (ms)."""
    lat, todo = [], list(requests)

    async def one_client():
        while todo:
            names = todo.pop(0)
            urls = [f"{base}/{n}" for n in names]
            t = time.perf_counter()
            resp = await client.post(f"{api}/detect", json={"image_urls": urls})
            resp.raise_for_status()
            lat.append((time.perf_counter() - t) * 1e3)
            k = int(names[0][1:names[0].index("_")])
            check_http_response(resp.json(), urls, RAGGED_SHAPES[k])

    await asyncio.gather(*(one_client() for _ in range(RAGGED_CLIENTS)))
    return lat


def eager_pack(engine, chunk: list, canvas) -> list:
    """The engine's eager answer for one pack (uint8 arrays): staged into
    `canvas` as a served chunk is, the forward run eagerly (no graph) on the
    engine's stream, thresholded as `_finish` does."""
    import torch

    from spotter_tpu_torch.ops.postprocess import to_detections

    with engine._h2d_lock:
        staged = engine._put_staged(engine._stage_host(chunk, canvas))[0]
        with torch.inference_mode(), engine._on_stream():
            outs = [t.cpu() for t in engine._forward_flat(*staged)]
    scores, labels, boxes = (t.numpy() for t in outs)
    return [to_detections(scores[j], labels[j], boxes[j], engine.built.id2label,
                          engine.threshold) for j in range(len(chunk))]


def waste_since(metrics, n0: int) -> float | None:
    """The mean padding waste of the packs dispatched since the window held
    `n0` of them."""
    new = list(metrics._padding_waste_pct)[n0:]
    return sum(new) / len(new) if new else None


def int8_at_canvas(engine, photo_dir: str, names: list, other: dict, what: str) -> dict:
    """One B = 8 forward of the replica's model at a ragged canvas with
    SPOTTER_TPU_INT8 on (`conv_s8`, `amax_s8` and `quantize_nhwc_s8` at
    canvas-shaped activations): bit equal to its plain witness."""
    import torch
    from PIL import Image

    from spotter_tpu_torch.engine.scheduler import Scheduler
    from spotter_tpu_torch.ops.preprocess import (
        batch_images_uint8,
        device_rescale_normalize_masked,
        shortest_edge_size,
    )

    spec = engine.built.preprocess_spec
    photos = [np.asarray(Image.open(f"{photo_dir}/{n}").convert("RGB")) for n in names]
    dims = [shortest_edge_size(p.shape[:2], *spec.size) for p in photos]
    canvas = Scheduler(spec=spec, ragged=True)._snap((max(h for h, _ in dims),
                                                      max(w for _, w in dims)))
    px, valid, _ = batch_images_uint8(photos, spec, canvas_hw=canvas)
    model = engine.model
    inputs = device_rescale_normalize_masked(torch.from_numpy(px).to(engine.device),
                                             torch.from_numpy(valid).to(engine.device), spec)
    with torch.inference_mode(), int8_knobs("conv"):
        model(*inputs)
        got, calls, launches = int8_forward(model, inputs, other, what)
        with plain_int8(model):
            plain = model(*inputs)
        rec = {"canvas": list(canvas), "batch": len(photos), "calls_per_forward": calls,
               "launches_per_forward": launches,
               "plain_witness": witness_record(got, plain, what)}
    if not calls["conv"]:
        raise AssertionError(f"{what}: nothing quantized")
    return rec


async def ragged_replica(model_name: str, photo_dir: str, requests: list) -> dict:
    """One replica of `model_name` under SPOTTER_TPU_RAGGED=1 (see
    `phase_ragged`)."""
    import httpx
    import torch

    from spotter_tpu_torch.engine import graphs
    from spotter_tpu_torch.engine.engine import as_uint8_rgb
    from spotter_tpu_torch.engine.scheduler import Scheduler
    from spotter_tpu_torch.obs import compare

    exits = []
    runners, app, api, urls, bring = await bring_up_replica(photo_dir, exits,
                                                            model_name=model_name)
    out = {"model": model_name,
           "bring_up": {k: bring[k] for k in ("states", "bringup_s", "exits")}}
    try:
        if bring["states"][-2:] != ["verifying", "ready"] or exits:
            raise AssertionError(f"{model_name} ragged bring-up: {bring}")
        det, plane = app["detector"], app["integrity"]
        engine, metrics = det.engine, det.engine.metrics
        base = urls[0].rsplit("/", 1)[0]
        if not det.batcher.scheduler.ragged:
            raise AssertionError("the replica's scheduler is not ragged")
        calls = []
        real_detect = engine.detect

        def recording(images, canvas_hw=None, qset=None):
            # the pixels as staged, copied first: the detector then draws the
            # boxes into its photos
            arrays = [as_uint8_rgb(im) for im in images]
            got = real_detect(images, canvas_hw=canvas_hw, qset=qset)
            calls.append((arrays, canvas_hw, copy.deepcopy(got), engine.ran_buckets()))
            return got

        engine.detect = recording
        keys0 = set(engine.graphs)
        probe0 = plane.probe.snapshot()
        packs0 = metrics.snapshot()["ragged_packs_total"]
        legs = {}
        async with httpx.AsyncClient(timeout=300.0) as client:
            for leg in ("ragged_cold", "ragged_warm", "fifo"):
                if leg == "fifo":
                    # the same engine and batcher under the FIFO scheduler, the
                    # probe loop stopped (its pins are at its ragged canvas)
                    # and the last ragged pack done: the ragged path's counts
                    # and packs end here
                    await plane.aclose()
                    while det.batcher._in_flight or det.batcher._pump_busy:
                        await asyncio.sleep(0.01)
                    launches, ragged_calls = read_counts(), list(calls)
                    probe1 = plane.probe.snapshot()
                    ragged_sched = det.batcher.scheduler
                    det.batcher.scheduler = Scheduler(spec=ragged_sched.spec, ragged=False,
                                                      tenancy=ragged_sched.tenancy)
                n_calls, n_waste = len(calls), len(metrics._padding_waste_pct)
                if leg == "ragged_cold":
                    reset_counts()
                t0 = time.perf_counter()
                lat = await mix_burst(client, api, base, requests)
                legs[leg] = {"seconds": time.perf_counter() - t0,
                             **latency_summary({"detect": lat})["detect"],
                             "packs": len(calls) - n_calls,
                             "padding_waste_pct": waste_since(metrics, n_waste),
                             "canvases": sorted({str(c) for _, c, _, _ in calls[n_calls:]})}
            det.batcher.scheduler = ragged_sched
        engine.detect = real_detect
        out["legs"] = legs
        out["memory_reserved_bytes"] = torch.cuda.memory_reserved()
        snap = metrics.snapshot()
        out["ragged_packs"] = snap["ragged_packs_total"] - packs0
        canvases = {c for _, c, _, _ in ragged_calls if c is not None}
        out["distinct_canvases"] = sorted(list(c) for c in canvases)
        # captures: one per new (bucket, canvas) key, nothing else
        expected = {graphs.graph_key(engine._shape_key(ran[0], *c))
                    for _, c, _, ran in ragged_calls if c is not None} - keys0
        new = set(engine.graphs) - keys0
        out["captures"] = {"new_keys": len(new), "expected": len(expected),
                           "capture_s": sorted(engine.graphs[k].capture_s for k in new)}
        if new:
            out["captures"]["capture_s_mean"] = statistics.mean(out["captures"]["capture_s"])
        # the kernels on the ragged path: counts set to 0 just before the
        # cold leg, read after the warm leg and the probe's last pack
        layers_expected = (ddetr_expected(engine.model, "xla", len(ragged_calls))
                           if model_name == DDETR_NAME else {})
        out["launches"] = launches
        check_counts(launches, layers_expected, f"{model_name} ragged /detect")
        # each pack's answer against the engine's eager detect at its canvas
        worst, checked = None, 0
        for images, canvas, got, _ in ragged_calls:
            want = eager_pack(engine, images, canvas)
            for g, w in zip(got, want, strict=True):
                checked += 1
                reason = compare.diff_detections(w, g)
                if reason is not None:
                    worst = reason
        out["eager_check"] = {"packs": len(ragged_calls), "images": checked, "failure": worst}
        probe = plane.probe.snapshot()
        out["probe"] = {"canvas": probe["pinned_canvas"], "pinned_buckets": probe["pinned_buckets"],
                        "probes_during_mix": probe1["probes_total"] - probe0["probes_total"],
                        "failures": probe["failures_total"] - probe0["failures_total"]}
        int8_names = [f"m0_{i % RAGGED_PHOTOS_PER_SHAPE}.jpg" for i in range(8)]
        other = ddetr_expected(engine.model, "xla", 1) if model_name == DDETR_NAME else {}
        out["int8_at_canvas"] = int8_at_canvas(engine, photo_dir, int8_names, other,
                                               f"{model_name} int8 at a ragged canvas")
        out["exits"] = list(exits)
        problems = []
        if exits:
            problems.append(f"exits {exits}")
        if len(canvases) < 3:
            problems.append(f"{len(canvases)} distinct canvases")
        if out["ragged_packs"] <= 0:
            problems.append("no ragged pack")
        if new != expected:
            problems.append(f"captures {len(new)} against {len(expected)} new keys")
        if worst is not None:
            problems.append(f"a pack left compare's tolerance of its eager answer: {worst}")
        if out["probe"]["probes_during_mix"] < 1 or out["probe"]["failures"]:
            problems.append(f"probe {out['probe']}")
        if any(c is not None for _, c, _, _ in calls[len(ragged_calls):]):
            problems.append("a FIFO pack got a canvas")
        if problems:
            raise AssertionError(f"{model_name} ragged: {problems}; {out}")
    finally:
        for runner in reversed(runners):
            await runner.cleanup()
    return out


def ragged_ops(seed: int) -> list:
    """Rows 1-5 at a ragged canvas's level shapes (RAGGED_OP_CANVAS: not
    square, two levels odd): msda_gather_sum and msda_loc_sum at the
    Deformable-DETR encoder and decoder ops, msda_sep_sum and
    msda_hd_gather_sum at the encoder op, msda_fused_sum at the decoder's
    levels; each against its plain version (B = RAGGED_OP_BATCH, fp32 rows)."""
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    f32, b = torch.float32, RAGGED_OP_BATCH
    cases = []
    for label in RAGGED_OP_SHAPES:
        for kernel in ("msda_gather_sum", "msda_loc_sum"):
            cases.append(walk_op_case(label, b, f32, "default", seed, flush, kernel=kernel))
    cases.append(sep_case("ddetr_encoder_ragged", b, f32, "default", seed, flush))
    cases.append(hd_gather_case("ddetr_encoder_ragged", b, f32, "default", seed, flush))
    cases.append(fused_case(b, f32, "default", seed, flush, shapes=RAGGED_DDETR_SHAPES))
    for rec in cases:
        rec.update({"phase": "ragged_ops", "canvas": list(RAGGED_OP_CANVAS),
                    "levels": [list(hw) for hw in RAGGED_DDETR_SHAPES]})
    del flush
    release_cuda_memory()
    return cases


def phase_ragged(log: list, seed: int) -> dict:
    """Ragged canvas packing (SPOTTER_TPU_RAGGED=1) on Deformable-DETR and
    DETR-R50 at full width, seed-0 weights (the replica's bring-up builds
    seed 0), each a replica brought up through `make_app` with buckets
    (1, 8), the integrity gate and its probe at a 1 s cadence:

    1. the mix (`ragged_requests`, photos of RAGGED_SHAPES) from
       RAGGED_CLIENTS clients, cold (each new (bucket, canvas) runs eager
       and is captured), then again warm, then under the FIFO scheduler on
       the same engine (the probe loop stopped): p50/p99, packs, padding
       waste and canvases of each leg;
    2. checks: at least three distinct canvases; ragged_packs_total > 0;
       one capture per new (bucket, canvas) key; every ragged pack's answer
       within compare's tolerance of the engine's eager forward of its
       images at its canvas; the probe ran during the mix, never failed, no
       exit; the kernels' launches on the ragged path (Deformable-DETR:
       msda_gather_sum 12 a forward; DETR: none); capture seconds of each
       new key and torch.cuda.memory_reserved after the mix;
    3. one B = 8 forward of each model at the 4:3 photos' canvas with
       SPOTTER_TPU_INT8 on, bit equal to its plain witness;
    4. rows 1-5 at RAGGED_OP_CANVAS's level shapes (`ragged_ops`)."""
    import tempfile

    rec: dict = {"phase": "ragged", "nvidia_smi": nvidia_smi("name,power.limit"),
                 "shapes": [list(s) for s in RAGGED_SHAPES], "requests": ragged_requests(seed)}
    t0 = time.perf_counter()
    env = {"SPOTTER_TPU_RAGGED": "1", "SPOTTER_TPU_BATCH_BUCKETS": "1,8",
           "SPOTTER_TPU_INTEGRITY": None, "SPOTTER_TPU_PROBE_INTERVAL_S": "1",
           "SPOTTER_TPU_ATTEST_INTERVAL_S": "0", "SPOTTER_TPU_FAULTS": None,
           "SPOTTER_TPU_RAGGED_STEP": None, "SPOTTER_TPU_CACHE_MAX_MB": None}
    rec["models"] = {}
    with tempfile.TemporaryDirectory() as photo_dir:
        write_ragged_photos(photo_dir, seed)
        for name in RAGGED_MODELS:
            try:
                with replica_env(env):
                    rec["models"][name] = asyncio.run(
                        ragged_replica(name, photo_dir, rec["requests"]))
            finally:
                release_cuda_memory()
    rec["ops"] = ragged_ops(seed)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec, log)
    return rec


# --- OWLv2 and OWL-ViT ------------------------------------------------------

CLIP_BOS, CLIP_EOT = 49406, 49407  # CLIP's begin- and end-of-text ids, its two largest
# card vs CPU under "float32": objectness is a logit like the class logits
PARITY_ATOL_OBJECTNESS = 1e-3


def owl_prompts() -> list:
    """Every prompt the OWL phases encode: the default vocabulary's and the
    request query list's, through the zoo's template."""
    from spotter_tpu_torch.models.zoo import PROMPT_TEMPLATE, owlvit_query_labels

    return [PROMPT_TEMPLATE.format(q) for q in owlvit_query_labels() + list(OWL_QUERIES)]


def write_token_cache(seed: int, names=(OWLV2_NAME, OWLVIT_NAME)) -> list:
    """Write tokenized.json for each OWL MODEL_NAME in `names` (both OWL
    models by default) under $SPOTTER_TPU_CACHE, in the JAX package's
    format: per prompt, CLIP-shaped ids drawn from `seed` (begin-of-text, 3
    to 8 body ids below it, end-of-text, then 0 padding to the text tower's
    16 positions) and the mask over begin..end."""
    from spotter_tpu_torch.convert.tokens import tokenization_path
    from spotter_tpu_torch.models.configs import OwlViTTextConfig

    length = OwlViTTextConfig().max_position_embeddings
    rng = np.random.default_rng(seed + 7)
    table = {}
    for prompt in owl_prompts():
        body = rng.integers(1, CLIP_BOS, int(rng.integers(3, 9))).tolist()
        pad = length - len(body) - 2
        table[prompt] = {"ids": [CLIP_BOS, *body, CLIP_EOT] + [0] * pad,
                         "mask": [1] * (len(body) + 2) + [0] * pad}
    paths = []
    for name in names:
        path = tokenization_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(table))
        paths.append(str(path))
    return paths


@contextlib.contextmanager
def token_cache(seed: int, names=(OWLV2_NAME, OWLVIT_NAME)):
    """A temporary SPOTTER_TPU_CACHE holding the OWL prompts' token ids for
    `names` while the block runs; yields the files written."""
    old = os.environ.get("SPOTTER_TPU_CACHE")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["SPOTTER_TPU_CACHE"] = cache
        try:
            yield write_token_cache(seed, names)
        finally:
            if old is None:
                os.environ.pop("SPOTTER_TPU_CACHE", None)
            else:
                os.environ["SPOTTER_TPU_CACHE"] = old


def build_owl_under(name: str, policy: str, seed: int):
    from spotter_tpu_torch.models.registry import build_detector

    with precision_policy(policy):
        return build_detector(name, tiny=False, seed=seed)


def owl_pixels(spec, photos):
    """Photos through the spec's preprocess -> (B, H, W, 3) normalized fp32
    on the CPU: the uint8 resize plus the rescale for OWL-ViT's fixed spec,
    the host float pad-to-square warp for OWLv2's."""
    import torch

    from spotter_tpu_torch.ops.preprocess import (
        batch_images_float,
        batch_images_uint8,
        device_preprocess_supported,
        device_rescale_normalize,
    )

    if device_preprocess_supported(spec):
        return device_rescale_normalize(
            torch.from_numpy(batch_images_uint8(photos, spec)[0]), spec)
    return torch.from_numpy(batch_images_float(photos, spec)[0])


def owl_expected(model, forwards: int, attention: str) -> dict:
    """Each kernel's launches over `forwards` OWL forwards: one class-logit
    head each, and the attention kernel once per vision layer where the
    tower's sequence reaches the cutover (OWLv2's 3601 tokens, not B/32's 577)."""
    from spotter_tpu_torch.models.layers import FLASH_ATTN_MIN_SEQ

    vision = model.config.vision
    expected = {"owl_class_logits": forwards}
    if vision.grid * vision.grid + 1 >= FLASH_ATTN_MIN_SEQ:
        expected[attention] = vision.num_hidden_layers * forwards
    return expected


# a pass that runs once with every call of a kernel: the fp32 attention
# kernel's K/V split
COMPANIONS = {"flash_attn_fp32": "split_kv_tf32"}


def check_counts(counts: dict, expected: dict, what: str) -> None:
    """Each kernel launched exactly as `expected` says (a companion pass as
    often as its kernel), every other none."""
    expected = {**expected, **{COMPANIONS[k]: n for k, n in expected.items() if k in COMPANIONS}}
    if any(counts[name] != expected.get(name, 0) for name in counts):
        raise AssertionError(f"{what}: launches {counts}, expected {expected} and no other")


def owl_diffs(ref: dict, got: dict) -> dict:
    return {f"{key}_max_abs_err": (got[key].cpu() - ref[key].cpu()).abs().max().item()
            for key in ("logits", "pred_boxes", "objectness") if key in ref}


def phase_owl_parity(log: list, seed: int, device: str = "cuda") -> list:
    """OWLv2 and OWL-ViT B/32 at full width against the default vocabulary:
    the card against the CPU at B = 1 under "float32"; then, for OWLv2 at
    B = 8, the card's "mixed" vision tower against its "float32" one, and
    the unfused head (SPOTTER_TPU_OWL_FUSED=0) against the kernel."""
    import copy

    import torch

    from spotter_tpu_torch.ops import openvocab
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    rng = np.random.default_rng(seed + 8)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    records, kept = [], {}
    for name in (OWLV2_NAME, OWLVIT_NAME):
        built = build_owl_under(name, "float32", seed)
        x = owl_pixels(built.preprocess_spec, photos[:1])
        bank = built.query_embeds
        cpu_model = built.module.eval()
        gpu_model = copy.deepcopy(cpu_model).to(device)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(x, bank)
            cpu_s = time.perf_counter() - t0
            reset_counts()
            got = gpu_model(x.to(device), bank.to(device))
            torch.cuda.synchronize()
        launches = read_counts()
        for key, value in got.items():
            if not torch.isfinite(value).all():
                raise AssertionError(f"{name}: non-finite {key} on the card")
        rec = {
            "phase": "owl_parity", "model": name, "policy": "float32", "batch": 1,
            "compare": "card vs cpu", "patches": got["logits"].shape[1],
            "queries": got["logits"].shape[2],
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
            **owl_diffs(ref, got),
            "atol_logits": PARITY_ATOL_LOGITS, "atol_boxes": PARITY_ATOL_BOXES,
            "atol_objectness": PARITY_ATOL_OBJECTNESS,
            "logits_abs_max": ref["logits"].abs().max().item(),
            "same_argmax": bool(torch.equal(got["logits"].cpu().argmax(-1),
                                            ref["logits"].argmax(-1))),
            "cpu_forward_s": cpu_s, "card_launches": launches,
        }
        emit(rec, log)
        records.append(rec)
        check_counts(launches, owl_expected(gpu_model, 1, "flash_attn_fp32"),
                     f"{name} card forward under float32")
        if not (rec["logits_max_abs_err"] <= PARITY_ATOL_LOGITS
                and rec["pred_boxes_max_abs_err"] <= PARITY_ATOL_BOXES
                and rec.get("objectness_max_abs_err", 0.0) <= PARITY_ATOL_OBJECTNESS):
            raise AssertionError(f"{name} card vs CPU outside tolerance: {rec}")
        if name == OWLV2_NAME:
            kept = {"model": gpu_model, "bank": bank.to(device), "spec": built.preprocess_spec}
        del cpu_model, built, ref, got
        release_cuda_memory()

    gpu_model, bank = kept["model"], kept["bank"]
    x_off = owl_pixels(dataclasses.replace(kept["spec"], size=OWL_OFF_NATIVE_HW),
                       photos[:1]).to(device)
    rec = {"phase": "owl_parity", "model": OWLV2_NAME, "policy": "float32", "batch": 1,
           **off_native_record(gpu_model, (x_off, bank),
                               owl_expected(gpu_model, 1, "flash_attn_fp32"), True,
                               {"logits": PARITY_ATOL_LOGITS, "pred_boxes": PARITY_ATOL_BOXES,
                                "objectness": PARITY_ATOL_OBJECTNESS},
                               "OWLv2 off-native under float32")}
    emit(rec, log)
    records.append(rec)
    del x_off
    x8 = owl_pixels(kept["spec"], photos[:8]).to(device)
    mixed_model = build_owl_under(OWLV2_NAME, "mixed", seed).module.to(device).eval()
    outs, counts = {}, {}
    try:
        with torch.inference_mode():
            for label, model, fused in (("float32", gpu_model, "auto"),
                                        ("mixed", mixed_model, "auto"),
                                        ("float32 unfused", gpu_model, "0")):
                openvocab.OWL_FUSED = fused
                reset_counts()
                outs[label] = model(x8, bank)
                torch.cuda.synchronize()
                counts[label] = read_counts()
    finally:
        openvocab.OWL_FUSED = "auto"
    check_counts(counts["float32"], owl_expected(gpu_model, 1, "flash_attn_fp32"),
                 "OWLv2 card forward under float32 at B = 8")
    check_counts(counts["mixed"], owl_expected(mixed_model, 1, "flash_attn_bf16"),
                 "OWLv2 card forward under mixed at B = 8")
    unfused = owl_expected(gpu_model, 1, "flash_attn_fp32")
    unfused.pop("owl_class_logits")
    check_counts(counts["float32 unfused"], unfused, "OWLv2 card forward, OWL_FUSED=0")
    o32 = outs["float32"]
    scale = o32["logits"].abs().max().item()
    obj_scale = o32["objectness"].abs().max().item()
    rec = {
        "phase": "owl_parity", "model": OWLV2_NAME, "policy": "mixed vs float32", "batch": 8,
        "compare": "card vs card", **owl_diffs(o32, outs["mixed"]),
        "logits_abs_max": scale, "objectness_abs_max": obj_scale,
        "atol_logits": MIXED_RTOL_LOGITS * scale, "atol_boxes": MIXED_ATOL_BOXES,
        "atol_objectness": MIXED_RTOL_LOGITS * obj_scale,
        "argmax_agreement": (outs["mixed"]["logits"].argmax(-1)
                             == o32["logits"].argmax(-1)).float().mean().item(),
        "card_launches": {k: counts[k] for k in ("float32", "mixed")},
    }
    emit(rec, log)
    records.append(rec)
    if not (rec["logits_max_abs_err"] <= rec["atol_logits"]
            and rec["pred_boxes_max_abs_err"] <= MIXED_ATOL_BOXES
            and rec["objectness_max_abs_err"] <= rec["atol_objectness"]):
        raise AssertionError(f"OWLv2 mixed vs float32 outside tolerance: {rec}")
    rec = {
        "phase": "owl_parity", "model": OWLV2_NAME, "policy": "float32",
        "compare": "OWL_FUSED=0 vs auto (card)", "batch": 8,
        **owl_diffs(o32, outs["float32 unfused"]),
        "logits_abs_max": scale, "atol_logits": CLASS_LOGITS_RTOL * scale,
        "card_launches": counts["float32 unfused"],
    }
    emit(rec, log)
    records.append(rec)
    if not rec["logits_max_abs_err"] <= rec["atol_logits"]:
        raise AssertionError(f"OWLv2 unfused vs fused head outside tolerance: {rec}")
    del gpu_model, mixed_model, outs, kept
    release_cuda_memory()
    return records


def phase_owl_serve(log: list, seed: int, device: str = "cuda") -> dict:
    """OWLv2 through InferenceEngine.detect and the response assembly, under
    "float32" and "mixed": requests of 1 and 8 decoded photos against the
    default vocabulary, then 8 photos against a request's own query set
    (resolved through the text cache: its first request encodes, the next
    hit). The counts are set to 0 after warmup and read after the requests."""
    import torch

    from PIL import Image

    from spotter_tpu_torch.caching.text_cache import TextQueryResolver
    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.ops.preprocess import batch_images_float
    from spotter_tpu_torch.serving.detector import assemble_response, draw_detections
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(seed + 9)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    requests = [(photos[:1], False)] * 3 + [(photos[:8], False)] * 3 + [(photos[:8], True)] * 2
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    rec = {"phase": "owl_serve", "model": OWLV2_NAME, "device": device,
           "queries": list(OWL_QUERIES)}
    for policy, attention in POLICY_KERNEL.items():
        built = build_owl_under(OWLV2_NAME, policy, seed)
        engine = InferenceEngine(built, device=device)
        resolver = TextQueryResolver(built.model_name, built.text_encoder,
                                     metrics=engine.metrics)
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()  # count only this path's launches from here
        latencies, forwards, q_labels = {"1": [], "8": [], "8q": []}, 0, set()
        for reqn, (images, own_queries) in enumerate(requests):
            urls = [f"synthetic://{reqn}/{i}" for i in range(len(images))]
            t0 = time.perf_counter()
            if own_queries:
                qset = resolver.resolve(OWL_QUERIES)
                raw = engine.detect(images, qset=qset)
                q_labels |= {d["label"] for dets in raw for d in dets}
            else:
                raw = engine.detect(images)
                resp = assemble_response(urls, raw)
                check_response(resp, raw, len(images))
            latencies[f"{len(images)}{'q' if own_queries else ''}"].append(
                time.perf_counter() - t0)
            forwards += -(-len(images) // engine.batch_buckets[-1])
        counts = read_counts()
        check_counts(counts, owl_expected(built.module, forwards, attention),
                     f"OWLv2 engine path under {policy}")
        if not q_labels or not q_labels <= set(OWL_QUERIES):
            raise AssertionError(f"query-set labels {sorted(q_labels)} are not among "
                                 f"{list(OWL_QUERIES)}")
        # host preprocess and device time per forward, after the counts were read
        t0 = time.perf_counter()
        pixels, sizes = batch_images_float(photos[:8], built.preprocess_spec,
                                           pool=engine.decode_pool)
        host_ms = (time.perf_counter() - t0) * 1e3
        px = torch.from_numpy(pixels).to(device)
        sz = torch.from_numpy(sizes).to(device)
        with torch.inference_mode():
            device_ms = {b: cuda_time_ms(lambda b=b: engine._forward(px[:b], sz[:b]), 5, flush)
                         for b in (1, 8)}
        # the detector's drawing and JPEG encode of the last (query-set)
        # request's first photo, as /detect does it on the event loop
        t0 = time.perf_counter()
        dets = [{"label": d["label"], "box": d["box"]} for d in raw[0]]
        draw_detections(Image.fromarray(photos[0]), dets)
        draw_ms = (time.perf_counter() - t0) * 1e3
        snap = engine.metrics.snapshot()
        rec[policy] = {
            "warmup_s": warmup_s, "forwards": forwards, "launches": counts,
            "launches_per_forward": {k: v / forwards for k, v in counts.items() if v},
            "latency_ms": {n: {"p50": statistics.median(v) * 1e3,
                               "p99": percentile(v, 0.99) * 1e3, "n": len(v)}
                           for n, v in latencies.items()},
            "img_per_s_8": 8 / statistics.median(latencies["8"]),
            "batch8_host_preprocess_ms": host_ms,
            "device_forward_ms": device_ms,
            "detections_per_image": [len(d) for d in raw],
            "draw_first_image_ms": draw_ms, "draw_first_image_boxes": len(dets),
            "query_labels_seen": sorted(q_labels),
            "text_cache": {k: snap[k] for k in snap if k.startswith("text_cache")},
        }
        del engine, built, px, sz, resolver
        release_cuda_memory()
    emit(rec, log)
    return rec


def phase_owl_http(log: list, seed: int, device: str = "cuda") -> dict:
    """OWLv2 behind the port's standalone server under "float32": requests of
    1 and 8 URLs against the default vocabulary, then 8 URLs with their own
    `queries`; each run's counts are set to 0 just before it and read just
    after."""
    import asyncio

    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 10)
    t0 = time.perf_counter()
    with precision_policy("float32"):
        det = build_detector_app(OWLV2_NAME, device=device, seed=seed, warmup=True)
    bringup_s = time.perf_counter() - t0
    model = det.engine.built.module
    # one round of 8 URLs each: a random-init OWLv2 draws thousands of boxes
    # on every photo, ~30 s a request on the host
    runs = [("default", lambda: None, [("1", 1, 1, 1), ("8", 8, 1, 1)]),
            ("queries", lambda: None, [("8q", 8, 1, 1, OWL_QUERIES)])]
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        out = asyncio.run(drive_http(det, photo_dir, runs))
    lat = out["latency_ms"]
    rec = {
        "phase": "owl_http", "model": OWLV2_NAME, "device": device, "policy": "float32",
        "bringup_s": bringup_s, "healthz": out["healthz"],
        "latency_ms": latency_summary(lat),
        "img_per_s_8_urls": 8e3 / statistics.median(lat["default:8"]),
        "img_per_s_8_urls_queries": 8e3 / statistics.median(lat["queries:8q"]),
        "fetch_decode_8_ms": out["fetch_decode_8_ms"],
        "engine_stage_ms": {k: v for k, v in out["metrics"].items() if k.startswith("stage_")},
        "text_cache": {k: v for k, v in out["metrics"].items() if k.startswith("text_cache")},
        "mean_batch_size": out["metrics"]["mean_batch_size"],
        "default": out["default"], "queries": out["queries"],
    }
    emit(rec, log)
    del det
    release_cuda_memory()
    if out["healthz"] != 200:
        raise AssertionError(f"/healthz answered {out['healthz']}")
    for run in ("default", "queries"):
        check_counts(out[run]["launches"],
                     owl_expected(model, out[run]["forwards"], "flash_attn_fp32"),
                     f"OWLv2 /detect ({run})")
    return rec


# the other six families' checkpoints in the load phase: (registry family,
# the MODEL_NAME its directory is named after, weight file). Deformable-DETR
# with box refinement shares its heads with its decoder, which
# save_pretrained writes as pytorch_model.bin only
LOAD_FAMILIES = (
    ("yolos", YOLOS_NAME, "safetensors"),
    ("deformable_detr", "SenseTime/deformable-detr-with-box-refine", "bin"),
    ("detr", DETR_NAME, "safetensors"),
    ("conditional_detr", "microsoft/conditional-detr-resnet-50", "safetensors"),
    ("dab_detr", "IDEA-Research/dab-detr-resnet-50", "safetensors"),
    ("owlvit", OWLV2_NAME, "safetensors"),
)


def write_and_load(family: str, name: str, fmt: str, root: str, seed: int) -> tuple:
    """The seeded full-width `name` written as an HF checkpoint under
    `root`/`name` (tools/hf_checkpoint.py), then built from that directory
    through `build_detector`, as a user's MODEL_NAME=<dir> builds it. Times
    the load's parts apart (config read and from_hf; file read and rule
    conversion; load_from_jax into the module) and the whole build, and
    fails unless the loaded state dict equals the seeded one bit for bit.
    Returns (seeded, loaded, record)."""
    import copy

    import torch

    from spotter_tpu_torch.convert import loader
    from spotter_tpu_torch.convert.checkpoint_io import read_checkpoint
    from spotter_tpu_torch.convert.from_jax import load_from_jax
    from spotter_tpu_torch.models.registry import build_detector, family_for
    from spotter_tpu_torch.tools.hf_checkpoint import write_checkpoint

    seeded = build_detector(name, tiny=False, seed=seed)
    path = os.path.join(root, name)
    t0 = time.perf_counter()
    info = write_checkpoint(seeded.module, family, path, fmt)
    write_s = time.perf_counter() - t0
    if family_for(path).name != family:
        raise AssertionError(f"{path} routes to {family_for(path).name}, not {family}")
    t0 = time.perf_counter()
    cfg, hf = loader.read_config(family, path)
    t1 = time.perf_counter()
    params = loader.convert_checkpoint(path, loader.FAMILIES[family][1](cfg, hf), family)
    t2 = time.perf_counter()
    target = copy.deepcopy(seeded.module)
    t3 = time.perf_counter()
    load_from_jax(target, params)
    t4 = time.perf_counter()
    del target, params
    loaded = build_detector(path, tiny=False)
    build_s = time.perf_counter() - t4
    if cfg != seeded.module.config or loaded.module.config != cfg:
        raise AssertionError(f"{family}: the checkpoint's config is not the seeded model's")
    if loaded.id2label != seeded.id2label:
        raise AssertionError(f"{family}: the checkpoint's labels are not the seeded model's")
    a, b = seeded.module.state_dict(), loaded.module.state_dict()
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    if set(a) != set(b) or unequal:
        raise AssertionError(f"{family}: loaded weights differ from the seeded ones: "
                             f"{unequal[:5]} {sorted(set(a) ^ set(b))[:5]}")
    # the tied pairs as the file holds them: save_pretrained's copy only
    file_keys = list(read_checkpoint(path))
    tied = {prefix: sum(k.startswith(prefix) for k in file_keys)
            for pair in loader.TIED.get(family, ()) for prefix in pair}
    if family in ("rtdetr", "dab_detr"):
        (rule_side, twin), *_ = loader.TIED[family]
        if tied[rule_side] or not tied[twin]:
            raise AssertionError(f"{family}: the file should hold {twin}* and no {rule_side}*: "
                                 f"{tied}")
    rec = {
        "family": family, "model": name, "format": fmt, "files": info["files"],
        "bytes": info["bytes"], "keys": info["keys"], "tied_keys_in_file": tied,
        "write_s": write_s, "config_s": t1 - t0, "read_convert_s": t2 - t1,
        "load_from_jax_s": t4 - t3, "load_s": (t1 - t0) + (t2 - t1) + (t4 - t3),
        "build_s": build_s, "state_dict_equal": True, "labels": len(loaded.id2label),
    }
    return seeded, loaded, rec


def model_inputs(built, photos, device: str) -> tuple:
    """A batch of photos as the engine hands them to the model: staged by the
    family's spec, with the pixel mask where it takes one and the vocabulary's
    embeddings for OWL."""
    import torch

    from spotter_tpu_torch.ops.preprocess import batch_images_uint8, device_rescale_normalize

    spec = built.preprocess_spec
    if built.needs_mask:
        x, mask, _, _ = ddetr_inputs(spec, photos, device)
        return x, mask
    if built.query_embeds is not None:
        return owl_pixels(spec, photos).to(device), built.query_embeds.to(device), None
    return (device_rescale_normalize(
        torch.from_numpy(batch_images_uint8(photos, spec)[0]).to(device), spec),)


def outputs_diff(ref: dict, got: dict) -> dict:
    """Max abs difference of each tensor output, and whether all are equal."""
    import torch

    keys = [k for k, v in ref.items() if torch.is_tensor(v)]
    errs = {k: (got[k].float() - ref[k].float()).abs().max().item() for k in keys}
    return {"max_abs_err": errs,
            "bit_equal": all(torch.equal(got[k], ref[k]) for k in keys)}


def family_expected(family: str, model) -> dict:
    """Each kernel's launches in one forward of `family` under the defaults
    (float32, the `xla` prep)."""
    if family == "rtdetr":
        return {"msda_gather_sum": model.config.decoder_layers}
    if family == "yolos":
        return {"flash_attn_fp32": model.config.num_hidden_layers}
    if family == "owlvit":
        return owl_expected(model, 1, "flash_attn_fp32")
    if family == "deformable_detr":
        return ddetr_expected(model, "xla", 1)
    return {}


def load_family(family: str, name: str, fmt: str, root: str, seed: int, photo,
                device: str) -> dict:
    """One family's checkpoint written, loaded and run at B = 1 on the card
    beside the seeded model: the outputs must be equal (the same card and
    kernels on the same weights), and the loaded forward must launch its
    family's kernels as the seeded path does."""
    import torch

    seeded, loaded, rec = write_and_load(family, name, fmt, root, seed)
    outs = {}
    with torch.inference_mode():
        for key, built in (("seeded", seeded), ("loaded", loaded)):
            model = built.module.to(device)
            inputs = model_inputs(built, [photo], device)
            reset_counts()
            outs[key] = {k: v.cpu() for k, v in model(*inputs).items() if torch.is_tensor(v)}
            torch.cuda.synchronize()
            rec[f"{key}_launches"] = read_counts()
            built.module.to("cpu")
    rec.update(outputs_diff(outs["seeded"], outs["loaded"]))
    for key, value in outs["loaded"].items():
        if not torch.isfinite(value.float()).all():
            raise AssertionError(f"{family}: non-finite {key} from the loaded checkpoint")
    check_counts(rec["loaded_launches"], family_expected(family, loaded.module),
                 f"{family} loaded from its checkpoint")
    if not rec["bit_equal"]:
        raise AssertionError(f"{family}: the loaded model's B = 1 forward differs from the "
                             f"seeded one's: {rec['max_abs_err']}")
    del seeded, loaded
    release_cuda_memory()
    return rec


def phase_load(log: list, seed: int, device: str = "cuda", rounds: int = 2,
               kernel_rounds: int = 1) -> dict:
    """Every family built from a local HF checkpoint (MODEL_NAME=<dir>), as
    a user serves a trained model, with the seeded model written into that
    directory first (tools/hf_checkpoint.py: model.safetensors without the
    tied twins, and config.json). RT-DETRv2-R101 at full width and depth:
    the loaded weights equal the seeded ones bit for bit; 8 photos through
    InferenceEngine.detect under `xla` give the seeded engine's detections,
    and its forward the seeded logits and boxes; the standalone replica
    serves POST /detect for 1 and 8 URLs under `fused` and `kernel`; rows
    1-3 launch as on the seeded paths. The other six families (YOLOS,
    Deformable-DETR with box refinement as pytorch_model.bin, DETR,
    Conditional-DETR, DAB-DETR without its bbox_predictor twin, OWLv2) at
    full width: built from their checkpoints and one B = 1 forward equal to
    the seeded model's. Prints each load's seconds (config, file read and
    conversion, load_from_jax apart) and the checkpoint's bytes. `rounds`:
    the timed engine requests and the /detect rounds under `fused`;
    `kernel_rounds` those under `kernel`."""
    import asyncio

    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.serving.app import build_detector_app

    rng = np.random.default_rng(seed + 20)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    msda.MSDA_PREP = "xla"
    out = {"phase": "load", "device": device,
           "card": nvidia_smi("name,power.limit") if device == "cuda" else None}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        seeded, loaded, rec = write_and_load("rtdetr", MODEL_NAME, "safetensors", root, seed)
        layers = loaded.module.config.decoder_layers
        engines = {"seeded": InferenceEngine(seeded, device=device),
                   "loaded": InferenceEngine(loaded, device=device)}
        with torch.inference_mode():
            raw = {}
            for key, engine in engines.items():
                engine.warmup()
                raw[key] = engine.model(*model_inputs(engine.built, photos, device))
            rec["batch8_forward"] = {**parity_record(raw["seeded"], raw["loaded"], 8),
                                     **outputs_diff(raw["seeded"], raw["loaded"])}
        check_parity(rec["batch8_forward"], "loaded RT-DETR vs seeded at B = 8")
        del raw
        # the engine path: `rounds` requests of 8 photos each after an untimed one
        dets, lat, counts = {}, {}, {}
        for key, engine in engines.items():
            engine.detect(photos)
            reset_counts()
            lat[key] = []
            for _ in range(rounds):
                t = time.perf_counter()
                dets[key] = engine.detect(photos)
                lat[key].append((time.perf_counter() - t) * 1e3)
            counts[key] = read_counts()
        check_launches(counts["loaded"], "msda_gather_sum", layers * rounds, "the loaded engine")
        if dets["loaded"] != dets["seeded"]:
            raise AssertionError("the loaded engine's detections differ from the seeded one's")
        rec.update({
            "engine_batch8_p50_ms": {k: statistics.median(v) for k, v in lat.items()},
            "engine_latency_ms": lat, "engine_launches": counts["loaded"],
            "detections_equal": True, "detections": sum(len(d) for d in dets["loaded"]),
        })
        del engines, seeded, loaded
        release_cuda_memory()

        # the replica's /detect on MODEL_NAME=<dir>, under fused, then kernel
        path = os.path.join(root, MODEL_NAME)
        det = build_detector_app(path, device=device, warmup=True)

        def prep(name: str):
            return lambda: setattr(msda, "MSDA_PREP", name)

        runs = [("fused", prep("fused"), [("1", 1, rounds, 1), ("8", 8, rounds, 1)]),
                ("kernel", prep("kernel"), [("1", 1, kernel_rounds, 1),
                                            ("8", 8, kernel_rounds, 1)])]
        with tempfile.TemporaryDirectory() as photo_dir:
            write_photos(photo_dir, rng)
            try:
                http = asyncio.run(drive_http(det, photo_dir, runs))
            finally:
                msda.MSDA_PREP = "xla"
        for prep_name, kernel in (("fused", "msda_fused_sum"), ("kernel", "msda_loc_sum")):
            check_launches(http[prep_name]["launches"], kernel,
                           layers * http[prep_name]["forwards"], f"loaded /detect, {prep_name}")
        if http["healthz"] != 200:
            raise AssertionError(f"/healthz answered {http['healthz']}")
        rec["http"] = {"latency_ms": latency_summary(http["latency_ms"]),
                       "fused": http["fused"], "kernel": http["kernel"]}
        rec["seconds"] = time.perf_counter() - t0
        del det
        release_cuda_memory()
        out["rtdetr"] = rec
        out["launches"] = {"msda_gather_sum": counts["loaded"]["msda_gather_sum"],
                           "msda_fused_sum": http["fused"]["launches"]["msda_fused_sum"],
                           "msda_loc_sum": http["kernel"]["launches"]["msda_loc_sum"]}

        photo = synthetic_photo(np.random.default_rng(seed + 21), 720, 960)
        out["families"] = []
        for family, name, fmt in LOAD_FAMILIES:
            t0 = time.perf_counter()
            names = (name, os.path.join(root, name)) if family == "owlvit" else ()
            with token_cache(seed, names):
                fam = load_family(family, name, fmt, root, seed, photo, device)
            fam["seconds"] = time.perf_counter() - t0
            out["families"].append(fam)
            shutil.rmtree(os.path.join(root, name.split("/")[0]), ignore_errors=True)
    emit(out, log)
    return out


# --- precision policies -------------------------------------------------------

# RT-DETR's legs: (policy, SPOTTER_TPU_REP_FUSE), each policy at its default
# fusion ("bfloat16" fuses), then "bfloat16" unfused
RTDETR_POLICY_LEGS = (("mixed", None), ("bfloat16", None), ("bfloat16", "0"))
# the card against the CPU under a policy, at full width: logits (of the
# largest), boxes (absolute). The CPU tests' port-vs-JAX bounds are set at
# the tiny depth (1 % / 3e-3 "mixed"); cuDNN's bf16 convolutions and the
# CPU's round each output once but sum in other orders, and at full depth
# (ResNet-101-vd's 100 convolutions) those 1-ulp differences compound: on
# an H100 80GB HBM3 (700 W), "mixed" measured 3.8 % / 1.04e-2, encoder
# scores 1.9 % and 91 % of the queries matched (PERF.md). The gates below
# are the card-vs-float32 ones (the same drift's upper bound).
POLICY_TOL = {"mixed": (0.1, 0.05), "bfloat16": (0.25, 0.1)}
# the card's policy against its own "float32" forward at B = 8 (the same
# seeded weights before the bf16 cast): logits (of the largest), boxes
POLICY_VS_FLOAT32 = {"mixed": (0.1, 0.05), "bfloat16": (0.25, 0.1)}
MATCH_RADIUS = 1e-2  # a query matches the other side's nearest selected box within this
MIN_MATCHED_SHARE = 0.75
POLICY_ROUNDS = 2  # timed engine requests, and /detect rounds of each size, a leg


def forward_with_scores(model, x):
    """RT-DETR's outputs and its encoder scores before the top-k (the
    largest class logit of every source position), through a hook."""
    seen = {}

    def keep(module, args, output) -> None:  # returns None: the output stays as it is
        seen["scores"] = output.float().amax(-1)

    hook = model.enc_score_head.register_forward_hook(keep)
    try:
        out = model(x)
    finally:
        hook.remove()
    return out, seen["scores"]


def matched_record(ref: dict, got: dict, b: int) -> dict:
    """As tests/test_torch_precision_models.py compares RT-DETR under a
    policy: per image, each of `got`'s selected queries matched to `ref`'s
    nearest selected box (within MATCH_RADIUS); the matched share, and the
    logits' and boxes' max abs error over the matched queries; plus the
    sorted top-k scores' max abs error."""
    shares, d_logits, d_boxes, d_topk = [], 0.0, 0.0, 0.0
    for i in range(b):
        rb, gb = ref["enc_topk_bboxes"][i].float().cpu(), got["enc_topk_bboxes"][i].float().cpu()
        dist, j = (gb[:, None] - rb[None]).abs().amax(-1).min(1)
        ok = dist <= MATCH_RADIUS
        shares.append(ok.float().mean().item())
        if ok.any():
            d_logits = max(d_logits, (got["logits"][i].cpu()[ok]
                                      - ref["logits"][i].cpu()[j[ok]]).abs().max().item())
            d_boxes = max(d_boxes, (got["pred_boxes"][i].cpu()[ok]
                                    - ref["pred_boxes"][i].cpu()[j[ok]]).abs().max().item())
        topk = [o["enc_topk_logits"][i].float().cpu().amax(-1).sort().values for o in (ref, got)]
        d_topk = max(d_topk, (topk[0] - topk[1]).abs().max().item())
    return {"matched_share": shares, "logits_max_abs_err": d_logits, "boxes_max_abs_err": d_boxes,
            "logits_abs_max": ref["logits"].abs().max().item(), "sorted_topk_max_abs_err": d_topk}


def check_policy_record(rec: dict, logit_tol: float, box_tol: float, what: str) -> None:
    scale = rec["logits_abs_max"]
    bad = [k for k in ("logits_max_abs_err", "sorted_topk_max_abs_err", "scores_max_abs_err")
           if k in rec and not rec[k] <= logit_tol * scale]
    if bad or not rec["boxes_max_abs_err"] <= box_tol or min(
            rec.get("matched_share", [1.0])) < MIN_MATCHED_SHARE:
        raise AssertionError(f"{what}: outside tolerance (logits {logit_tol} of {scale}, boxes "
                             f"{box_tol}, matched share >= {MIN_MATCHED_SHARE}): {rec}")


def rtdetr_policy_leg(policy: str, rep_fuse, seed: int, photos, x8, ref_scores, flush,
                      photo_dir: str, device: str) -> dict:
    """One RT-DETRv2-R101 leg at full width under `policy`: weights at the
    policy's dtypes; the card against the CPU at B = 1 (default legs);
    rows 1-3 in their one-pass mode, 6 launches a forward under each prep;
    device ms at B = 1 and 8, stages and top kernels at B = 8 (torch.profiler,
    tools/profile_forward.py); "mixed"'s encoder scores against "float32"'s
    at B = 8; the engine on 8 photos; /detect for 1 and 8 URLs under fused
    (default legs)."""
    import asyncio
    import copy

    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.models.rtdetr import rep_fuse_default
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.serving.app import build_detector_app
    from spotter_tpu_torch.tools import profile_forward
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    compute = torch.bfloat16 if policy == "bfloat16" else torch.float32
    rec = {"policy": policy, "rep_fuse_env": rep_fuse}
    with precision_policy(policy, rep_fuse):
        built = build_detector(MODEL_NAME, tiny=False, seed=seed)
        module = built.module
        layers = module.config.decoder_layers
        # the layers' compute dtypes (ConvNorm kernels are fp32 masters, cast at use)
        dtypes = {"backbone": module.backbone.stem0.dtype,
                  "encoder": module.fpn_block0.bottleneck0.conv1.dtype,
                  "decoder": module.decoder_layer0.fc1.weight.dtype}
        rec["compute_dtypes"] = {k: str(v).removeprefix("torch.") for k, v in dtypes.items()}
        if dtypes != {"backbone": torch.bfloat16, "encoder": compute, "decoder": compute}:
            raise AssertionError(f"RT-DETR under {policy} built at {dtypes}")
        rec["rep_fuse"] = rep_fuse_default(compute)
        rec["msda_precision"] = msda.msda_precision()
        if rec["msda_precision"] != "default":
            raise AssertionError(f"MSDA precision under {policy}: {rec['msda_precision']}")
        cpu_model = copy.deepcopy(module).eval() if rep_fuse is None else None
        model = module.to(device).eval()
        x1 = x8[:1]
        with torch.inference_mode():
            if cpu_model is not None:
                t0 = time.perf_counter()
                ref1, ref_scores1 = forward_with_scores(cpu_model, x1.cpu())
                rec["cpu_forward_s"] = time.perf_counter() - t0
                got1, scores1 = forward_with_scores(model, x1)
                card_cpu = matched_record(ref1, got1, 1)
                card_cpu["scores_max_abs_err"] = (scores1.cpu() - ref_scores1).abs().max().item()
                rec["card_vs_cpu_b1"] = card_cpu
                check_policy_record(card_cpu, *POLICY_TOL[policy],
                                    f"RT-DETR {policy}: card vs CPU at B = 1")
                del cpu_model, ref1, got1
            prep_launches = {}
            for prep in msda.MSDA_PREP_VALUES:
                msda.MSDA_PREP = prep
                reset_counts()
                got = model(x1)
                torch.cuda.synchronize()
                counts = read_counts()
                check_launches(counts, PREP_KERNEL[prep], layers,
                               f"RT-DETR {policy} forward under {prep}")
                prep_launches[prep] = counts[PREP_KERNEL[prep]]
                if not (torch.isfinite(got["logits"]).all() and torch.isfinite(got["pred_boxes"]).all()):
                    raise AssertionError(f"RT-DETR {policy}: non-finite outputs under {prep}")
            msda.MSDA_PREP = "xla"
            rec["launches_per_forward_by_prep"] = prep_launches
            rec["device_forward_ms"] = {
                b: cuda_time_ms(lambda b=b: model(x8[:b]), 5, flush) for b in (1, 8)}
            prof = profile_forward.profile_backend(MODEL_NAME, model, (x8,))
            rec["stages_ms_b8"] = prof["stages_ms"]
            rec["busy_share_b8"] = prof["profiler"]["busy_share"]
            rec["top_kernels_b8"] = prof["profiler"]["top_kernels"][:12]
            rec["host_ms_b8"] = prof["profiler"]["host_ms_per_forward"]
            rec["top_host_ops_b8"] = prof["profiler"]["top_host_ops"][:10]
            if policy == "mixed" and rep_fuse is None:
                _, scores8 = forward_with_scores(model, x8)
                err = (scores8 - ref_scores).abs().max().item()
                scale = ref_scores.abs().max().item()
                rec["vs_float32_b8_encoder_scores"] = {"max_abs_err": err, "abs_max": scale}
                if not err <= POLICY_VS_FLOAT32[policy][0] * scale:
                    raise AssertionError(f"RT-DETR mixed vs float32 encoder scores: {err} of {scale}")
        # the engine: 8 photos, 5 requests after one untimed
        engine = InferenceEngine(built, device=device)
        engine.warmup()
        engine.detect(photos[:8])
        reset_counts()
        lat = []
        for _ in range(POLICY_ROUNDS):
            t0 = time.perf_counter()
            engine.detect(photos[:8])
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        check_launches(counts, "msda_gather_sum", layers * POLICY_ROUNDS,
                       f"RT-DETR {policy} engine")
        rec["engine_batch8_p50_ms"] = statistics.median(lat)
        rec["engine_launches"] = counts["msda_gather_sum"]
        del engine, model, built, module
        release_cuda_memory()
        if rep_fuse is None:  # the replica's /detect under fused
            det = build_detector_app(MODEL_NAME, device=device, seed=seed, warmup=True)
            runs = [("fused", lambda: setattr(msda, "MSDA_PREP", "fused"),
                     [("1", 1, POLICY_ROUNDS, 1), ("8", 8, POLICY_ROUNDS, 1)])]
            try:
                http = asyncio.run(drive_http(det, photo_dir, runs))
            finally:
                msda.MSDA_PREP = "xla"
            check_launches(http["fused"]["launches"], "msda_fused_sum",
                           layers * http["fused"]["forwards"], f"RT-DETR {policy} /detect")
            rec["http_fused"] = {"latency_ms": latency_summary(http["latency_ms"]),
                                 "launches": http["fused"]["launches"]["msda_fused_sum"],
                                 "forwards": http["fused"]["forwards"]}
            del det
            release_cuda_memory()
    return rec


def policy_family_leg(name: str, seed: int, photos, flush, photo_dir: str,
                      device: str) -> dict:
    """Deformable-DETR or a DETR-lineage model at full width, B = 8: the
    card's "mixed" and "bfloat16" forwards against its "float32" one (the
    same seeded weights) within POLICY_VS_FLOAT32, device ms each, and the
    launches: 12 one-pass gather-sums for Deformable-DETR (6 encoder and 6
    decoder ops), none for the lineage; Deformable-DETR under "mixed" also
    once under pallas_sep (48 one-pass separable launches). Under each bf16
    policy the same model then serves 8 photos through InferenceEngine.detect
    and POST /detect for 1 and 8 URLs (the standalone app on it), with the
    same launches a forward."""
    import asyncio

    import torch

    from spotter_tpu_torch.engine.batcher import MicroBatcher
    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.serving.detector import AmenitiesDetector
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rec = {"model": name}
    outs = {}
    for policy in ("float32", "mixed", "bfloat16"):
        with precision_policy(policy):
            built = build_detector(name, tiny=False, seed=seed)
            model = built.module.to(device).eval()
            inputs = model_inputs(built, photos[:8], device)
            expected = (ddetr_expected(model, "xla", 1) if name == DDETR_NAME else {})
            with torch.inference_mode():
                reset_counts()
                out = model(*inputs)
                torch.cuda.synchronize()
                counts = read_counts()
                check_counts(counts, expected, f"{name} under {policy}")
                outs[policy] = {k: v.float().cpu() for k, v in out.items()}
                leg = {"device_forward_ms_b8": cuda_time_ms(lambda: model(*inputs), 5, flush),
                       "launches": {k: v for k, v in counts.items() if v},
                       "msda_precision": msda.msda_precision()}
                if policy != "float32":
                    ref = outs["float32"]
                    leg["logits_max_abs_err"] = (outs[policy]["logits"] - ref["logits"]).abs().max().item()
                    leg["logits_abs_max"] = ref["logits"].abs().max().item()
                    leg["boxes_max_abs_err"] = (outs[policy]["pred_boxes"]
                                                - ref["pred_boxes"]).abs().max().item()
                    check_policy_record(leg, *POLICY_VS_FLOAT32[policy],
                                        f"{name} {policy} vs float32 at B = 8")
                if name == DDETR_NAME and policy == "mixed":
                    msda.MSDA_BACKEND = "pallas_sep"
                    try:
                        reset_counts()
                        model(*inputs)
                        torch.cuda.synchronize()
                        sep = read_counts()
                    finally:
                        msda.MSDA_BACKEND = "auto"
                    check_counts(sep, ddetr_expected(model, "pallas_sep", 1),
                                 f"{name} mixed under pallas_sep")
                    leg["pallas_sep_launches"] = sep["msda_sep_sum"]
            if policy != "float32":
                engine = InferenceEngine(built, device=device)
                engine.warmup()
                reset_counts()
                t0 = time.perf_counter()
                dets = engine.detect(photos[:8])
                leg["engine_batch8_ms"] = (time.perf_counter() - t0) * 1e3
                check_counts(read_counts(), expected, f"{name} {policy} engine")
                det = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=5.0))
                http = asyncio.run(drive_http(det, photo_dir, [
                    ("policy", lambda: None, [("1", 1, 1, 1), ("8", 8, 1, 1)])]))
                forwards = http["policy"]["forwards"]
                check_counts(http["policy"]["launches"],
                             {k: v * forwards for k, v in expected.items()},
                             f"{name} {policy} /detect")
                leg["http_ms"] = {k: v[0] for k, v in http["latency_ms"].items()}
                leg["detections_8"] = sum(len(d) for d in dets)
                del engine, det
            rec[policy] = leg
            del model, built, inputs
            release_cuda_memory()
    return rec


def phase_precision(log: list, seed: int, device: str = "cuda") -> dict:
    """The "mixed" and "bfloat16" policies on the card (module docstring,
    phase 20): RT-DETRv2-R101's legs (`rtdetr_policy_leg`) beside its
    "float32" stages; the no-fallback gate (the "mixed" backbone stage must
    take less device time than the "float32" one in this run, or a silent
    fp32 upcast would pass unseen); Deformable-DETR and the DETR lineage
    (`policy_family_leg`); and a "mixed" RT-DETR built from a checkpoint
    (written from the seeded "float32" model) equal to the seeded "mixed"
    one bit for bit."""
    import tempfile

    import torch

    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.ops import msda
    from spotter_tpu_torch.tools import profile_forward
    from spotter_tpu_torch.tools.hf_checkpoint import write_checkpoint
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    msda.MSDA_PREP, msda.MSDA_PRECISION = "xla", None  # the knob follows each policy
    rng = np.random.default_rng(seed + 30)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    out = {"phase": "precision", "device": device,
           "card": nvidia_smi("name,power.limit") if device == "cuda" else None, "rtdetr": {}}
    with precision_policy("float32"):
        f32 = build_detector(MODEL_NAME, tiny=False, seed=seed)
        model = f32.module.to(device).eval()
        (x8,) = model_inputs(f32, photos[:8], device)
        with torch.inference_mode():
            _, ref_scores = forward_with_scores(model, x8)
            prof = profile_forward.profile_backend(MODEL_NAME, model, (x8,))
        out["rtdetr"]["float32"] = {"stages_ms_b8": prof["stages_ms"],
                                    "forward_wall_ms_b8": prof["forward_wall_ms_median"],
                                    "busy_share_b8": prof["profiler"]["busy_share"],
                                    "top_kernels_b8": prof["profiler"]["top_kernels"][:12],
                                    "host_ms_b8": prof["profiler"]["host_ms_per_forward"],
                                    "top_host_ops_b8": prof["profiler"]["top_host_ops"][:10]}
        emit({"phase": "precision", "model": MODEL_NAME, "leg": "float32",
              **out["rtdetr"]["float32"]}, log)
        del model, f32
        release_cuda_memory()
    out["families"] = {}
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        for policy, rep_fuse in RTDETR_POLICY_LEGS:
            label = policy if rep_fuse is None else f"{policy}_rep_fuse_{rep_fuse}"
            rec = rtdetr_policy_leg(policy, rep_fuse, seed, photos, x8, ref_scores, flush,
                                    photo_dir, device)
            emit({"phase": "precision", "model": MODEL_NAME, "leg": label, **rec}, log)
            out["rtdetr"][label] = rec
        backbone = {k: v["stages_ms_b8"]["backbone"] for k, v in out["rtdetr"].items()}
        out["backbone_ms_b8"] = backbone
        if not backbone["mixed"] < backbone["float32"]:
            raise AssertionError(f"the mixed backbone stage is not faster than float32's: "
                                 f"{backbone} (a silent fp32 upcast?)")
        for name in (DDETR_NAME, *DETR_LINEAGE):
            rec = policy_family_leg(name, seed, photos, flush, photo_dir, device)
            emit({"phase": "precision", **rec}, log)
            out["families"][name] = rec
    # "mixed" from a checkpoint of the seeded fp32 model
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, MODEL_NAME)
        with precision_policy("float32"):
            write_checkpoint(build_detector(MODEL_NAME, tiny=False, seed=seed).module, "rtdetr",
                             path)
        with precision_policy("mixed"):
            seeded = build_detector(MODEL_NAME, tiny=False, seed=seed).module
            loaded = build_detector(path, tiny=False).module
            want, got = seeded.state_dict(), loaded.state_dict()
            equal = set(want) == set(got) and all(
                got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in want.items())
            out["checkpoint_mixed"] = {
                "bit_equal": equal,
                "bf16_tensors": sum(v.dtype == torch.bfloat16 for v in got.values()),
                "bf16_layers": sum(getattr(m, "dtype", None) == torch.bfloat16
                                   for m in loaded.modules()),
                "tensors": len(got)}
            if not equal:
                raise AssertionError("the mixed RT-DETR loaded from a checkpoint differs from "
                                     "the seeded mixed model")
    summary = {k: v for k, v in out.items() if k not in ("rtdetr", "families")}
    emit(summary, log)
    return out


# --- int8 quantization ----------------------------------------------------------

# the int8 kernels of the served paths (ops/int8.py), in the `kernels` line
INT8_KERNELS = ("amax_s8", "quantize_s8", "quantize_nhwc_s8", "int8_gemm_kmajor", "dequant_s32",
                "conv_s8")
# --int8 level -> the switches of utils/quant.py it turns on
INT8_LEVELS = {"conv": ("INT8",), "dense": ("INT8", "INT8_DENSE"),
               "attn": ("INT8", "INT8_DENSE", "INT8_ATTN")}
# RT-DETRv2-R101's legs: (policy, level); the JAX package's headline
# deployment first (bf16 + int8 convs), then every knob, then fp32 + int8
INT8_LEGS = (("bfloat16", "conv"), ("bfloat16", "attn"), ("float32", "conv"))
# the other families' B = 8 forwards: (name, policy, level)
INT8_FAMILIES = ((YOLOS_NAME, "mixed", "dense"), (DDETR_NAME, "mixed", "attn"),
                 (DETR_NAME, "mixed", "attn"), ("microsoft/conditional-detr-resnet-50", "mixed",
                                               "attn"),
                 ("IDEA-Research/dab-detr-resnet-50", "mixed", "attn"),
                 (OWLV2_NAME, "mixed", "attn"))
INT8_ROUNDS = 1  # timed engine requests and /detect rounds a leg


@contextlib.contextmanager
def int8_knobs(level):
    """The int8 switches of `level` on (None: all off) while the block runs;
    the module attributes utils/quant.py reads at every call."""
    from spotter_tpu_torch.utils import quant

    names = ("INT8", "INT8_DENSE", "INT8_ATTN")
    saved = {name: getattr(quant, name) for name in names}
    for name in names:
        setattr(quant, name, level is not None and name in INT8_LEVELS[level])
    try:
        yield quant
    finally:
        for name, value in saved.items():
            setattr(quant, name, value)


def int8_plan(model, level: str) -> dict:
    """The quantized calls one RT-DETR forward at B >= INT8_MIN_BATCH makes
    under `level`, counted from the module tree (no forward): every ConvNorm
    with INT8_MIN_CH input channels or more outside a fused RepVGG block,
    every fused block, every QuantDense with enough input features, and
    QKᵀ and attn·V of every MultiHeadAttention with a wide enough head."""
    from spotter_tpu_torch.models.layers import ConvNorm, MultiHeadAttention, QuantDense
    from spotter_tpu_torch.models.rtdetr import RepVggBlock, rep_fuse_default
    from spotter_tpu_torch.utils import quant

    on = INT8_LEVELS[level]
    plan = {"conv": 0, "dense": 0, "qk": 0, "av": 0}
    fused = set()
    for module in model.modules():
        if isinstance(module, RepVggBlock) and rep_fuse_default(module.dtype):
            fused.update(id(m) for m in module.modules() if m is not module)
            plan["conv"] += module.conv1.conv.in_channels >= quant.INT8_MIN_CH
    for module in model.modules():
        if isinstance(module, ConvNorm) and id(module) not in fused:
            plan["conv"] += module.conv.in_channels >= quant.INT8_MIN_CH
        elif isinstance(module, QuantDense) and "INT8_DENSE" in on:
            plan["dense"] += module.in_features >= quant.INT8_MIN_CH
        elif isinstance(module, MultiHeadAttention) and "INT8_ATTN" in on:
            wide = module.embed_dim // module.num_heads >= quant.INT8_ATTN_MIN_HD
            plan["qk"] += wide
            plan["av"] += wide
    return plan


def int8_launches(calls: dict, heads=()) -> dict:
    """The int8 kernels' launches for `calls` quantized calls, the weights
    already kept: per convolution an amax, an NHWC quantize pass and one
    `conv_s8`; per other product an amax and a quantize pass per activation
    (two for QKᵀ and attn·V), one GEMM and one dequant; but a heads call
    (`heads`: the (T, hd, dtype) of each, Q and K for QKᵀ, V for attn·V)
    whose (sample, head) group fits one block (`heads_one_launch`) is one
    quantize launch and no amax."""
    from spotter_tpu_torch.ops.int8 import heads_one_launch

    products = calls["dense"] + calls["qk"] + calls["av"]
    activations = products + calls["qk"] + calls["av"]
    one_launch = sum(heads_one_launch(*call) for call in heads)
    return {"amax_s8": calls["conv"] + activations - one_launch, "quantize_s8": activations,
            "quantize_nhwc_s8": calls["conv"], "int8_gemm_kmajor": products,
            "dequant_s32": products, "conv_s8": calls["conv"]}


@contextlib.contextmanager
def heads_calls():
    """The (T, hd, dtype) of each `quantize_heads` call while the block runs
    (utils/quant.py calls it through the ops/int8 module), for
    `int8_launches`."""
    from spotter_tpu_torch.ops import int8

    real, seen = int8.quantize_heads, []

    def record(x, transpose):
        seen.append((x.shape[1], x.shape[3], x.dtype))
        return real(x, transpose)

    int8.quantize_heads = record
    try:
        yield seen
    finally:
        int8.quantize_heads = real


# the int8 wrappers that the models reach (utils/quant.py calls them through
# the ops/int8 module), each with its plain version
PLAIN_INT8 = {name: f"{name}_reference" for name in (
    "amax_samples", "nhwc_codes", "quantize_rows", "quantize_heads", "int8_gemm_kmajor",
    "dequant_rows", "dequant_heads", "dequant_av", "conv_s8")}


def drop_weight_codes(model) -> None:
    for module in model.modules():
        module.__dict__.pop("_quantized", None)


@contextlib.contextmanager
def plain_int8(model):
    """The witness a quantized forward is held against: while the block
    runs, every int8 wrapper of ops/int8.py computes its plain version on
    the same card tensors (no kernel launches), and the model's kept weight
    codes are dropped before and after, so that the block quantizes the
    weights through the plain version too and the kernels' path then makes
    its own again. Only this check routes so; the port has no such switch."""
    from spotter_tpu_torch.ops import int8

    saved = {name: getattr(int8, name) for name in PLAIN_INT8}
    drop_weight_codes(model)
    for name, plain in PLAIN_INT8.items():
        setattr(int8, name, getattr(int8, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(int8, name, fn)
        drop_weight_codes(model)


def witness_record(got: dict, plain: dict, what: str) -> dict:
    """The quantized forward's outputs against its plain witness's: every
    output bit equal (each kernel is exact against its plain version, and
    the rest of the forward is the same code on the same card), else it
    raises. The largest difference of each output is recorded."""
    import torch

    rec = {"bit_equal": all(torch.equal(got[k], plain[k]) for k in plain),
           "max_abs_diff": {k: (got[k].float() - plain[k].float()).abs().max().item()
                            for k in plain}}
    if not rec["bit_equal"] or set(got) != set(plain):
        raise AssertionError(f"{what}: the kernels' forward differs from its plain witness: "
                             f"{rec}")
    return rec


def int8_forward(model, inputs, expected_other: dict, what: str):
    """One forward with the counts set to 0 just before: the int8 kernels
    must launch as the quantized calls say, the other kernels as
    `expected_other`; returns (outputs, calls, launches)."""
    import torch

    from spotter_tpu_torch.utils import quant

    reset_counts()
    quant.reset_calls()
    with heads_calls() as heads:
        out = model(*inputs)
    torch.cuda.synchronize()
    counts, calls = read_counts(), dict(quant.CALLS)
    if len(heads) != 2 * calls["qk"] + calls["av"]:
        raise AssertionError(f"{what}: {len(heads)} heads quantize calls for {calls}")
    check_counts(counts, {**expected_other, **int8_launches(calls, heads)}, what)
    return out, calls, {k: v for k, v in counts.items() if v}


def rtdetr_int8_leg(policy: str, level: str, seed: int, photos, photo_dir: str, flush,
                    device: str) -> dict:
    """RT-DETRv2-R101 at full width under `policy` with `level`'s switches:
    the B = 8 quantized forward bit equal to its plain witness (`plain_int8`)
    and beside the same model's float forward (the encoder scores within the
    "bfloat16" policy's bound; the decoder's matched queries recorded), its
    quantized calls equal to `int8_plan` and the kernels' launches to them;
    B = 1 (below the
    batch floor) bit equal to the float forward with no int8 launch; device
    ms and stages at B = 8, int8 and float; the first leg also serves 8
    photos through the engine and /detect for 8 URLs in the throughput
    bucket (buckets (8,): every forward at B = 8)."""
    import asyncio

    import torch

    from spotter_tpu_torch.engine.engine import InferenceEngine
    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.serving.app import build_detector_app
    from spotter_tpu_torch.tools import profile_forward
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rec = {"policy": policy, "level": level}
    with precision_policy(policy):
        built = build_detector(MODEL_NAME, tiny=False, seed=seed)
        model = built.module.to(device).eval()
        layers = model.config.decoder_layers
        (x8,) = model_inputs(built, photos[:8], device)
        msda_other = {"msda_gather_sum": layers}
        with torch.inference_mode():
            with int8_knobs(None):
                ref8, ref_scores = forward_with_scores(model, x8)
                ref1 = model(x8[:1])
                rec["float_device_ms_b8"] = cuda_time_ms(lambda: model(x8), 5, flush)
                if level == "conv":
                    rec["float_stages_ms_b8"] = profile_forward.profile_backend(
                        MODEL_NAME, model, (x8,))["stages_ms"]
            with int8_knobs(level):
                model(x8)  # the weights' codes, kept from here on
                plan = int8_plan(model, level)
                got8, calls, launches = int8_forward(model, (x8,), msda_other,
                                                     f"RT-DETR {policy} int8 {level} B = 8")
                rec.update({"plan": plan, "calls_per_forward": calls,
                            "launches_per_forward": launches})
                if calls != plan:
                    raise AssertionError(f"RT-DETR {policy} {level}: calls {calls}, plan {plan}")
                with plain_int8(model):
                    plain8 = model(x8)
                rec["plain_witness_b8"] = witness_record(
                    got8, plain8, f"RT-DETR {policy} int8 {level} B = 8")
                del plain8
                _, scores8 = forward_with_scores(model, x8)
                match = matched_record(ref8, got8, 8)
                match["scores_max_abs_err"] = (scores8 - ref_scores).abs().max().item()
                match["scores_abs_max"] = ref_scores.abs().max().item()
                rec["vs_float_b8"] = match
                # the kernels are held above, bit for bit, by the plain witness.
                # Against the float forward, as the precision phase holds a
                # policy against float32 at B = 8: the encoder scores before selection and the
                # sorted top-k scores within the "bfloat16" policy's 25 % of the
                # largest score. The decoder's logits and boxes over the queries
                # both select, and the matched share, are recorded: they measure
                # int8 itself on this random-init model, whose top-k sits on near
                # ties that the 7-bit per-sample grid moves (PERF.md)
                tol = POLICY_TOL["bfloat16"][0] * match["scores_abs_max"]
                if not (match["scores_max_abs_err"] <= tol
                        and match["sorted_topk_max_abs_err"] <= tol):
                    raise AssertionError(f"RT-DETR {policy} int8 {level} vs float at B = 8: "
                                         f"scores outside {tol}: {match}")
                got1, calls1, _ = int8_forward(model, (x8[:1],), msda_other,
                                               f"RT-DETR {policy} int8 {level} B = 1")
                rec["b1_bit_equal"] = all(torch.equal(got1[k], ref1[k]) for k in ref1)
                if not rec["b1_bit_equal"] or any(calls1.values()):
                    raise AssertionError(f"RT-DETR {policy} int8 {level}: B = 1 is not the float "
                                         f"forward ({calls1})")
                rec["device_ms_b8"] = cuda_time_ms(lambda: model(x8), 5, flush)
                prof = profile_forward.profile_backend(MODEL_NAME, model, (x8,))
                rec.update({"stages_ms_b8": prof["stages_ms"],
                            "busy_share_b8": prof["profiler"]["busy_share"],
                            "top_kernels_b8": prof["profiler"]["top_kernels"][:12],
                            "host_ms_b8": prof["profiler"]["host_ms_per_forward"]})
                if not all(torch.isfinite(got8[k]).all() for k in ("logits", "pred_boxes")):
                    raise AssertionError(f"RT-DETR {policy} int8 {level}: non-finite outputs")
                quant_calls_b8 = calls
        del ref8, got8, ref1, got1
        if level == "conv" and policy == "bfloat16":
            with int8_knobs(level):
                engine = InferenceEngine(built, device=device)
                engine.warmup()
                engine.detect(photos[:8])
                reset_counts()
                lat = []
                for _ in range(INT8_ROUNDS):
                    t0 = time.perf_counter()
                    engine.detect(photos[:8])
                    lat.append((time.perf_counter() - t0) * 1e3)
                counts = read_counts()
                per = int8_launches(quant_calls_b8)
                check_counts(counts, {k: v * INT8_ROUNDS for k, v in {**msda_other, **per}.items()},
                             f"RT-DETR {policy} int8 engine")
                rec["engine_batch8_p50_ms"] = statistics.median(lat)
                rec["engine_launches"] = {k: counts[k] for k in INT8_KERNELS}
                del engine, model, built
                release_cuda_memory()
                det = build_detector_app(MODEL_NAME, device=device, seed=seed, warmup=True,
                                         batch_buckets=(8,), max_delay_ms=20.0)
                http = asyncio.run(drive_http(det, photo_dir, [
                    ("int8", lambda: None, [("8", 8, INT8_ROUNDS, 1)])]))
                forwards = http["int8"]["forwards"]
                check_counts(http["int8"]["launches"],
                             {k: v * forwards for k, v in {**msda_other, **per}.items()},
                             f"RT-DETR {policy} int8 /detect")
                rec["http"] = {"latency_ms": latency_summary(http["latency_ms"]),
                               "forwards": forwards,
                               "launches": {k: http["int8"]["launches"][k] for k in INT8_KERNELS}}
                del det
    release_cuda_memory()
    return rec


def yolos_expected(model) -> dict:
    """YOLOS's kernels a forward under a bf16 body: the attention kernel once
    a layer where the sequence reaches the cutover (yolos-base's 4301)."""
    from spotter_tpu_torch.models.layers import FLASH_ATTN_MIN_SEQ

    cfg = model.config
    gh, gw = cfg.grid_hw
    if gh * gw + cfg.num_detection_tokens + 1 < FLASH_ATTN_MIN_SEQ:
        return {}
    return {"flash_attn_bf16": cfg.num_hidden_layers}


def int8_family_forward(name: str, policy: str, level: str, seed: int, photos, flush,
                        device: str) -> dict:
    """Another family at full width, B = 8, under `policy` with `level`'s
    switches: finite outputs bit equal to the plain witness's
    (`plain_int8`), the int8 kernels' launches equal to the quantized
    calls, the float forward beside it (YOLOS: within the "bfloat16"
    policy's bounds), device ms of both."""
    import torch

    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.tools.timing import cuda_time_ms

    rec = {"model": name, "policy": policy, "level": level}
    with precision_policy(policy):
        built = build_detector(name, tiny=False, seed=seed)
        model = built.module.to(device).eval()
        inputs = model_inputs(built, photos[:8], device)
        other = (ddetr_expected(model, "xla", 1) if name == DDETR_NAME else
                 owl_expected(model, 1, "flash_attn_bf16") if name == OWLV2_NAME else
                 yolos_expected(model) if name == YOLOS_NAME else {})
        with torch.inference_mode():
            with int8_knobs(None):
                ref = {k: v.float() for k, v in model(*inputs).items()}
                rec["float_device_ms_b8"] = cuda_time_ms(lambda: model(*inputs), 5, flush)
            with int8_knobs(level):
                model(*inputs)
                got, calls, launches = int8_forward(model, inputs, other,
                                                    f"{name} {policy} int8 {level} B = 8")
                with plain_int8(model):
                    plain = model(*inputs)
                rec["plain_witness_b8"] = witness_record(
                    got, plain, f"{name} {policy} int8 {level} B = 8")
                del plain
                rec.update({"calls_per_forward": calls, "launches_per_forward": launches,
                            "device_ms_b8": cuda_time_ms(lambda: model(*inputs), 5, flush)})
        if not sum(calls.values()):
            raise AssertionError(f"{name} {policy} int8 {level}: nothing quantized")
        if not all(torch.isfinite(v.float()).all() for v in got.values()):
            raise AssertionError(f"{name} {policy} int8 {level}: non-finite outputs")
        rec["logits_max_abs_err"] = (got["logits"].float() - ref["logits"]).abs().max().item()
        rec["logits_abs_max"] = ref["logits"].abs().max().item()
        rec["boxes_max_abs_err"] = (got["pred_boxes"].float()
                                    - ref["pred_boxes"]).abs().max().item()
        if name == YOLOS_NAME:
            check_policy_record(rec, *POLICY_TOL["bfloat16"], f"{name} int8 vs float at B = 8")
        del model, built, inputs, got, ref
    release_cuda_memory()
    return rec


def phase_int8(log: list, seed: int, device: str = "cuda") -> dict:
    """int8 quantization on the card (module docstring, phase 21): the conv
    probe at its seven shapes, the dense and attention shapes
    (tools/bench_int8_conv.py, every kernel exact against its plain version;
    int8_gemm's SASS with IGMMA and no IMMA); RT-DETRv2-R101's legs
    (`rtdetr_int8_leg`); the other families' B = 8 forwards. Returns the
    kernel cases and the launches of the served path."""
    import torch

    from spotter_tpu_torch.tools import bench_int8, bench_int8_conv
    from spotter_tpu_torch.utils.precision import use_exact_float32

    use_exact_float32()
    out = {"phase": "int8", "device": device,
           "card": nvidia_smi("name,power.limit") if device == "cuda" else None}
    tool_out = REPO / "build" / "probes" / "bench_int8_conv.json"
    reset_counts()
    rc = bench_int8_conv.main(["--seed", str(seed), "--out", str(tool_out)])
    counts = read_counts()
    record = json.loads(tool_out.read_text())
    wrong = [c for c in record["cases"] if not c["exact"]]
    if rc != 0 or wrong:
        raise AssertionError(f"bench_int8_conv: exit {rc}, not exact: {wrong}")
    check_counts(counts, record["calls"], "the bench_int8_conv tool")
    sass = {"int8_gemm": bench_int8.sass_evidence(torch.device(device)),
            "conv_s8": bench_int8.sass_evidence(torch.device(device), "conv_s8")}
    if device == "cuda" and any(v["verdict"] != bench_int8.SASS_WGMMA_VERDICT
                                for v in sass.values()):
        raise AssertionError(f"the int8 kernels' SASS: {sass}")
    out["tool"] = {"cases": record["cases"], "calls": record["calls"], "sass": sass}
    for case in record["cases"]:
        emit({"phase": "int8", "tool": "bench_int8_conv", **case}, log)
    # which path of the amax and quantize passes served each case
    emit({"phase": "int8", "tool": "bench_int8_conv", "paths": [
        {"part": c["part"], "case": c.get("shape") or c.get("x"), "dtype": c.get("dtype"),
         "channels_last": c.get("channels_last", False), **c.get("paths", {})}
        for c in record["cases"]]}, log)
    rng = np.random.default_rng(seed + 40)
    photos = [synthetic_photo(rng, h, w) for h, w in PHOTO_SIZES]
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    out["rtdetr"] = {}
    with tempfile.TemporaryDirectory() as photo_dir:
        write_photos(photo_dir, rng)
        for policy, level in INT8_LEGS:
            rec = rtdetr_int8_leg(policy, level, seed, photos, photo_dir, flush, device)
            emit({"phase": "int8", "model": MODEL_NAME, **rec}, log)
            out["rtdetr"][f"{policy}_{level}"] = rec
    out["families"] = {}
    with token_cache(seed, names=(OWLV2_NAME,)):
        for name, policy, level in INT8_FAMILIES:
            rec = int8_family_forward(name, policy, level, seed, photos, flush, device)
            emit({"phase": "int8", **rec}, log)
            out["families"][name] = rec
    conv = next(c for c in record["cases"] if c.get("shape") == bench_int8_conv.MAIN_SHAPE)
    main_label = f"{bench_int8_conv.MAIN_SHAPE}_{conv['dtype']}"
    dense = next(c for c in record["cases"] if c["part"] == "dense")
    # launches: the convolution's kernels on the /detect path of the headline
    # deployment (bfloat16 + INT8), the GEMM and the dequant, which only the
    # other products reach, a forward of the all-knobs leg
    served = out["rtdetr"]["bfloat16_conv"]["http"]["launches"]
    all_knobs = out["rtdetr"]["bfloat16_attn"]["launches_per_forward"]
    ms = "_ms" if device == "cuda" else "_cpu_ms"  # the tool's keys (tools/timing.py ms_key)
    # each row names the function it timed (`case`): a kernel's row keeps its
    # name when the pass the served path takes changes (the quantize row
    # times the rows entry, the NHWC pass its own kernel's row)
    attn = next(c for c in record["cases"] if c["part"] == "attention")
    out["kernel_cases"] = [
        {"phase": "int8", "kernel": name, "main": True, "launches": launches,
         "case": label, "max_abs_err": 0.0, "kernel_ms": case[key + ms],
         "plain_ms": case.get(f"plain_{key}{ms}"), "library_ms": library,
         "bound_ms": case["bounds"][key]["bound_ms"],
         "bound_by": case["bounds"][key]["bound_by"]}
        for name, key, label, case, library, launches in (
            ("amax_s8", "amax_s8", f"samples_{main_label}", conv,
             conv.get("library_vector_norm" + ms), served["amax_s8"]),
            ("quantize_nhwc_s8", "quantize_nhwc_s8", f"nhwc_{main_label}", conv, None,
             served["quantize_nhwc_s8"]),
            ("quantize_s8", "quantize_s8_rows", "rows_yolos_fc1", dense, None,
             all_knobs.get("quantize_s8", 0)),
            ("int8_gemm_kmajor", "int8_gemm_kmajor", "kmajor_yolos_fc1", dense,
             dense.get("library_int_mm" + ms), all_knobs.get("int8_gemm_kmajor", 0)),
            ("dequant_s32", "dequant_s32_rows", "rows_yolos_fc1", dense, None,
             all_knobs.get("dequant_s32", 0)),
            ("conv_s8", "conv_s8", f"implicit_gemm_{main_label}", conv, None, served["conv_s8"]))]
    # conv_s8's yardsticks, beside its row: no one PyTorch call computes an
    # int8 convolution, so cuDNN's bf16 convolution of the same operands and
    # the two paths' times stand next to it
    out["kernel_cases"][-1].update({
        "cudnn_bf16_ms": conv.get("library_cudnn_bf16" + ms), "path_ms": conv.get("path" + ms),
        "tile_n": conv["conv_s8_tile_n"]})
    # the quantize row's heads entries, each wrapper call whole, beside it
    quantize_row = next(c for c in out["kernel_cases"] if c["kernel"] == "quantize_s8")
    for key in ("heads", "heads_t"):
        quantize_row[f"{key}_ms"] = attn.get(f"quantize_s8_{key}{ms}")
        quantize_row[f"{key}_bound_ms"] = attn.get("bounds", {}).get(
            f"quantize_s8_{key}", {}).get("bound_ms")
    emit({k: v for k, v in out.items() if k not in ("tool", "rtdetr", "families")}, log)
    return out


def percentile(values, p: float) -> float:
    vals = sorted(values)
    return vals[min(int(p * len(vals)), len(vals) - 1)]


def check_http_response(body: dict, urls: list, first_hw: tuple[int, int],
                        queries=None) -> None:
    """The reference wire schema, one success per URL with finite boxes, the
    first image's labeled JPEG at its source size, and, for a request with
    `queries`, no label but those queries (a padded query slot never wins)."""
    import base64
    import io
    import math

    from PIL import Image

    from spotter_tpu_torch.schemas import DetectionResponse, DetectionSuccessResult

    resp = DetectionResponse.model_validate(body)
    if [r.url for r in resp.images] != urls:
        raise AssertionError("response images do not follow the request's URLs")
    for r in resp.images:
        if not isinstance(r, DetectionSuccessResult):
            raise AssertionError(f"image failed: {r}")
        if not all(math.isfinite(v) for d in r.detections for v in d.box):
            raise AssertionError(f"non-finite box in {r.url}")
        if queries is not None and not {d.label for d in r.detections} <= set(queries):
            raise AssertionError(f"labels outside the request's queries in {r.url}: "
                                 f"{sorted({d.label for d in r.detections} - set(queries))}")
    first = Image.open(io.BytesIO(base64.b64decode(resp.images[0].labeled_image_base64)))
    if first.format != "JPEG" or first.size != (first_hw[1], first_hw[0]):
        raise AssertionError(f"labeled image is {first.format} {first.size}, not the source's")


# the measurement tools, in order, each at its defaults (n = 4096, 8192 and
# 4000; bh = 16; B = 8): (kernel, tool module, the case the `kernels` line
# reports)
PROBE_TOOLS = (
    ("int8_gemm", "bench_int8", lambda c: c["n"] == 4096),
    ("pack_tile", "bench_pack_probe", lambda c: c["main"]),
    ("launch_probe", "profile_r101", lambda c: c["main"]),
)


def check_int8_design(record: dict) -> None:
    """int8_gemm is the wgmma design: its SASS shows IGMMA and no IMMA (a
    record from the card; the CPU has no SASS), and its transpose pass
    equals b.t().contiguous() at every size."""
    from spotter_tpu_torch.tools.bench_int8 import SASS_WGMMA_VERDICT

    sass = next(c for c in record["cases"] if c["part"] == "sass")
    if record["device"] == "cuda" and sass["verdict"] != SASS_WGMMA_VERDICT:
        raise AssertionError(f"int8_gemm's SASS: {sass}")
    wrong = [c["n"] for c in record["cases"] if c["part"] == "gemm" and not c["transpose_exact"]]
    if wrong:
        raise AssertionError(f"int8_gemm's transpose pass differs from b.t() at n = {wrong}")


def check_pack_tile_design(record: dict) -> None:
    """pack_tile's fp32 base and hoist compare into a predicate and add under
    it: their SASS shows no select (FSEL) in a chain past its first element,
    so at most one a chain (where ptxas folds the add onto the +0 that `oh`
    starts from into a select of w or 0). The base variants read idx and w
    from shared memory at every chain element: an LDS for each k and j. A
    record from the card; the CPU has no SASS."""
    from spotter_tpu_torch.tools.bench_pack_probe import (
        CHAIN_READ_VARIANTS,
        JC,
        NO_SELECT_VARIANTS,
        REPS,
    )

    if record["device"] != "cuda":
        return
    sass = {c["variant"]: c["sass"] for c in record["cases"] if c.get("kernel") == "pack_tile"}
    selects = {v: sass[v] for v in NO_SELECT_VARIANTS if sass[v]["fsel"] > sass[v]["chains"]}
    if selects:
        raise AssertionError(f"pack_tile's chains still select (FSEL): {selects}")
    hoisted = {v: sass[v] for v in CHAIN_READ_VARIANTS if sass[v]["lds"] < REPS * JC}
    if hoisted:
        raise AssertionError(f"pack_tile's base variants do not read in every chain: {hoisted}")


def phase_probes(log: list, seed: int) -> list:
    """Each measurement tool through its `main`, as a user runs it on the
    card, with every count set to 0 just before: its kernel must equal its
    plain version exactly in every case, and launch exactly as often as the
    tool called it (profile_r101 also runs MSDA ops, each one gather-sum
    launch); no other kernel may launch. Returns one case per kernel for
    the `kernels` line."""
    cases = []
    for kernel, tool_name, is_main in PROBE_TOOLS:
        tool = importlib.import_module(f"spotter_tpu_torch.tools.{tool_name}")
        out = REPO / "build" / "probes" / f"{tool_name}.json"
        t0 = time.perf_counter()
        reset_counts()
        rc = tool.main(["--seed", str(seed), "--out", str(out)])
        counts = read_counts()
        record = json.loads(out.read_text())
        mine = [c for c in record["cases"] if c.get("kernel") == kernel]
        wrong = [c for c in mine if not c["exact"]]
        if rc != 0 or not mine or wrong:
            raise AssertionError(f"{tool_name}: exit {rc}, {len(mine)} {kernel} cases, "
                                 f"not exact: {wrong}")
        check_counts(counts, record["calls"], f"the {tool_name} tool")
        if kernel == "int8_gemm":
            check_int8_design(record)
        if kernel == "pack_tile":
            check_pack_tile_design(record)
        main_case = next(c for c in mine if is_main(c))
        case = {
            "phase": "probes", "kernel": kernel, "tool": tool_name, "main": True,
            "launches": counts[kernel], "tool_calls": record["calls"][kernel],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "kernel_ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "library_ms": main_case["library_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "seconds": time.perf_counter() - t0,
        }
        if f"{kernel}_graph" in record["calls"]:  # launches that CUDA graph replays made
            case["graph_launches"] = record["calls"][f"{kernel}_graph"]
        if kernel == "int8_gemm":  # the transpose pass alone, inside kernel_ms
            case["transpose_ms"] = main_case["transpose_ms"]
        emit(case, log)
        cases.append(case)
    return cases


# the TPU kernel each port replaces, and the source it is built from
REPLACES = {
    "msda_gather_sum": "spotter_tpu/ops/msda.py:906",
    "msda_loc_sum": "spotter_tpu/ops/msda.py:1162",
    "msda_fused_sum": "spotter_tpu/ops/msda.py:1368",
    "msda_sep_sum": "spotter_tpu/ops/msda.py:585",
    "msda_hd_gather_sum": "spotter_tpu/ops/msda.py:295",
    "flash_attn_fp32": "spotter_tpu/models/layers.py:126",
    "flash_attn_bf16": "spotter_tpu/models/layers.py:185",
    "owl_class_logits": "spotter_tpu/ops/openvocab.py:87",
    "int8_gemm": "tools/bench_int8.py:142",
    "pack_tile": "tools/bench_pack_probe.py:78",
    "launch_probe": "tools/profile_r101.py:320",
    # no Pallas counterpart: the passes and the GEMM entry of the int8 path,
    # which XLA's s8 convolution and dot_general compute on the TPU
    "amax_s8": "spotter_tpu/utils/quant.py:136",
    "quantize_s8": "spotter_tpu/utils/quant.py:124",
    "quantize_nhwc_s8": "spotter_tpu/utils/quant.py:124",
    "int8_gemm_kmajor": "spotter_tpu/utils/quant.py:146",
    "dequant_s32": "spotter_tpu/utils/quant.py:154",
    "conv_s8": "spotter_tpu/utils/quant.py:146-154",
}
SOURCES = {name: "spotter_tpu_torch/csrc/msda.cu" for name in REPLACES if name.startswith("msda")}
SOURCES.update({name: "spotter_tpu_torch/csrc/attention.cu"
                for name in REPLACES if name.startswith("flash")})
SOURCES["owl_class_logits"] = "spotter_tpu_torch/csrc/class_logits.cu"
SOURCES.update({name: "spotter_tpu_torch/csrc/msda_backends.cu" for name in BACKEND_KERNEL.values()})
SOURCES.update({name: f"spotter_tpu_torch/csrc/{name}.cu"
                for name in ("int8_gemm", "pack_tile", "launch_probe")})
SOURCES.update({"amax_s8": "spotter_tpu_torch/csrc/quant.cu",
                "quantize_s8": "spotter_tpu_torch/csrc/quant.cu",
                "quantize_nhwc_s8": "spotter_tpu_torch/csrc/quant.cu",
                "int8_gemm_kmajor": "spotter_tpu_torch/csrc/int8_gemm.cu",
                "dequant_s32": "spotter_tpu_torch/csrc/quant.cu",
                "conv_s8": "spotter_tpu_torch/csrc/int8_conv.cu"})


def is_main_case(c: dict, precision: str = "highest") -> bool:
    """The case each kernel reports in the summary: B = 8 at its main path's
    shapes (fp32 rows and bilinear prep for MSDA, in `precision`; yolos-base
    for attention; OWLv2's patches, fp32 features and the default vocabulary
    for the class logits; the probes phase marks its own)."""
    if c.get("precision", "highest") != precision:
        return False
    if "main" in c:
        return c["main"]
    if c["kernel"] == "owl_class_logits":
        shape = c["shape"]
        return (shape["b"], shape["p"], shape["q"], shape["masked"],
                c["img_dtype"]) == CLASS_LOGITS_MAIN
    if c["kernel"].startswith("flash"):
        shape = c["shape"]
        return (shape["b"], shape["s"], shape["h"], shape["hd"]) == ATTN_MAIN_SHAPE
    if c["kernel"] in BACKEND_KERNEL.values():  # the Deformable-DETR encoder's op
        return (c["case"] == "ddetr_encoder" and c["rows_dtype"] == "float32"
                and c["method"] == "default" and not c.get("cleared_mask_bits"))
    # rows 1-3: RT-DETR's decoder op (their Deformable-DETR cases carry a "case")
    return (c["batch"] == 8 and c["rows_dtype"] == "float32" and c["method"] == "default"
            and "case" not in c)


# the kernels with a one-pass mode: the summary lists it as a kernel of its
# own, `<name>_onepass`
ONE_PASS_KERNELS = ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum", "msda_sep_sum")


def kernel_summary(cases: list, launches: dict) -> dict:
    """The `kernels` line: per kernel that a phase of this run held against
    its plain version, its launches on the path that runs it and its main
    case's numbers (from the kernel phase, or the probes phase); rows 1-4's
    one-pass mode as `<name>_onepass`, with its launches on the precision
    phase's paths."""
    rows = []
    entries = [(name, name, "highest") for name in REPLACES]
    entries += [(f"{name}_onepass", name, "default") for name in ONE_PASS_KERNELS]
    for row_name, name, precision in entries:
        replaces = REPLACES[name]
        mine = [c for c in cases if c["kernel"] == name
                and c.get("precision", "highest") == precision]
        if not mine:
            continue
        main_case = next(c for c in mine if is_main_case(c, precision))
        rows.append({
            "name": row_name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "launches": launches.get(row_name),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
        if "graph_launches" in main_case:  # beside the eager launches the wrapper counts
            rows[-1]["graph_launches"] = main_case["graph_launches"]
        if name in COMPANIONS:  # its pass's launches on the same path, and its time alone
            rows[-1][f"{COMPANIONS[name]}_launches"] = launches.get(COMPANIONS[name])
            rows[-1][f"{COMPANIONS[name]}_ms"] = main_case["split_pass"]["ms"]
        if name == "owl_class_logits":  # the bf16 head's main case beside the fp32 one
            bf16 = [c for c in mine if (c["shape"]["b"], c["shape"]["p"], c["shape"]["q"],
                                        c["shape"]["masked"], c["img_dtype"])
                    == CLASS_LOGITS_MAIN_BF16]
            if bf16:
                rows[-1].update({"bf16_ms": bf16[0]["kernel_ms"],
                                 "bf16_plain_ms": bf16[0]["plain_ms"],
                                 "bf16_bound_ms": bf16[0]["bound_ms"]})
        if "bound_cuda_cores_ms" in main_case:
            rows[-1]["bound_name"] = main_case["bound_name"]
            rows[-1]["bound_cuda_cores_ms"] = main_case["bound_cuda_cores_ms"]
        # the int8 rows' measured function; conv_s8's yardsticks
        for key in ("case", "cudnn_bf16_ms", "path_ms", "tile_n", "heads_ms", "heads_t_ms",
                    "heads_bound_ms", "heads_t_bound_ms"):
            if key in main_case and (key != "case" or main_case.get("phase") == "int8"):
                rows[-1][key] = main_case[key]
    return {"kernels": rows}


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
    if not all((REPO / "spotter_tpu_torch" / "csrc" / src).exists()
               for src in ("msda.cu", "msda_backends.cu", "attention.cu", "class_logits.cu",
                           "int8_gemm.cu", "int8_conv.cu", "quant.cu", "pack_tile.cu",
                           "launch_probe.cu")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from spotter_tpu_torch.models.registry import build_detector

    log: list = []
    t_start = time.perf_counter()
    seconds: dict = {}  # each phase's wall seconds, for the run's time budget

    def run(name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    def wanted(name: str, fn, *args):
        return run(name, fn, *args) if name in phases else None

    device = run("device", phase_device, log)
    wanted("build", phase_build, log)
    cases = wanted("kernel", phase_kernel, log, args.seed) or []
    built = None
    if "parity" in phases or "serve" in phases or "engine" in phases:
        built = run("parity", lambda: build_detector(MODEL_NAME, tiny=False, seed=args.seed))
    wanted("parity", phase_parity, log, args.seed, built)
    serve = wanted("serve", phase_serve, log, args.seed, built)
    engine = wanted("engine", phase_engine, log, args.seed, built)
    http = wanted("http", phase_http, log, args.seed)
    wanted("integrity", phase_integrity, log, args.seed)
    wanted("planes", phase_planes, log, args.seed)
    del built
    wanted("yolos_parity", phase_yolos_parity, log, args.seed)
    wanted("yolos_serve", phase_yolos_serve, log, args.seed)
    yolos_http = wanted("yolos_http", phase_yolos_http, log, args.seed)
    wanted("ddetr_parity", phase_ddetr_parity, log, args.seed)
    wanted("ddetr_serve", phase_ddetr_serve, log, args.seed)
    ddetr_http = wanted("ddetr_http", phase_ddetr_http, log, args.seed)
    wanted("detr_parity", phase_detr_parity, log, args.seed)
    wanted("detr_serve", phase_detr_serve, log, args.seed)
    wanted("detr_http", phase_detr_http, log, args.seed)
    ragged = wanted("ragged", phase_ragged, log, args.seed)
    owl_http = None
    if set(OWL_PHASES) & set(phases):
        # the OWL prompts' token ids, in a cache of this run's own
        with token_cache(args.seed) as files:
            emit({"phase": "owl_tokens", "files": files, "prompts": len(owl_prompts())}, log)
            wanted("owl_parity", phase_owl_parity, log, args.seed)
            wanted("owl_serve", phase_owl_serve, log, args.seed)
            owl_http = wanted("owl_http", phase_owl_http, log, args.seed)
    load = wanted("load", phase_load, log, args.seed)
    precision = wanted("precision", phase_precision, log, args.seed)
    int8 = wanted("int8", phase_int8, log, args.seed)
    if int8:
        cases += int8["kernel_cases"]
    if "probes" in phases:
        cases += run("probes", phase_probes, log, args.seed)
    emit({"phase_seconds": {k: round(v, 1) for k, v in seconds.items()}}, log)
    # each kernel's launches on the path that runs it: slice 1's engine path
    # under xla, the HTTP /detect path under fused and under kernel, YOLOS's
    # /detect path under float32 (fp32) and mixed (bf16), and OWLv2's /detect
    # path against its default vocabulary; each probe's on its tool's path
    launches = {c["kernel"]: c["launches"] for c in cases if c.get("phase") in ("probes", "int8")}
    if serve:
        launches["msda_gather_sum"] = serve["msda_launches"]
    if http:
        launches["msda_fused_sum"] = http["fused"]["launches"]["msda_fused_sum"]
        launches["msda_loc_sum"] = http["kernel"]["launches"]["msda_loc_sum"]
    if yolos_http:
        for policy, name in POLICY_KERNEL.items():
            launches[name] = yolos_http[policy]["launches"][name]
            if name in COMPANIONS:
                launches[COMPANIONS[name]] = yolos_http[policy]["launches"][COMPANIONS[name]]
    if owl_http:
        launches["owl_class_logits"] = owl_http["default"]["launches"]["owl_class_logits"]
    if ddetr_http:
        for backend, name in BACKEND_KERNEL.items():
            launches[name] = ddetr_http[backend]["launches"][name]
    if precision:  # rows 1-4's one-pass mode on the "mixed" paths
        mixed = precision["rtdetr"]["mixed"]
        launches["msda_gather_sum_onepass"] = mixed["engine_launches"]
        launches["msda_loc_sum_onepass"] = mixed["launches_per_forward_by_prep"]["kernel"]
        launches["msda_fused_sum_onepass"] = mixed["http_fused"]["launches"]
        launches["msda_sep_sum_onepass"] = (
            precision["families"][DDETR_NAME]["mixed"]["pallas_sep_launches"])

    if cases:
        summary = kernel_summary(cases, launches)
        if int8:  # row 9's kernel on the int8 /detect path, through its K-major entry
            for row in summary["kernels"]:
                if row["name"] == "int8_gemm":
                    row["served_launches"] = launches["int8_gemm_kmajor"]
        if engine:  # row 1 on the engine phase's pipelined detect (graph replays)
            for row in summary["kernels"]:
                if row["name"] == "msda_gather_sum":
                    row["engine_launches"] = engine["policies"]["float32"]["launches"][
                        "msda_gather_sum"]
        if ragged:  # row 1 on Deformable-DETR's ragged /detect path
            for row in summary["kernels"]:
                if row["name"] == "msda_gather_sum":
                    row["ragged_launches"] = ragged["models"][DDETR_NAME]["launches"][
                        "msda_gather_sum"]
        if load:  # rows 1-3's launches on the loaded checkpoint's engine and /detect paths
            for row in summary["kernels"]:
                if row["name"] in load["launches"]:
                    row["load_launches"] = load["launches"][row["name"]]
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
