"""Where RT-DETRv2-R101's batch-8 milliseconds go on the card, by part
(counterpart of tools/profile_r101.py, its default parts).

  layers    the full forward at decoder_layers 1, 3 and 6 (the slope is the
            cost of one decoder layer, the intercept backbone, encoder and
            query selection);
  backbone  ResNet-101-vd alone;
  topk      the 8400 -> 300 query selection (class max, then the stable
            top-k the model runs);
  msda      one decoder MSDA op at value (B, 8400, 8, 32) under
            SPOTTER_TPU_MSDA=xla (corner prep, then the gather-sum kernel),
            once and twice;
  launch    the launch probe: `launch_probe` (`csrc/launch_probe.cu`, the
            port of the trivial Pallas kernel at tools/profile_r101.py:320)
            doubles one (8, 128) fp32 tile. One call against four chained
            calls, launched eagerly and replayed from a CUDA graph, gives the
            fixed cost of a launch each way: what per-bucket CUDA graphs
            would save (ROADMAP Queue 1 item 5).

Every part runs the default MSDA path (SPOTTER_TPU_MSDA and _PREP "xla",
whatever the process's knobs), so each sampling op launches one
gather-sum, and the record's `calls` counts them beside the probe's.
Weights are drawn from --seed at the preset's full width (as the serving
zoo draws them), pixels from a normal distribution, under the "float32"
policy with TF32 off: the only policy the port serves RT-DETR under, so
--dtype takes nothing else. The JAX tool's TPU ablations (`dec_ablate`,
`kernel_ablate`, `sel_ablate`, `stem2`) are not ported.

    python -m spotter_tpu_torch.tools.profile_r101 [--batch 8]
        [--parts layers,backbone,topk,msda,launch] [--layers-set 1,3,6]
        [--seed 0] [--device cpu] [--tiny] [--out build/profile_r101.json]

Runs on cuda unless --device cpu is given; --tiny takes the zoo's tiny
RT-DETR at 64x64 (for CPU runs). Times are device times by CUDA events on
the card, host-clock CPU times otherwise.
"""

import argparse
import ctypes
import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np
import torch

from spotter_tpu_torch.models.rtdetr import RTDetrDetector
from spotter_tpu_torch.models.zoo import init_rtdetr, rtdetr_preset, tiny_rtdetr_config
from spotter_tpu_torch.ops import msda
from spotter_tpu_torch.ops.postprocess import stable_top_k
from spotter_tpu_torch.tools.timing import (
    PEAK_BYTES_PER_S,
    device_record,
    ms_key,
    resolve_device,
    time_ms,
)
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library
from spotter_tpu_torch.utils.precision import use_exact_float32

REPO = Path(__file__).resolve().parents[2]
MODEL_NAME = "PekingU/rtdetr_v2_r101vd"
DEFAULT_PARTS = ("layers", "backbone", "topk", "msda", "launch")
PROBE_SHAPE = (8, 128)
EAGER_RUNS = 2000  # back-to-back calls per host-clock launch measurement


@functools.cache
def build_launch_probe_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library."""
    loaded = load_kernel_library("launch_probe", ("launch_probe.cu",))
    lib = loaded.lib
    lib.launch_probe_double.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_void_p]
    lib.launch_probe_double.restype = ctypes.c_int
    lib.launch_probe_error_string.argtypes = [ctypes.c_int]
    lib.launch_probe_error_string.restype = ctypes.c_char_p
    return loaded


def launch_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: 2 * x."""
    return x * 2.0


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """2 * x for a contiguous fp32 tensor. Replaces the Pallas kernel of
    `tools/profile_r101.py:320`. On a CUDA tensor the kernel (also inside a
    CUDA graph capture, which records the launch without running it, so it
    is not counted: its replays are the caller's to count); on a CPU tensor
    the plain version; any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"launch_probe runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"launch_probe: x must be float32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"launch_probe: empty input {tuple(x.shape)}")
    if x.device.type == "cpu":
        return launch_probe_reference(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("launch_probe: x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    lib = build_launch_probe_kernel().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.launch_probe_double(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if code != 0:
        raise RuntimeError(f"launch_probe launch failed: "
                           f"{lib.launch_probe_error_string(code).decode()} ({code})")
    if not torch.cuda.is_current_stream_capturing():
        launch_probe.launches += 1
    return out


launch_probe.launches = 0  # kernel launches since the count was last reset


def rtdetr_config(tiny: bool, decoder_layers: int):
    cfg = tiny_rtdetr_config() if tiny else rtdetr_preset(MODEL_NAME)
    return dataclasses.replace(cfg, decoder_layers=decoder_layers)


def build_model(tiny: bool, decoder_layers: int, seed: int, device: torch.device):
    model = RTDetrDetector(rtdetr_config(tiny, decoder_layers)).eval()
    init_rtdetr(model, seed)
    return model.to(device)


def pixels(batch: int, size: int, seed: int, device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) standard-normal pixels, as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32)).to(device)


def part_layers(args, device, px, calls: dict) -> list:
    recs = []
    for layers in args.layers_set:
        model = build_model(args.tiny, layers, args.seed, device)

        def forward(model=model, layers=layers):
            calls["msda_gather_sum"] += layers  # one per decoder layer under xla
            return model(px)["pred_boxes"]

        ms = time_ms(forward, args.iters, device)
        recs.append({"part": "layers", "decoder_layers": layers, ms_key("forward", device): ms})
        del model
    if len(recs) > 1:
        key = ms_key("forward", device)
        first, last = recs[0], recs[-1]
        slope = (last[key] - first[key]) / (last["decoder_layers"] - first["decoder_layers"])
        recs.append({"part": "layers_fit", ms_key("per_decoder_layer", device): slope,
                     ms_key("intercept", device): first[key] - slope * first["decoder_layers"]})
    return recs


def part_backbone(args, device, px) -> list:
    model = build_model(args.tiny, 1, args.seed, device)
    x = px.permute(0, 3, 1, 2).contiguous()
    ms = time_ms(lambda: model.backbone(x), args.iters, device)
    return [{"part": "backbone", ms_key("backbone", device): ms}]


def level_shapes(cfg, size: int) -> tuple:
    return tuple((size // s, size // s) for s in cfg.feat_strides)


def part_topk(args, device, size) -> list:
    cfg = rtdetr_config(args.tiny, 1)
    s = sum(h * w for h, w in level_shapes(cfg, size))
    rng = np.random.default_rng(args.seed + 1)
    scores = torch.from_numpy(
        rng.standard_normal((args.batch, s, cfg.num_labels)).astype(np.float32)).to(device)
    ms = time_ms(lambda: stable_top_k(scores.max(-1).values, cfg.num_queries)[1], args.iters,
                 device)
    return [{"part": "topk", "tokens": s, "k": cfg.num_queries, ms_key("topk", device): ms}]


def part_msda(args, device, size, calls: dict) -> list:
    cfg = rtdetr_config(args.tiny, 1)
    heads = cfg.decoder_attention_heads
    hd = cfg.d_model // heads
    pts = cfg.decoder_n_points
    shapes = level_shapes(cfg, size)
    s = sum(h * w for h, w in shapes)
    lp = len(shapes) * pts
    rng = np.random.default_rng(args.seed)
    b, q = args.batch, cfg.num_queries

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    value = dev(rng.standard_normal((b, s, heads, hd)))
    loc = dev(rng.random((b, q, heads, lp, 2)))
    attn = torch.softmax(dev(rng.standard_normal((b, q, heads, lp))), dim=-1)
    value2 = value * 1.0001

    def op(v):
        calls["msda_gather_sum"] += 1  # the kernel each op launches under xla
        return msda.deformable_sampling(v, loc, attn, shapes, pts)

    one = time_ms(lambda: op(value), args.iters, device)
    two = time_ms(lambda: (op(value), op(value2)), args.iters, device)
    return [{"part": "msda", "value_shape": [b, s, heads, hd], "queries": q, "backend": "xla",
             ms_key("msda_x1", device): one, ms_key("msda_x2", device): two}]


def _host_us_per_call(fn, runs: int, device) -> float:
    """Host-clock microseconds per call over `runs` back-to-back calls,
    synchronised once at the end: the launch rate when the device work is
    shorter than the launch."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e6


def part_launch(args, device, calls: dict) -> list:
    """The launch probe's part. `calls["launch_probe"]` counts the kernel's
    eager launches (what the wrapper counts); `calls["launch_probe_graph"]`
    the launches that graph replays make, replays x kernels in the graph."""
    x = torch.ones(PROBE_SHAPE, dtype=torch.float32, device=device)
    capturing = False

    def probe(v):
        if not capturing:
            calls["launch_probe"] += 1
        return launch_probe(v)

    def x1():
        return probe(x)

    def x4():
        return probe(probe(probe(probe(x))))

    got1, got4 = x1(), x4()
    want = launch_probe_reference(x)
    exact = bool(torch.equal(got1, want)) and bool(torch.equal(got4, want * 8.0))
    err = max((got1 - want).abs().max().item(), (got4 - want * 8.0).abs().max().item())
    nbytes = 2 * x.numel() * 4  # the tile read once and written once
    rec = {"part": "launch", "kernel": "launch_probe", "shape": list(PROBE_SHAPE),
           "exact": exact, "max_abs_err": err, "main": True, "bytes": nbytes,
           "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    rec[ms_key("kernel", device)] = time_ms(x1, args.iters, device)
    rec[ms_key("plain", device)] = time_ms(lambda: launch_probe_reference(x), args.iters, device)
    rec[ms_key("library", device)] = time_ms(lambda: torch.mul(x, 2), args.iters, device)
    # the fixed cost of one launch, two ways: on the host clock over
    # back-to-back calls (what the host spends per launch), and by CUDA
    # events (what the device spends per kernel once the host is ahead);
    # each as (x4 - x1) / 3
    host = "host_us" if device.type == "cuda" else "host_cpu_us"
    e1, e4 = (_host_us_per_call(fn, EAGER_RUNS, device) for fn in (x1, x4))
    rec.update({f"eager_x1_{host}": e1, f"eager_x4_{host}": e4,
                f"eager_per_call_{host}": (e4 - e1) / 3})
    if device.type != "cuda":
        rec["graph"] = "not measured on the CPU"
        return [rec]
    d1, d4 = (time_ms(fn, args.iters, device) * 1e3 for fn in (x1, x4))
    rec.update({"eager_x1_device_us": d1, "eager_x4_device_us": d4,
                "eager_per_call_device_us": (d4 - d1) / 3})
    replays = {}
    for name, fn, kernels in (("x1", x1, 1), ("x4", x4, 4)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm the allocator off the capture, as torch.cuda.graphs asks
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        capturing = True
        with torch.cuda.graph(graph):
            graph_out = fn()
        capturing = False

        def replay(graph=graph, kernels=kernels):
            calls["launch_probe_graph"] += kernels
            graph.replay()

        replay()
        torch.cuda.synchronize()
        rec["exact"] = rec["exact"] and bool(torch.equal(graph_out, x * 2.0**kernels))
        replays[name] = replay
    g1, g4 = (_host_us_per_call(replays[n], EAGER_RUNS, device) for n in ("x1", "x4"))
    gd1, gd4 = (time_ms(replays[n], args.iters, device) * 1e3 for n in ("x1", "x4"))
    rec.update({"graph_x1_host_us": g1, "graph_x4_host_us": g4,
                "graph_per_call_host_us": (g4 - g1) / 3,
                "graph_x1_device_us": gd1, "graph_x4_device_us": gd4,
                "graph_per_call_device_us": (gd4 - gd1) / 3})
    return [rec]


def run(args) -> dict:
    if args.dtype != "float32":
        raise SystemExit(f"--dtype {args.dtype!r}: the port serves RT-DETR under float32 only "
                         f"(its mixed and bfloat16 policies are ROADMAP Queue 1 item 9)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        use_exact_float32()
    size = 64 if args.tiny else 640
    calls = {"launch_probe": 0, "launch_probe_graph": 0, "msda_gather_sum": 0}
    record = {"tool": "profile_r101", **device_record(device), "batch": args.batch,
              "size": size, "tiny": args.tiny, "dtype": args.dtype, "seed": args.seed,
              "parts": args.parts, "cases": []}
    px = pixels(args.batch, size, args.seed, device) if {"layers", "backbone"} & set(args.parts) else None
    # the default MSDA path (SPOTTER_TPU_MSDA=xla, SPOTTER_TPU_MSDA_PREP=xla)
    # whatever the process's knobs, so each sampling op is one gather-sum
    saved = msda.MSDA_BACKEND, msda.MSDA_PREP
    msda.MSDA_BACKEND, msda.MSDA_PREP = "xla", "xla"
    try:
        with torch.inference_mode():
            for part in args.parts:
                if part == "layers":
                    recs = part_layers(args, device, px, calls)
                elif part == "backbone":
                    recs = part_backbone(args, device, px)
                elif part == "topk":
                    recs = part_topk(args, device, size)
                elif part == "msda":
                    recs = part_msda(args, device, size, calls)
                else:
                    recs = part_launch(args, device, calls)
                for rec in recs:
                    record["cases"].append(rec)
                    print(json.dumps(rec), flush=True)
    finally:
        msda.MSDA_BACKEND, msda.MSDA_PREP = saved
    record["calls"] = calls
    return record


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--parts", default=",".join(DEFAULT_PARTS),
                    type=lambda s: [p for p in s.split(",") if p])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--layers-set", default="1,3,6",
                    type=lambda s: [int(v) for v in s.split(",") if v])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="the zoo's tiny RT-DETR at 64x64")
    ap.add_argument("--out", default=str(REPO / "build" / "profile_r101.json"))
    args = ap.parse_args(argv)
    unknown = set(args.parts) - set(DEFAULT_PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)} (the JAX tool's TPU ablations are not ported)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    record = run(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
