"""Where the device time of one detector forward goes, on the card.

Builds the full-width model from a seed (as chip_smoke.py does), under the
SPOTTER_TPU_DTYPE policy (float32 when unset; TF32 off under every
policy) at batch B, and reports, under each
SPOTTER_TPU_MSDA backend asked for:

- per-stage device time from CUDA events recorded by forward hooks on the
  model's top-level modules, and on each MSDA attention inside its layers,
  plus the glue between them (total minus the stages);
- from torch.profiler over a few forwards: the device's busy share (kernel
  time over wall time) and the kernels that take the most time.

Models: RT-DETRv2-R101 (default) on random 640x640 pixels, or one of the
shortest-edge families on random pixels staged as an 800x1066 photo in the
1333x1333 bucket, with its pixel mask: SenseTime/deformable-detr, and the
DETR lineage (facebook/detr-resnet-50, microsoft/table-transformer-detection,
microsoft/conditional-detr-resnet-50, IDEA-Research/dab-detr-resnet-50; their
shared box head, which DAB-DETR also runs inside its decoder loop, counts
as "heads").

With --int8 conv|dense|attn the forward runs with SPOTTER_TPU_INT8 (conv),
also _INT8_DENSE (dense), also _INT8_ATTN (attn) switched on in
utils/quant.py, so the stage table is the int8 forward's; the record counts
the quantized calls a forward makes.

    python -m spotter_tpu_torch.tools.profile_forward [--model NAME] [--batch 8]
        [--msda-backends xla,pallas_sep,pallas_gather] [--int8 conv|dense|attn] [--seed 0]

Needs a CUDA device. Writes build/profile_forward.json (or --out).
"""

import argparse
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch

from spotter_tpu_torch.models.registry import build_detector
from spotter_tpu_torch.ops import msda
from spotter_tpu_torch.ops.preprocess import (
    device_rescale_normalize,
    device_rescale_normalize_masked,
)
from spotter_tpu_torch.utils import quant
from spotter_tpu_torch.utils.precision import policy_name, use_exact_float32

# --int8 level -> the knobs it switches on
INT8_LEVELS = {"conv": ("INT8",), "dense": ("INT8", "INT8_DENSE"),
               "attn": ("INT8", "INT8_DENSE", "INT8_ATTN")}
REPO = Path(__file__).resolve().parents[2]
ITERS = 5  # timed forwards per measurement
RTDETR = "PekingU/rtdetr_v2_r101vd"
DDETR_VALID_HW = (800, 1066)  # a 720x960 listing photo at shortest edge 800

STAGES = {  # per model: (stage, prefixes of top-level module names)
    RTDETR: (
        ("backbone", ("backbone",)),
        ("hybrid_encoder", ("enc_proj", "aifi", "lateral_conv", "fpn_block",
                            "downsample_conv", "pan_block")),
        ("query_selection", ("dec_proj", "enc_output_dense", "enc_output_norm",
                             "enc_score_head", "enc_bbox_head")),
        ("decoder_layers", ("decoder_layer",)),
        ("decoder_heads", ("query_pos_head", "bbox_head", "class_head")),
    ),
    "SenseTime/deformable-detr": (
        ("backbone", ("backbone",)),
        ("input_projections", ("input_proj",)),
        ("encoder_layers", ("encoder_layer",)),
        ("decoder_layers", ("decoder_layer",)),
        ("heads", ("class_head", "bbox_head", "reference_points_proj", "enc_output",
                   "pos_trans")),
    ),
    "facebook/detr-resnet-50": (
        ("backbone", ("backbone",)),
        ("encoder", ("input_projection", "encoder_layer", "encoder_layernorm")),
        ("decoder", ("decoder_layer", "decoder_layernorm")),
        ("heads", ("class_labels_classifier", "bbox_predictor")),
    ),
    "microsoft/conditional-detr-resnet-50": (
        ("backbone", ("backbone",)),
        ("encoder", ("input_projection", "encoder_layer")),
        ("decoder", ("ref_point_head", "query_scale", "decoder_layer", "decoder_layernorm")),
        ("heads", ("class_labels_classifier", "bbox_predictor")),
    ),
    "IDEA-Research/dab-detr-resnet-50": (
        ("backbone", ("backbone",)),
        ("encoder", ("input_projection", "encoder_query_scale", "encoder_layer")),
        ("decoder", ("ref_point_head", "query_scale", "ref_anchor_head", "decoder_layer",
                     "decoder_layernorm")),
        ("heads", ("class_embed", "bbox_predictor")),
    ),
}
STAGES["microsoft/table-transformer-detection"] = STAGES["facebook/detr-resnet-50"]
MSDA_WRAPPERS = ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum", "msda_sep_sum",
                 "msda_hd_gather_sum")


def stage_of(model_name: str, name: str) -> str:
    for stage, prefixes in STAGES[model_name]:
        if name.startswith(prefixes):
            return stage
    raise ValueError(f"top-level module {name!r} has no stage")


class EventHooks:
    """CUDA event pairs around every call of the hooked modules."""

    def __init__(self, modules: dict[str, torch.nn.Module]) -> None:
        self.pairs: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.handles = []
        for name, mod in modules.items():
            self.handles.append(mod.register_forward_pre_hook(self._pre(name)))
            self.handles.append(mod.register_forward_hook(self._post(name)))
        self._open: dict[str, torch.cuda.Event] = {}

    def _pre(self, name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev
        return hook

    def _post(self, name):
        def hook(module, args, output):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append((name, self._open.pop(name), ev))
        return hook

    def totals_ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        out: dict[str, float] = defaultdict(float)
        for name, start, end in self.pairs:
            out[name] += start.elapsed_time(end)
        return out

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def model_inputs(model_name: str, spec, batch: int, seed: int) -> tuple:
    """The forward's arguments on the card: random uint8 pixels through the
    spec's device half (for Deformable-DETR, staged with a pixel mask)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h, w = spec.input_hw
    pixels_u8 = torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, generator=gen)
    if model_name == RTDETR:
        return (device_rescale_normalize(pixels_u8.to("cuda"), spec),)
    valid = torch.tensor([DDETR_VALID_HW] * batch, dtype=torch.int32)
    return device_rescale_normalize_masked(pixels_u8.to("cuda"), valid.to("cuda"), spec)


def launches() -> dict[str, int]:
    return {name: getattr(msda, name).launches for name in MSDA_WRAPPERS}


def profile_backend(model_name: str, model, inputs: tuple) -> dict:
    """One backend's wall time, per-stage events and profiler summary."""
    for _ in range(2):
        model(*inputs)
    torch.cuda.synchronize()

    # 1. forward wall time (device-synchronised), then per-stage events
    walls = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        model(*inputs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    top = dict(model.named_children())
    attn = {f"{n}.{child}": getattr(m, child) for n, m in top.items()
            for child in ("encoder_attn", "self_attn")
            if n.startswith(("decoder_layer", "encoder_layer"))
            and type(getattr(m, child, None)).__name__ in ("DeformableAttention", "MsdaAttention")}
    hooks = EventHooks({**top, **attn})
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model(*inputs)
    end.record()
    per_module = hooks.totals_ms()
    hooks.remove()
    total_ms = start.elapsed_time(end)
    stages: dict[str, float] = defaultdict(float)
    for name, ms in per_module.items():
        if name in attn:
            layer = name.split(".")[0].rstrip("0123456789")
            stages[f"msda_attention (in {layer}s)"] += ms
        else:
            stages[stage_of(model_name, name)] += ms
    in_stages = sum(v for k, v in stages.items() if "(in " not in k)
    stages["glue (masks, positions, top-k, concat, flatten)"] = total_ms - in_stages

    # 2. torch.profiler: device busy share and the top kernels
    before = launches()
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model(*inputs)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    after = launches()
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / ITERS, e.count // ITERS)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    device_ms = sum(r[1] for r in rows)
    # the host side: the ops whose own CPU time (launch and dispatch, not
    # their children's) is largest, where a host-bound forward goes
    cpu_rows = sorted(
        ((e.key, e.self_cpu_time_total / 1e3 / ITERS, e.count // ITERS)
         for e in prof.key_averages() if e.device_type == DeviceType.CPU),
        key=lambda r: -r[1],
    )
    return {
        "forward_wall_ms_median": statistics.median(walls),
        "forward_wall_ms": walls,
        "events_total_ms": total_ms,
        "stages_ms": dict(stages),
        "per_module_ms": dict(sorted(per_module.items(), key=lambda kv: -kv[1])[:20]),
        "profiler": {
            "wall_ms_per_forward": prof_wall_ms / ITERS,
            "kernel_ms_per_forward": device_ms,
            "busy_share": device_ms / (prof_wall_ms / ITERS),
            "kernel_kinds": len(rows),
            "top_kernels": [{"name": n[:120], "ms_per_forward": ms, "calls_per_forward": c}
                            for n, ms, c in rows[:25]],
            "host_ms_per_forward": sum(r[1] for r in cpu_rows),
            "top_host_ops": [{"name": n[:80], "self_cpu_ms_per_forward": ms,
                              "calls_per_forward": c} for n, ms, c in cpu_rows[:15]],
            "msda_launches_per_forward": {k: (after[k] - before[k]) / ITERS
                                          for k in after if after[k] != before[k]},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=RTDETR, choices=sorted(STAGES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--msda-backends", default="auto",
                    help="comma-separated SPOTTER_TPU_MSDA values, profiled in turn")
    ap.add_argument("--int8", choices=sorted(INT8_LEVELS), default=None,
                    help="the int8 knobs on: conv (SPOTTER_TPU_INT8), +dense, +attn")
    ap.add_argument("--out", default=str(REPO / "build" / "profile_forward.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device available")
    backends = [msda.check_msda_backend(b) for b in args.msda_backends.split(",") if b]

    use_exact_float32()
    built = build_detector(args.model, tiny=False, seed=args.seed)
    model = built.module.to("cuda").eval()
    inputs = model_inputs(args.model, built.preprocess_spec, args.batch, args.seed)
    rec = {"device": torch.cuda.get_device_name(0), "model": args.model,
           "batch": args.batch, "policy": f"{policy_name() or 'float32'} (TF32 off)",
           "int8": args.int8, "backends": {}}
    knobs = {name: getattr(quant, name) for name in ("INT8", "INT8_DENSE", "INT8_ATTN")}
    try:
        if args.int8:
            for name in knobs:
                setattr(quant, name, name in INT8_LEVELS[args.int8])
        with torch.inference_mode():
            for backend in backends:
                msda.MSDA_BACKEND = backend
                quant.reset_calls()
                model(*inputs)
                rec.setdefault("int8_calls_per_forward", {})[backend] = dict(quant.CALLS)
                rec["backends"][backend] = profile_backend(args.model, model, inputs)
                print(json.dumps({backend: rec["backends"][backend]}), flush=True)
    finally:
        msda.MSDA_BACKEND = "auto"
        for name, value in knobs.items():
            setattr(quant, name, value)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
