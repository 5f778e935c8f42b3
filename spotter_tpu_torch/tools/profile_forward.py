"""Where the device time of one RT-DETRv2 forward goes, on the card.

Builds the full-width model from a seed (as chip_smoke.py does), runs the
float32 policy (TF32 off) at batch B on random 640x640 pixels, and reports:

- per-stage device time from CUDA events recorded by forward hooks on the
  model's top-level modules (backbone, hybrid encoder, query selection
  heads, decoder layers and their deformable cross-attention, box/class
  heads), plus the glue between them (total minus the stages);
- from torch.profiler over a few forwards: the device's busy share (kernel
  time over wall time) and the kernels that take the most time.

    python -m spotter_tpu_torch.tools.profile_forward [--batch 8] [--seed 0]

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
from spotter_tpu_torch.ops.msda import msda_gather_sum
from spotter_tpu_torch.ops.preprocess import device_rescale_normalize
from spotter_tpu_torch.utils.precision import use_exact_float32

REPO = Path(__file__).resolve().parents[2]
ITERS = 5  # timed forwards per measurement

STAGES = (  # (stage, prefixes of top-level module names)
    ("backbone", ("backbone",)),
    ("hybrid_encoder", ("enc_proj", "aifi", "lateral_conv", "fpn_block",
                        "downsample_conv", "pan_block")),
    ("query_selection", ("dec_proj", "enc_output_dense", "enc_output_norm",
                         "enc_score_head", "enc_bbox_head")),
    ("decoder_layers", ("decoder_layer",)),
    ("decoder_heads", ("query_pos_head", "bbox_head", "class_head")),
)


def stage_of(name: str) -> str:
    for stage, prefixes in STAGES:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "profile_forward.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device available")

    use_exact_float32()
    built = build_detector("PekingU/rtdetr_v2_r101vd", tiny=False, seed=args.seed)
    model = built.module.to("cuda").eval()
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    pixels_u8 = torch.randint(0, 256, (args.batch, 640, 640, 3), dtype=torch.uint8,
                              generator=gen).to("cuda")
    x = device_rescale_normalize(pixels_u8, built.preprocess_spec)

    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()

        # 1. forward wall time (device-synchronised), then per-stage events
        walls = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        top = dict(model.named_children())
        attn = {f"{n}.encoder_attn": m.encoder_attn for n, m in top.items()
                if n.startswith("decoder_layer")}
        hooks = EventHooks({**top, **attn})
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model(x)
        end.record()
        per_module = hooks.totals_ms()
        hooks.remove()
        total_ms = start.elapsed_time(end)
        stages: dict[str, float] = defaultdict(float)
        for name, ms in per_module.items():
            if name.endswith(".encoder_attn"):
                stages["decoder_cross_attention (in decoder_layers)"] += ms
            else:
                stages[stage_of(name)] += ms
        in_stages = sum(v for k, v in stages.items() if "(in " not in k)
        stages["glue (top-k, anchors, concat, flatten)"] = total_ms - in_stages

        # 2. torch.profiler: device busy share and the top kernels
        launches_before = msda_gather_sum.launches
        from torch.profiler import DeviceType, ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                model(x)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / ITERS, e.count // ITERS)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    device_ms = sum(r[1] for r in rows)
    rec = {
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "policy": "float32 (TF32 off)",
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
            "msda_launches": msda_gather_sum.launches - launches_before,
        },
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
