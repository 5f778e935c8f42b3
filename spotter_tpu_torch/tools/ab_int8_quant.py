"""The int8 quantize passes, and the forwards that run them, timed on one
tree of the repo: run it on two trees in one sitting on the card (A, B, B,
A) to compare them.

For the tree at --root (default: this checkout), on the card:

- the `rows` entry at YOLOS-base's fc1 activations (34,408 x 768 bf16, 8
  groups) through `ops/int8.py`'s `quantize_rows`, and the `heads` and
  `heads_t` entries at RT-DETR's decoder V (8, 300, 8, 32) fp32 through
  `quantize_heads`: each wrapper call whole (its amax pass, where the tree
  launches one, and the quantize pass), CUDA events, a cold L2;
- the convolution's NHWC codes at `csp80` (8, 384, 80, 80) bf16 from its
  amax partials: `nhwc_codes`, or on a tree without it the im2col entry at
  kernel size 1;
- YOLOS-base under "mixed" with SPOTTER_TPU_INT8 and _INT8_DENSE at B = 8
  (`chip_smoke.int8_family_forward`: device ms of the int8 and the float
  forward, bit equal to its plain witness);
- RT-DETRv2-R101 under "bfloat16" with all three int8 knobs at B = 8: wall
  ms, and from torch.profiler the device ms a forward of every kernel, of
  the amax and quantize kernels but the convolution's NHWC pass (names
  with "amax" or "quantize", not "transpose" or "im2col"), and of that
  pass apart.

    python -m spotter_tpu_torch.tools.ab_int8_quant [--root DIR] [--seed 0]
        [--out build/ab_int8_quant.json]

Imports the port and chip_smoke.py from --root, so both trees are measured
by the same code where it is the same.
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ITERS = 20
PROFILED = 5  # forwards in the profiler's window


def entries(int8, timing, seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    flush = timing.l2_flush_buffer()
    x = torch.from_numpy(rng.standard_normal((8 * 4301, 768), dtype=np.float32))
    x = x.to("cuda", torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((8, 300, 8, 32), dtype=np.float32)).to("cuda")
    c = torch.from_numpy(rng.standard_normal((8, 384, 80, 80), dtype=np.float32))
    c = c.to("cuda", torch.bfloat16)
    ax = int8.amax_samples(c)
    if hasattr(int8, "nhwc_codes"):
        def nhwc():
            return int8.nhwc_codes(c, ax, 384)
    else:
        def nhwc():
            return int8.im2col_codes(c, ax, 1, 1, 0, 384)
    return {"rows_ms": timing.cuda_time_ms(lambda: int8.quantize_rows(x, 4301, 768), ITERS,
                                           flush),
            "heads_ms": timing.cuda_time_ms(lambda: int8.quantize_heads(v, False), ITERS, flush),
            "heads_t_ms": timing.cuda_time_ms(lambda: int8.quantize_heads(v, True), ITERS,
                                              flush),
            "nhwc_csp80_bf16_ms": timing.cuda_time_ms(nhwc, ITERS, flush)}


def rtdetr_all_knobs(chip_smoke, seed: int) -> dict:
    """RT-DETRv2-R101, "bfloat16", all int8 knobs, B = 8: wall ms a forward
    and the device ms of its kernels by kind (module docstring)."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from spotter_tpu_torch.models.registry import build_detector
    from spotter_tpu_torch.tools.profile_forward import model_inputs

    with chip_smoke.precision_policy("bfloat16"):
        # built and moved outside inference mode: its params keep version
        # counters, so the weights' codes are kept after the first forward
        built = build_detector(chip_smoke.MODEL_NAME, tiny=False, seed=seed)
        model = built.module.to("cuda").eval()
        inputs = model_inputs(chip_smoke.MODEL_NAME, built.preprocess_spec, 8, seed)
        with chip_smoke.int8_knobs("attn"), torch.inference_mode():
            walls = []
            for _ in range(3 + ITERS // 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(*inputs)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED):
                    model(*inputs)
                torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] += e.self_device_time_total / 1e3 / PROFILED
    quant = {n: ms for n, ms in by_name.items() if "amax" in n or "quantize" in n}
    conv = {n: ms for n, ms in by_name.items()
            if n in quant and ("transpose" in n or "im2col" in n) or "im2col" in n}
    rest = {n: ms for n, ms in quant.items() if n not in conv}
    return {"forward_wall_ms_median": statistics.median(walls[3:]),
            "kernel_ms_per_forward": sum(by_name.values()),
            "quant_kernels": {n[:100]: ms for n, ms in rest.items()},
            "quant_kernel_ms_per_forward": sum(rest.values()),
            "conv_nhwc_kernels": {n[:100]: ms for n, ms in conv.items()},
            "conv_nhwc_ms_per_forward": sum(conv.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "ab_int8_quant.json"))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    for name in [m for m in sys.modules if m.split(".")[0] in ("spotter_tpu_torch", "chip_smoke")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_int8_quant: no CUDA device available")
    import chip_smoke
    from spotter_tpu_torch.ops import int8
    from spotter_tpu_torch.tools import timing
    from spotter_tpu_torch.utils.precision import use_exact_float32

    if not int8.__file__.startswith(str(root)):
        raise SystemExit(f"ab_int8_quant: imported {int8.__file__}, not from {root}")
    use_exact_float32()
    rec = {"root": str(root), "card": chip_smoke.nvidia_smi("name,power.limit"),
           "entries": entries(int8, timing, args.seed)}
    print(json.dumps(rec), flush=True)
    rng = np.random.default_rng(args.seed + 40)
    photos = [chip_smoke.synthetic_photo(rng, h, w) for h, w in chip_smoke.PHOTO_SIZES]
    flush = timing.l2_flush_buffer()
    yolos = chip_smoke.int8_family_forward(chip_smoke.YOLOS_NAME, "mixed", "dense", args.seed,
                                           photos, flush, "cuda")
    rec["yolos_mixed_dense_b8"] = {k: yolos[k] for k in (
        "device_ms_b8", "float_device_ms_b8", "launches_per_forward", "plain_witness_b8")}
    print(json.dumps(rec["yolos_mixed_dense_b8"]), flush=True)
    rec["rtdetr_bf16_all_knobs_b8"] = rtdetr_all_knobs(chip_smoke, args.seed)
    print(json.dumps(rec["rtdetr_bf16_all_knobs_b8"]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
