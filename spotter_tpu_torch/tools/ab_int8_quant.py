"""The int8 quantize entries other than the im2col's, and the forwards that
run them, timed on one tree of the repo: run it on two trees in one sitting
on the card (A, B, B, A) to compare them.

For the tree at --root (default: this checkout), on the card:

- the `rows` entry at YOLOS-base's fc1 activations (34,408 x 768 bf16, 8
  groups) through `ops/int8.py`'s `quantize_rows`, and the `heads` and
  `heads_t` entries at RT-DETR's decoder V (8, 300, 8, 32) fp32 through
  `quantize_heads`: each wrapper call whole (its amax pass, and whatever
  else the tree launches for it, then the quantize pass), CUDA events, a
  cold L2;
- YOLOS-base under "mixed" with SPOTTER_TPU_INT8 and _INT8_DENSE at B = 8
  (`chip_smoke.int8_family_forward`: device ms of the int8 and the float
  forward, bit equal to its plain witness);
- RT-DETRv2-R101 under "bfloat16" with all three int8 knobs at B = 8
  (`tools/profile_forward.py --int8 attn`: wall ms, device ms and the
  device ms of the amax and quantize kernels a forward, from torch.profiler).

    python -m spotter_tpu_torch.tools.ab_int8_quant [--root DIR] [--seed 0]
        [--out build/ab_int8_quant.json]

Imports the port and chip_smoke.py from --root, so both trees are measured
by the same code where it is the same.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ITERS = 20


def entries(int8, timing, seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    flush = timing.l2_flush_buffer()
    x = torch.from_numpy(rng.standard_normal((8 * 4301, 768), dtype=np.float32))
    x = x.to("cuda", torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((8, 300, 8, 32), dtype=np.float32)).to("cuda")
    return {"rows_ms": timing.cuda_time_ms(lambda: int8.quantize_rows(x, 4301, 768), ITERS,
                                           flush),
            "heads_ms": timing.cuda_time_ms(lambda: int8.quantize_heads(v, False), ITERS, flush),
            "heads_t_ms": timing.cuda_time_ms(lambda: int8.quantize_heads(v, True), ITERS,
                                              flush)}


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
    from spotter_tpu_torch.tools import profile_forward, timing
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
    prof_out = Path(args.out).with_suffix(".rtdetr.json")
    with chip_smoke.precision_policy("bfloat16"):
        profile_forward.main(["--batch", "8", "--int8", "attn", "--seed", str(args.seed),
                              "--out", str(prof_out)])
    (backend, prof), = json.loads(prof_out.read_text())["backends"].items()
    quant_kernels = [k for k in prof["profiler"]["top_kernels"]
                     if "quantize" in k["name"] or "amax" in k["name"]]
    rec["rtdetr_bf16_all_knobs_b8"] = {
        "backend": backend, "forward_wall_ms_median": prof["forward_wall_ms_median"],
        "kernel_ms_per_forward": prof["profiler"]["kernel_ms_per_forward"],
        "quant_kernels": quant_kernels,
        "quant_kernel_ms_per_forward": sum(k["ms_per_forward"] for k in quant_kernels)}
    print(json.dumps(rec["rtdetr_bf16_all_knobs_b8"]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
