"""How far the class-logit kernel's time is its stream of img, on the card.

`owl_class_logits` (`csrc/class_logits.cu`) streams img through a ring of
TMA slabs, one persistent block an SM. For OWLv2's head (B = 8 and 1, P =
3600, Dt = 512, the 22-query default vocabulary; fp32 and bf16 img) and
OWL-ViT B/32's (B = 8, P = 576) this probe records, per case, the kernel's
ms after the tools' L2 flush (`cuda_time_ms`: 128 MB zeroed, which leaves
up to 50 MB of dirty lines in L2 for the timed launch to write back) and
after a clean one (64 MB zeroed, then another 64 MB read), and, after a
clean flush, `img.sum()`: one PyTorch call that streams the same bytes (a
yardstick for the read, not for the function).

    python -m spotter_tpu_torch.tools.class_logits_probe [--iters 50]
        [--seed 0] [--out build/class_logits_probe.json]

Needs a CUDA card: there is nothing to measure without one.
"""

import argparse
import functools
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from spotter_tpu_torch.ops import openvocab
from spotter_tpu_torch.tools.timing import (
    TIMING_LEAD_CYCLES,
    cuda_time_ms,
    device_record,
    l2_flush_buffer,
    resolve_device,
)

REPO = Path(__file__).resolve().parents[2]
TEXT_WIDTH = 512
CASES = ((torch.float32, 8, 3600), (torch.bfloat16, 8, 3600), (torch.float32, 1, 3600),
         (torch.float32, 8, 576))
QUERIES = 22


def clean_time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median ms of `fn` by CUDA events, each launch after half of `flush`
    is zeroed and the other half read: L2 then holds clean lines only."""
    half = flush.numel() // 2
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush[:half].zero_()
        flush[half:].view(torch.int32).sum()
        torch.cuda._sleep(TIMING_LEAD_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def head_inputs(dtype, b: int, p: int, seed: int, dev) -> tuple:
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.standard_normal((b, p, TEXT_WIDTH)).astype(np.float32))
    bank = rng.standard_normal((QUERIES, TEXT_WIDTH)).astype(np.float32)
    bank = torch.from_numpy(bank / np.linalg.norm(bank, axis=-1, keepdims=True))
    shift = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
    return img.to(dev).to(dtype), bank.to(dev), shift.to(dev), scale.to(dev), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "class_logits_probe.json"))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    flush = l2_flush_buffer(dev)
    record = {"tool": "class_logits_probe", **device_record(dev), "seed": args.seed,
              "queries": QUERIES, "text_width": TEXT_WIDTH, "cases": []}
    print(json.dumps({k: v for k, v in record.items() if k != "cases"}), flush=True)
    for dtype, b, p in CASES:
        inputs = head_inputs(dtype, b, p, args.seed, dev)
        img = inputs[0]
        run = functools.partial(openvocab.owl_class_logits, *inputs)
        rec = {"img_dtype": str(dtype).removeprefix("torch."), "batch": b, "patches": p,
               "bytes_read": img.numel() * img.element_size(),
               "kernel_ms": cuda_time_ms(run, args.iters, flush),
               "kernel_clean_l2_ms": clean_time_ms(run, args.iters, flush),
               "torch_sum_clean_l2_ms": clean_time_ms(lambda: img.sum(), args.iters, flush)}
        record["cases"].append(rec)
        print(json.dumps(rec), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
