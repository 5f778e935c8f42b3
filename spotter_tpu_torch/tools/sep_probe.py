"""What held the first `msda_sep_sum` kernel at 13x its bytes bound, and
what bounds the redesigned one, measured on the card.

The first kernel (one warp a query, a lane a channel) and four variants of
it (`csrc/sep_probe.cu`: predicated row loads instead of `continue`
branches; every point's operands loaded before any row; both; the tile's
operands staged in shared memory) run beside the redesigned kernel
(`ops.msda.msda_sep_sum`) at one Deformable-DETR encoder op: B = 8, the
1333x1333 bucket's four levels, 8 heads of 32, 4 points a level, 37,150
queries sampling around their own cells, bilinear, each level's operands
built as the model builds them. Every variant must equal the plain version
(`msda_sep_reference`) within 1e-5. Times are ms per op (4 launches, one a
level) by CUDA events with a cold L2, each taken twice, in the order listed
and then in reverse (both medians are kept), with the card's name and power
limit. If the variants that break the load chains run much faster than the
first kernel, latency was its limit; if the one with its operands in shared
memory does, its operand loads were.

Two more readings of the redesigned kernel: its ms per launch at each level
(a head's rows range from 3.6 MB to 56 KB, from far more than L1 holds to
well within it), and its ms per op with every sample on the cells (0, 0) to
(1, 1) and every band on (the same instructions and requests, all L1 hits;
those sums are not checked). If that case runs much faster than the real
op, row requests served from L2 are the limit; if not, the work inside the
SM is. And the SASS of the first and the redesigned kernel (fp32 rows): a
static count of its instructions and its global loads.

    python -m spotter_tpu_torch.tools.sep_probe [--batch 8] [--iters 10]
        [--seed 0] [--out build/sep_probe.json]

Needs a CUDA card: there is nothing to measure without one.
"""

import argparse
import ctypes
import functools
import json
from pathlib import Path

import torch

from spotter_tpu_torch.models.deformable_detr import encoder_reference_base
from spotter_tpu_torch.ops.msda import (
    level_offsets,
    msda_sep_reference,
    msda_sep_sum,
    sep_level_operands,
)
from spotter_tpu_torch.tools.timing import (
    cuda_time_ms,
    device_record,
    l2_flush_buffer,
    resolve_device,
)
from spotter_tpu_torch.ops.msda import build_msda_backends_kernel
from spotter_tpu_torch.utils.cuda_build import (
    KernelLibrary,
    disassemble,
    load_kernel_library,
    sass_functions,
)

REPO = Path(__file__).resolve().parents[2]
# the Deformable-DETR encoder at the 1333x1333 bucket (chip_smoke.py's
# ddetr_encoder case): levels at strides 8/16/32/64
LEVELS = ((167, 167), (84, 84), (42, 42), (21, 21))
HEADS, HD, POINTS = 8, 32, 4
VARIANTS = {0: "warp_per_query", 1: "predicated", 2: "operands_first",
            3: "predicated_operands_first", 4: "shared_operands"}
ATOL = 1e-5


@functools.cache
def build_sep_probe_kernel() -> KernelLibrary:
    loaded = load_kernel_library("sep_probe", ("sep_probe.cu",))
    fn = loaded.lib.sep_probe_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    loaded.lib.sep_probe_error_string.argtypes = [ctypes.c_int]
    loaded.lib.sep_probe_error_string.restype = ctypes.c_char_p
    return loaded


def sep_variant(variant: int, rows, xi, xw0, xw1, yi, yw0, yw1, mask, level_hw, r_band,
                n_points) -> torch.Tensor:
    """The first kernel (variant 0) or one of its variants, on msda_sep_sum's
    arguments (fp32 rows on the card)."""
    lh, lw = level_hw
    bh, _, hd = rows.shape
    n_qt, n_bands = mask.shape[1], mask.shape[2]
    out = torch.empty((bh, n_qt * 64, hd), dtype=torch.float32, device=rows.device)
    lib = build_sep_probe_kernel().lib
    ptrs = [t.data_ptr() for t in (rows, xi, xw0, xw1, yi, yw0, yw1, mask, out)]
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    code = lib.sep_probe_f32(*ptrs, bh, n_qt, n_points, lh, lw, hd, r_band, n_bands, variant,
                             stream)
    if code != 0:
        text = lib.sep_probe_error_string(code).decode()
        raise RuntimeError(f"sep_probe variant {variant} launch failed: {text} ({code})")
    return out


def sass_counts() -> dict:
    """Instructions and global loads (LDG) in the SASS of the first kernel
    (variant 0) and of the redesigned kernel, fp32 rows, vector path."""
    kernels = {"warp_per_query": (build_sep_probe_kernel, "sep_variant_kernelILb0ELb0ELb0E"),
               "redesigned": (build_msda_backends_kernel, "msda_sep_sum_kernelIfLb1ELb0E")}
    out = {}
    for name, (build, tag) in kernels.items():
        body = next(b for fn, b in sass_functions(disassemble(build().path)).items() if tag in fn)
        ops = [ln.split()[1] if ln.startswith("@") else ln.split()[0] for ln in body]
        out[name] = {"instructions": len(ops), "LDG": sum(op.startswith("LDG") for op in ops)}
    return out


def one_cell(args: tuple) -> tuple:
    """A level's arguments with every sample moved to x0 = y0 = 0 and every
    band on: the same loads, all of four rows."""
    rows, xi, xw0, xw1, yi, yw0, yw1, mask, *rest = args
    return (rows, torch.zeros_like(xi), xw0, xw1, torch.zeros_like(yi), yw0, yw1,
            torch.ones_like(mask), *rest)


def encoder_op(batch: int, seed: int, dev) -> list[tuple]:
    """msda_sep_sum's arguments for each level of one encoder op: each query
    samples around its own token's cell centre with offsets N(0, 0.02^2),
    attention softmaxed over its 16 samples, standard-normal values."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in LEVELS)
    lp = len(LEVELS) * POINTS
    ref = torch.from_numpy(encoder_reference_base(LEVELS)).to(dev)[None, :, None, None, :]
    loc = ref + 0.02 * torch.randn((batch, s, HEADS, lp, 2), generator=gen, device=dev)
    attn = torch.softmax(torch.randn((batch, s, HEADS, lp), generator=gen, device=dev), dim=-1)
    value = torch.randn((batch, s, HEADS, HD), generator=gen, device=dev)
    rows_all = value.permute(0, 2, 1, 3).reshape(batch * HEADS, s, HD)
    offs = level_offsets(LEVELS)
    calls = []
    for lvl, (lh, lw) in enumerate(LEVELS):
        pts = slice(lvl * POINTS, (lvl + 1) * POINTS)
        ops, mask, r_band = sep_level_operands(loc[:, :, :, pts], attn[:, :, :, pts], lh, lw)
        rows_l = rows_all[:, offs[lvl]:offs[lvl] + lh * lw].contiguous()
        calls.append((rows_l, *ops, mask, (lh, lw), r_band, POINTS))
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "sep_probe.json"))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    calls = encoder_op(args.batch, args.seed, dev)
    runs = {name: functools.partial(sep_variant, v) for v, name in VARIANTS.items()}
    runs["redesigned"] = msda_sep_sum
    errs = {name: 0.0 for name in runs}
    for args_l in calls:
        want = msda_sep_reference(*args_l)
        for name, fn in runs.items():
            errs[name] = max(errs[name], (fn(*args_l) - want).abs().max().item())
        del want
    torch.cuda.synchronize()
    flush = l2_flush_buffer(dev)
    order = [*runs, *reversed(runs)]
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_time_ms(lambda fn=runs[name]: [fn(*a) for a in calls],
                                        args.iters, flush))
    per_level = [cuda_time_ms(lambda a=a: msda_sep_sum(*a), args.iters, flush) for a in calls]
    cell_calls = [one_cell(a) for a in calls]
    one_cell_ms = [cuda_time_ms(lambda: [msda_sep_sum(*a) for a in cell_calls], args.iters, flush)
                   for _ in range(2)]
    rec = {
        "tool": "sep_probe", **device_record(dev), "batch": args.batch,
        "levels": [list(hw) for hw in LEVELS], "heads": HEADS, "hd": HD, "points": POINTS,
        "launches_per_op": len(LEVELS), "atol": ATOL,
        "variants": {name: {"max_abs_err": errs[name], "ms_per_op": times[name],
                            "ms_per_launch": [t / len(LEVELS) for t in times[name]]}
                     for name in runs},
        "redesigned_ms_per_launch_by_level": per_level,
        "redesigned_one_cell_ms_per_op": one_cell_ms,
        "sass": sass_counts(),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    wrong = {name: e for name, e in errs.items() if not e <= ATOL}
    if wrong:
        raise SystemExit(f"sep_probe: variants differ from the plain version: {wrong}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
