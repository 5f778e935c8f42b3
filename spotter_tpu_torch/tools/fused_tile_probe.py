"""Which query tile the fused MSDA kernel (`msda_fused_sum`) should take,
measured on the card.

`csrc/msda.cu` fixes the tile at build time (`MSDA_FUSED_Q_TILE`, 32 in the
library the port serves with). This probe builds the same source with
tiles of 16 (128 threads a block) and 64 (256 threads) as libraries of its
own and runs them beside the served kernel at RT-DETR's decoder op: 300
queries, D = 256, 8 heads of 32, 3 levels of 4 points (80x80, 40x40,
20x20), fp32 rows, hidden states and projections standard normal from
`--seed`, at each of `--batches`. Every tile must equal the plain version
(`msda_fused_reference`) within 1e-5 under both methods, every row
compared. Times are ms per launch (default method) by CUDA events with a
cold L2, each taken in the order 16, 32, 64 and then in reverse (both
medians kept), with the card's name and power limit. More blocks (a
smaller tile) fill 132 SMs better at B = 1; a larger tile reads its
head's weights fewer times at B = 8.

    python -m spotter_tpu_torch.tools.fused_tile_probe [--batches 1 8]
        [--iters 30] [--seed 0] [--out build/fused_tile_probe.json]

Needs a CUDA card: there is nothing to measure without one.
"""

import argparse
import ctypes
import functools
import json
from pathlib import Path

import torch

from spotter_tpu_torch.ops.msda import (
    fused_anchors,
    fused_head_weights,
    level_tables,
    msda_fused_reference,
    msda_fused_sum,
)
from spotter_tpu_torch.tools.timing import (
    cuda_time_ms,
    device_record,
    l2_flush_buffer,
    resolve_device,
)
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

REPO = Path(__file__).resolve().parents[2]
LEVELS = ((80, 80), (40, 40), (20, 20))
HEADS, HD, QUERIES, POINTS, D_MODEL = 8, 32, 300, 4, 256
SERVED_TILE = 32
PROBE_TILES = (16, 64)
ATOL = 1e-5


@functools.cache
def build_tile_kernel(tile: int) -> KernelLibrary:
    loaded = load_kernel_library(f"msda_tile{tile}", ("msda.cu",),
                                 defines=(f"-DMSDA_FUSED_Q_TILE={tile}",))
    fn = loaded.lib.msda_fused_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    loaded.lib.msda_error_string.argtypes = [ctypes.c_int]
    loaded.lib.msda_error_string.restype = ctypes.c_char_p
    return loaded


def fused_tile(tile: int, rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
               level_h, level_w, level_off, method: str = "default") -> torch.Tensor:
    """The fused kernel built with a `tile`-query block, on msda_fused_sum's
    arguments (fp32, contiguous, on the card)."""
    tensors = (rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale, level_h, level_w,
               level_off)
    bh, s, hd = rows.shape
    b, q, d = hs.shape
    h_axis, lp = w_att_h.shape[0], w_att_h.shape[2]
    out = torch.empty((bh, q, hd), dtype=torch.float32, device=rows.device)
    lib = build_tile_kernel(tile).lib
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    code = lib.msda_fused_sum_f32(*(t.data_ptr() for t in tensors), out.data_ptr(), b, h_axis,
                                  s, hd, q, d, lp, int(method == "discrete"), stream)
    if code != 0:
        text = lib.msda_error_string(code).decode()
        raise RuntimeError(f"fused tile {tile} launch failed: {text} ({code})")
    return out


def decoder_op(batch: int, seed: int, dev) -> tuple:
    """msda_fused_sum's arguments at one RT-DETR decoder op."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = len(LEVELS) * POINTS
    s = sum(h * w for h, w in LEVELS)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = randn(batch * HEADS, s, HD)
    hs = randn(batch, QUERIES, D_MODEL)
    centre = 0.05 + 0.9 * torch.rand((batch, QUERIES, 2), generator=gen, device=dev)
    size = 0.05 + 0.45 * torch.rand((batch, QUERIES, 2), generator=gen, device=dev)
    heads = fused_head_weights(
        randn(D_MODEL, HEADS * lp * 2, scale=D_MODEL**-0.5), randn(HEADS * lp * 2, scale=0.1),
        randn(D_MODEL, HEADS * lp, scale=D_MODEL**-0.5), randn(HEADS * lp, scale=0.1), HEADS)
    base, scale = fused_anchors(torch.cat([centre, size], -1), lp, POINTS, 0.5)
    return (rows, hs, *heads, base, scale, *level_tables(LEVELS, POINTS, dev, torch.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" / "fused_tile_probe.json"))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    runs = {tile: functools.partial(fused_tile, tile) for tile in PROBE_TILES}
    runs[SERVED_TILE] = msda_fused_sum
    tiles = sorted(runs)
    flush = l2_flush_buffer(dev)
    cases = []
    for batch in args.batches:
        op = decoder_op(batch, args.seed + batch, dev)
        errs = {}
        for method in ("default", "discrete"):
            want = msda_fused_reference(*op, method)
            for tile in tiles:
                err = (runs[tile](*op, method) - want).abs().max().item()
                errs[tile] = max(errs.get(tile, 0.0), err)
        times = {tile: [] for tile in tiles}
        for tile in [*tiles, *reversed(tiles)]:
            times[tile].append(cuda_time_ms(lambda fn=runs[tile]: fn(*op), args.iters, flush))
        cases.append({"batch": batch, "tiles": {
            str(tile): {"max_abs_err": errs[tile], "ms": times[tile],
                        "served": tile == SERVED_TILE} for tile in tiles}})
    rec = {
        "tool": "fused_tile_probe", **device_record(dev), "levels": [list(hw) for hw in LEVELS],
        "heads": HEADS, "hd": HD, "queries": QUERIES, "points": POINTS, "d_model": D_MODEL,
        "atol": ATOL, "cases": cases,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    wrong = {(c["batch"], t): v["max_abs_err"] for c in cases for t, v in c["tiles"].items()
             if not v["max_abs_err"] <= ATOL}
    if wrong:
        raise SystemExit(f"fused_tile_probe: tiles differ from the plain version: {wrong}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
