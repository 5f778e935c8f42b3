"""What the tensor cores' rounding costs the attention kernels, simulated
on the CPU. A design check, not a device measurement.

`--precision bf16` (the default): the bf16 kernel feeds the softmax's
probabilities P to the P.V product on the tensor cores, which take bf16.
The tool replays the kernel's arithmetic in float64 on the inputs the
`cuda` tests draw (numpy seed, q scaled by 2 * hd**-0.5), with an online
softmax over tiles of `--tile` keys and the row sums of the unrounded P, two
ways:

- `single`: P rounded to one bf16 term;
- `split`: P = P_hi + P_lo, both bf16 (P_lo the residue), the kernel's way;

rounds each output to bf16, and prints per shape the largest difference
from the exact softmax rounded to bf16, as a share of the largest output,
beside the tests' gate of 2**-8.

`--precision fp32`: the fp32 kernel takes Q.K^T and P.V on the TF32 tensor
cores with each operand split in two TF32 terms, x = hi + lo (hi = x rounded
to nearest, `cvt.rna.tf32.f32`; lo the residue, which the tensor cores read
as TF32: modelled as truncated, the worse of the two readings). Each
product takes 1, 2 or 3 terms of hi.hi, hi.lo, lo.hi, in that order
(A.B: Q.K^T's A is Q, P.V's A is P). The tool replays every combination of
(Q.K^T terms, P.V terms) in float64 over the kernel's key tiles (64 keys at
hd 64, 32 at hd 128) on fp32 inputs drawn as above, and prints per shape
each combination's largest difference from the exact softmax, as a share of
the largest output, beside the fp32 gate of 2e-5 and the kernel's design
margin of half of it (the card's fp32 sums add their own error).

    python -m spotter_tpu_torch.tools.attention_rounding
        [--precision bf16|fp32] [--shapes 1x1100x2x128,2x4301x12x64]
        [--tile N] [--seed 0]
"""

import argparse
import json

import numpy as np
import torch

from spotter_tpu_torch.ops.attention import TF32_DROP_BITS, tf32_split

DEFAULT_SHAPES = ((1, 1100, 2, 128), (2, 1100, 3, 64), (1, 1025, 12, 64), (1, 1025, 2, 128),
                  (1, 4301, 12, 64), (1, 3601, 12, 64), (2, 4301, 12, 64), (2, 3601, 12, 64))
GATE = 2.0**-8
# the fp32 kernel's `cuda` test shapes: the served ones, partial tiles, hd 128
FP32_SHAPES = ((1, 4301, 12, 64), (1, 3601, 12, 64), (1, 1025, 12, 64), (1, 1100, 2, 128),
               (2, 1025, 2, 128))
FP32_GATE = 2e-5  # chip_smoke's and the cuda tests' fp32 gate, of the largest output
FP32_TERMS = ("hi.hi", "hi.lo", "lo.hi")  # a product with n terms takes the first n


def inputs(shape, seed: int) -> list[torch.Tensor]:
    """q, k, v as the cuda tests draw them, rounded to bf16, held in float64."""
    b, s, h, hd = shape
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape) * 2.0 * hd**-0.5).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16).double() for a in (q, k, v)]


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def online_softmax(scores: torch.Tensor, v: torch.Tensor, tile: int, split: bool) -> torch.Tensor:
    """One head: scores (S, S), v (S, hd) -> (S, hd), P rounded per `split`."""
    s = scores.shape[0]
    out = torch.zeros(s, v.shape[1], dtype=torch.float64)
    l_run = torch.zeros(s, 1, dtype=torch.float64)
    m_run = torch.full((s, 1), -torch.inf, dtype=torch.float64)
    for k0 in range(0, s, tile):
        block = scores[:, k0:k0 + tile]
        m_new = torch.maximum(m_run, block.max(-1, keepdim=True).values)
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(block - m_new)
        p_hi = bf16(p)
        p_used = p_hi + bf16(p - p_hi) if split else p_hi
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        out = out * alpha + p_used @ v[k0:k0 + tile]
        m_run = m_new
    return out / l_run


def shape_errors(shape, seed: int, tile: int) -> dict:
    q, k, v = inputs(shape, seed)
    b, _, h, _ = shape
    exact = torch.empty(q.shape, dtype=torch.float64)
    got = {"single": torch.empty_like(exact), "split": torch.empty_like(exact)}
    for bi in range(b):
        for hi in range(h):
            scores = q[bi, :, hi] @ k[bi, :, hi].T
            exact[bi, :, hi] = torch.softmax(scores, -1) @ v[bi, :, hi]
            for mode, out in got.items():
                out[bi, :, hi] = online_softmax(scores, v[bi, :, hi], tile, mode == "split")
    want = bf16(exact)
    largest = want.abs().max().item()
    rec = {"shape": list(shape), "tile": tile, "max_abs_out": largest, "gate": GATE}
    for mode, out in got.items():
        rec[f"{mode}_err_of_max_out"] = (bf16(out) - want).abs().max().item() / largest
    return rec


def fp32_inputs(shape, seed: int) -> list[torch.Tensor]:
    """q, k, v as the cuda tests draw them, fp32."""
    rng = np.random.default_rng(seed)
    hd = shape[3]
    q = (rng.standard_normal(shape) * 2.0 * hd**-0.5).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v)]


def tf32_terms(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo) in float64 as the tensor cores read them: hi =
    rna(x), lo = the residue x - hi truncated to TF32."""
    hi, lo = tf32_split(x)
    lo_read = (lo.view(torch.int32) & -(1 << TF32_DROP_BITS)).view(torch.float32)
    return hi.double(), lo_read.double()


def split_product(a: tuple, b: tuple, n_terms: int) -> torch.Tensor:
    """sum of the first n_terms of hi.hi, hi.lo, lo.hi of a @ b, in float64."""
    pairs = ((a[0], b[0]), (a[0], b[1]), (a[1], b[0]))[:n_terms]
    return sum(x @ y for x, y in pairs)


def fp32_head_errors(q, k, v, tile: int) -> dict:
    """One head: fp32 (S, hd) q, k, v -> {(qk terms, pv terms): largest
    |replay - exact|} and the largest |exact| output."""
    exact = torch.softmax(q.double() @ k.double().T, -1) @ v.double()
    qt, kt, vt = tf32_terms(q), tf32_terms(k), tf32_terms(v)
    s = q.shape[0]
    errs = {}
    for qk in (1, 2, 3):
        scores = split_product(qt, (kt[0].T, kt[1].T), qk)
        outs = {pv: torch.zeros_like(exact) for pv in (1, 2, 3)}
        l_run = torch.zeros(s, 1, dtype=torch.float64)
        m_run = torch.full((s, 1), -torch.inf, dtype=torch.float64)
        for k0 in range(0, s, tile):
            block = scores[:, k0:k0 + tile]
            m_new = torch.maximum(m_run, block.max(-1, keepdim=True).values)
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(block - m_new).float()  # the kernel's fp32 P
            l_run = l_run * alpha + p.double().sum(-1, keepdim=True)
            pt = tf32_terms(p)
            v_tile = (vt[0][k0:k0 + tile], vt[1][k0:k0 + tile])
            for pv, out in outs.items():
                outs[pv] = out * alpha + split_product(pt, v_tile, pv)
            m_run = m_new
        for pv, out in outs.items():
            errs[(qk, pv)] = (out / l_run - exact).abs().max().item()
    return errs, exact.abs().max().item()


def fp32_shape_errors(shape, seed: int, tile: int | None = None) -> dict:
    """Every (Q.K^T terms, P.V terms) combination's largest error at one
    shape, as a share of the largest output, and the cheapest combination
    (fewest passes) under half the fp32 gate."""
    q, k, v = fp32_inputs(shape, seed)
    b, _, h, hd = shape
    tile = tile or (64 if hd == 64 else 32)
    worst, largest = {}, 0.0
    for bi in range(b):
        for hi in range(h):
            errs, top = fp32_head_errors(q[bi, :, hi], k[bi, :, hi], v[bi, :, hi], tile)
            largest = max(largest, top)
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    rec = {"shape": list(shape), "tile": tile, "max_abs_out": largest, "gate": FP32_GATE,
           "terms": list(FP32_TERMS)}
    for (qk, pv), e in sorted(worst.items()):
        rec[f"qk{qk}_pv{pv}_err_of_max_out"] = e / largest
    passing = [key for key in sorted(worst, key=sum) if worst[key] / largest < FP32_GATE / 2]
    rec["cheapest_under_half_gate"] = list(passing[0]) if passing else None
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated BxSxHxhd (default: the precision's own list)")
    ap.add_argument("--tile", type=int, default=None,
                    help="keys a tile (default: 128 for bf16, the fp32 kernel's own for fp32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    fp32 = args.precision == "fp32"
    shapes = args.shapes or ",".join(
        "x".join(map(str, s)) for s in (FP32_SHAPES if fp32 else DEFAULT_SHAPES))
    for text in shapes.split(","):
        shape = tuple(int(d) for d in text.split("x"))
        if fp32:
            rec = fp32_shape_errors(shape, args.seed, args.tile)
        else:
            rec = shape_errors(shape, args.seed, args.tile or 128)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
