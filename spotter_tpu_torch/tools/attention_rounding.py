"""What rounding P to bf16 costs `flash_attn_bf16`, simulated on the CPU.

The bf16 attention kernel feeds the softmax's probabilities P to the P.V
product on the tensor cores, which take bf16. This tool replays the
kernel's arithmetic in float64 on the inputs the `cuda` tests draw (numpy
seed, q scaled by 2 * hd**-0.5), with an online softmax over tiles of
`--tile` keys and the row sums of the unrounded P, two ways:

- `single`: P rounded to one bf16 term;
- `split`: P = P_hi + P_lo, both bf16 (P_lo the residue), the kernel's way;

rounds each output to bf16, and prints per shape the largest difference
from the exact softmax rounded to bf16, as a share of the largest output,
beside the tests' gate of 2**-8. A design check, not a device measurement.

    python -m spotter_tpu_torch.tools.attention_rounding
        [--shapes 1x1100x2x128,2x4301x12x64] [--tile 128] [--seed 0]
"""

import argparse
import json

import numpy as np
import torch

DEFAULT_SHAPES = ((1, 1100, 2, 128), (2, 1100, 3, 64), (1, 1025, 12, 64), (1, 1025, 2, 128),
                  (1, 4301, 12, 64), (1, 3601, 12, 64), (2, 4301, 12, 64), (2, 3601, 12, 64))
GATE = 2.0**-8


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in DEFAULT_SHAPES))
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for text in args.shapes.split(","):
        shape = tuple(int(d) for d in text.split("x"))
        print(json.dumps(shape_errors(shape, args.seed, args.tile)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
