"""What the tensor cores' rounding costs the class-logit kernel, simulated on
the CPU. A design check, not a device measurement.

`owl_class_logits` (`csrc/class_logits.cu`) takes the product img . bank on
the TF32 tensor cores, each fp32 operand split in two TF32 terms, x = hi +
lo (hi = x rounded to nearest, `cvt.rna.tf32.f32`; lo the residue, read by
the tensor cores as TF32: modelled as truncated). A bf16 img is exact in
TF32, so its lo is 0. `split_tf32_logits` replays the kernel's arithmetic:
the columns in its k-step order (a k-step is 8 columns of a slab, 32 fp32
or 64 bf16 columns wide); the bank's terms as the two halves of one B
operand, so each wgmma multiplies an A term by both and adds the exact sum
of its 8 products to each half's fp32 accumulator, rounded toward zero (the
tensor cores truncate as they accumulate; `truncate=False` rounds to
nearest instead); per k-step A's hi term, then its lo term; the halves
added at the end; then the fp32 norm, the product scaled by its
reciprocal, shift and elu-scale, and the mask as the kernel applies them. `a_terms` and `b_terms` (1 or 2)
keep hi only or hi and lo of each operand: the kernel takes (2, 2).

The tool prints per shape each (a_terms, b_terms) pair's largest
difference from the float64 plain version (`class_logits_reference` on
float64 inputs), as a share of the largest unmasked logit, beside the gate
of 1e-5 (chip_smoke's `CLASS_LOGITS_RTOL`), on inputs drawn as chip_smoke
draws them (numpy seed: img standard normal, the bank normalized standard
normal, shift and scale standard normal).

    python -m spotter_tpu_torch.tools.class_logits_rounding
        [--shapes 1x3600x512x22,2x576x512x160] [--seed 0]
"""

import argparse
import json

import numpy as np
import torch

from spotter_tpu_torch.ops.attention import TF32_DROP_BITS, tf32_split
from spotter_tpu_torch.ops.openvocab import NEG_INF, class_logits_reference

GATE = 1e-5  # of the largest unmasked logit
DEFAULT_SHAPES = ((1, 3600, 512, 22), (2, 576, 512, 160), (1, 576, 100, 24))
TERM_PAIRS = ((1, 1), (1, 2), (2, 1), (2, 2))  # (a_terms, b_terms); the kernel's is (2, 2)


def tf32_read(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo) in float64 as the tensor cores read them: hi =
    rna(x), lo the residue truncated to TF32."""
    hi, lo = tf32_split(x)
    lo_read = (lo.view(torch.int32) & -(1 << TF32_DROP_BITS)).view(torch.float32)
    return hi.double(), lo_read.double()


def kstep_columns(dt: int, slab_width: int) -> torch.Tensor:
    """The kernel's column order over Dt padded to slabs: k-step kk of slab s
    holds, at A-fragment columns c = 0 .. 7, slab column
    (slab_width / 4) (c % 4) + 2 kk + c / 4."""
    slabs = -(-dt // slab_width)
    per = slab_width // 4
    order = [s * slab_width + per * (c % 4) + 2 * kk + c // 4
             for s in range(slabs) for kk in range(slab_width // 8) for c in range(8)]
    return torch.tensor(order)


def round_toward_zero(acc: torch.Tensor) -> torch.Tensor:
    """float64 -> the fp32 value nearest it on the side of zero, in float64."""
    near = acc.float()
    over = near.double().abs() > acc.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near).double()


def split_tf32_logits(img: torch.Tensor, queries: torch.Tensor, shift: torch.Tensor,
                      scale: torch.Tensor, mask: torch.Tensor | None = None, a_terms: int = 2,
                      b_terms: int = 2, truncate: bool = True) -> torch.Tensor:
    """img (B, P, Dt) fp32 or bf16, queries (Q, Dt) fp32, shift and scale
    (B, P), mask (Q,) or None -> (B, P, Q) fp32 logits, the kernel's
    arithmetic replayed (see the module's docstring)."""
    b, p, dt = img.shape
    width = 64 if img.dtype == torch.bfloat16 else 32
    order = kstep_columns(dt, width)
    pad = order.numel() - dt
    x = torch.nn.functional.pad(img.reshape(b * p, dt).float(), (0, pad))[:, order]
    bank = torch.nn.functional.pad(queries.float(), (0, pad))[:, order]
    a = tf32_read(x)[:a_terms]
    bt = tf32_read(bank)[:b_terms]
    accs = [torch.zeros((b * p, queries.shape[0]), dtype=torch.float64) for _ in bt]
    for k0 in range(0, order.numel(), 8):
        for xa in a:  # one wgmma: this A term against both halves of B
            for h, xb in enumerate(bt):
                acc = accs[h] + xa[:, k0:k0 + 8] @ xb[:, k0:k0 + 8].T  # exact in float64
                accs[h] = round_toward_zero(acc) if truncate else acc.float().double()
    product = sum(acc.float() for acc in accs)
    xf = img.reshape(b * p, dt).float()
    n = torch.sqrt((xf * xf).sum(-1, keepdim=True)) + 1e-6
    sh = shift.reshape(b * p, 1).float()
    sc_raw = scale.reshape(b * p, 1).float()
    sc = torch.where(sc_raw > 0, sc_raw, torch.expm1(sc_raw)) + 1.0
    out = ((product * (1.0 / n) + sh) * sc).reshape(b, p, -1)
    if mask is None:
        return out
    return torch.where(mask[None, None, :] == 0, NEG_INF, out)


def logit_inputs(shape, seed: int, img_dtype=torch.float32) -> tuple:
    """img, bank, shift, scale drawn with numpy as chip_smoke draws them
    (its torch generator's draws differ; the distributions are the same)."""
    b, p, dt, q = shape
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.standard_normal((b, p, dt)).astype(np.float32)).to(img_dtype)
    bank = rng.standard_normal((q, dt)).astype(np.float32)
    bank = torch.from_numpy(bank / np.linalg.norm(bank, axis=-1, keepdims=True))
    shift = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
    return img, bank, shift, scale


def shape_errors(shape, seed: int, img_dtype=torch.float32) -> dict:
    """Each (a_terms, b_terms) pair's largest |replay - float64 plain| at
    one shape, as a share of the largest logit, with the accumulators
    truncated, and the kernel's pair's with them rounded to nearest."""
    img, bank, shift, scale = logit_inputs(shape, seed, img_dtype)
    exact = class_logits_reference(img.double(), bank.double(), shift.double(), scale.double())
    largest = exact.abs().max().item()
    rec = {"shape": list(shape), "img_dtype": str(img_dtype).removeprefix("torch."),
           "max_abs_logit": largest, "gate": GATE}
    for a_terms, b_terms in TERM_PAIRS:
        got = split_tf32_logits(img, bank, shift, scale, a_terms=a_terms, b_terms=b_terms)
        rec[f"a{a_terms}_b{b_terms}_err_of_max_logit"] = (
            (got.double() - exact).abs().max().item() / largest)
    got = split_tf32_logits(img, bank, shift, scale, truncate=False)
    rec["a2_b2_rounded_err_of_max_logit"] = (got.double() - exact).abs().max().item() / largest
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in DEFAULT_SHAPES),
                    help="comma-separated BxPxDtxQ")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for text in args.shapes.split(","):
        shape = tuple(int(d) for d in text.split("x"))
        for img_dtype in (torch.float32, torch.bfloat16):
            print(json.dumps(shape_errors(shape, args.seed, img_dtype)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
