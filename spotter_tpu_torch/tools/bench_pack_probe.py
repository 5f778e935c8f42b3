"""What the dense one-hot tile build costs on the card, per formulation
(counterpart of tools/bench_pack_probe.py).

The JAX package's merged one-hot MSDA kernel spends its time building
(Q_TILE, S_TILE) one-hot tiles: jc x (compare + select + add) per element.
The JAX probe isolates that loop on the TPU's vector unit; this one runs
the same eight variants as one hand-written CUDA kernel with eight
instantiations (`csrc/pack_tile.cu`, `pack_tile`), each held bit for bit
against its plain version (`pack_tile_reference`, the JAX kernel's
arithmetic in the same order), and timed:

  null            the empty body: the machinery alone;
  base            idx and w read inside every chain (the production idiom;
                  one volatile 8-byte read, so nvcc does not hoist it);
  hoist           idx and w read once, before the chains;
  arith           float(mask) * w instead of a select;
  i32/bf16        bf16 accumulators, each add rounded to bf16;
  i16/bf16        two columns a lane: packed 16-bit compares and bf16x2 adds,
                  the CUDA counterpart of the TPU's 2x-packed lanes.

Per variant: ms per call and Gel/s of chain elements (bh x 32 x 16 x 64 x
640 = 335.5 M at bh = 16), its bound (lane-instructions over the card's
issue rate, compares over its integer pipe) and the SASS of its kernel:
instructions in all and per chain element of a thread, selects (FSEL) and
shared-memory loads (LDS). The fp32 `base` and `hoist` compare into a
predicate and add under it (`NO_SELECT_VARIANTS`): a select (FSEL) only
where a chain starts, at most one a chain, where ptxas folds the add onto
the +0 `oh` starts from into a select of w or 0. Those two own four columns
of a tile row a thread (160 threads a block), the other six two (320): each
case records its `columns_per_thread` and `threads_per_block`, since a
comparison across the two layouts prices the layout with the formulation.
The `base` variants read idx and w from shared memory at every chain
element (`CHAIN_READ_VARIANTS`: one 8-byte LDS per k and j). No PyTorch call builds
the tile in this order, so there is no library column.

    python -m spotter_tpu_torch.tools.bench_pack_probe [--bh 16] [--iters 30]
        [--seed 0] [--device cpu] [--out build/bench_pack_probe.json]

Runs on cuda unless --device cpu is given (then only the plain versions
run, and every time is a host-clock CPU time).
"""

import argparse
import ctypes
import functools
import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from spotter_tpu_torch.tools.timing import (
    INT_LANE_INSTRUCTIONS_PER_S,
    LANE_INSTRUCTIONS_PER_S,
    PEAK_BYTES_PER_S,
    device_record,
    ms_key,
    resolve_device,
    time_ms,
)
from spotter_tpu_torch.utils.cuda_build import (
    KernelLibrary,
    disassemble,
    load_kernel_library,
    sass_functions,
)

REPO = Path(__file__).resolve().parents[2]
QT, TS, JC, REPS = 64, 640, 16, 32
# name -> (formulation, compare dtype, accumulator dtype), in the JAX tool's
# order, which is also the kernel's variant number
VARIANTS = {
    "null (machinery)": ("null", torch.int32, torch.float32),
    "base i32/f32": ("base", torch.int32, torch.float32),
    "hoist i32/f32": ("hoist", torch.int32, torch.float32),
    "arith i32/f32": ("arith", torch.int32, torch.float32),
    "hoist i32/bf16": ("hoist", torch.int32, torch.bfloat16),
    "hoist i16/bf16 (2x-packed)": ("hoist16", torch.int16, torch.bfloat16),
    "arith i16/bf16": ("arith", torch.int16, torch.bfloat16),
    "base i32/bf16": ("base", torch.int32, torch.bfloat16),
}
MAIN_VARIANT = "base i32/f32"  # the production kernel's idiom
# the variants whose chains must show no select (FSEL) past their first
# element: a compare into a predicate and an add predicated on it
NO_SELECT_VARIANTS = ("base i32/f32", "hoist i32/f32")
# columns of one tile row a thread owns: c, c + 160, c + 320, c + 480 in
# the fp32 base and hoist, c and c + 320 in the others
COLUMNS_PER_THREAD = {v: 4 if v in NO_SELECT_VARIANTS else 2 for v in VARIANTS}
# the variants that read idx[j] and w[j] from shared memory at each chain
# element, one 8-byte load for all of a thread's columns: at least REPS x JC
# LDS
CHAIN_READ_VARIANTS = ("base i32/f32", "base i32/bf16")
# the kernel instantiation of each variant: (formulation, accumulator kind)
# as pack_tile_kernel<V, ACC> is mangled: V 0 null 1 base 2 hoist 3 arith;
# ACC 0 fp32, 1 bf16 with int32 compares, 2 bf16 with packed int16 compares
INSTANTIATIONS = ((0, 0), (1, 0), (2, 0), (3, 0), (2, 1), (2, 2), (3, 2), (1, 1))


@functools.cache
def build_pack_tile_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library."""
    loaded = load_kernel_library("pack_tile", ("pack_tile.cu",))
    lib = loaded.lib
    lib.pack_tile_build.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.pack_tile_build.restype = ctypes.c_int
    lib.pack_tile_error_string.argtypes = [ctypes.c_int]
    lib.pack_tile_error_string.restype = ctypes.c_char_p
    return loaded


def pack_tile_reference(idx: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain version: idx (bh, 64, 16) int32, w (bh, 64, 16) fp32 ->
    (bh, 64, 640) fp32, the JAX kernel's arithmetic op for op: per k, `oh`
    sums the 16 chains from zero in the accumulator dtype, then `acc` adds
    `oh` (each bf16 add rounds to bf16)."""
    _check_inputs(idx, w, variant)
    form, cmp_dtype, acc_dtype = VARIANTS[variant]
    bh = idx.shape[0]
    col0 = torch.arange(TS, dtype=torch.int32, device=idx.device).to(cmp_dtype)
    col0 = col0.expand(bh, QT, TS)
    idx_c = idx.to(cmp_dtype)
    w_a = w.to(acc_dtype)
    zero = torch.zeros((), dtype=acc_dtype, device=idx.device)
    acc = torch.zeros((bh, QT, TS), dtype=acc_dtype, device=idx.device)
    for k in range(REPS):
        col = col0 + torch.tensor(k, dtype=cmp_dtype, device=idx.device)
        if form == "null":
            oh = col.to(acc_dtype)
        else:
            oh = torch.zeros((bh, QT, TS), dtype=acc_dtype, device=idx.device)
            for j in range(JC):
                mask = col == idx_c[:, :, j : j + 1]
                wj = w_a[:, :, j : j + 1]
                if form == "arith":
                    oh = oh + mask.to(acc_dtype) * wj
                else:
                    oh = oh + torch.where(mask, wj, zero)
        acc = acc + oh
    return acc.to(torch.float32)


def _check_inputs(idx: torch.Tensor, w: torch.Tensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"pack_tile: variant must be one of {list(VARIANTS)}, got {variant!r}")
    if idx.dim() != 3 or idx.shape[1:] != (QT, JC) or w.shape != idx.shape:
        raise ValueError(f"pack_tile: expected idx and w of shape (bh, {QT}, {JC}), got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"pack_tile: idx must be int32 and w float32, got {idx.dtype} and "
                        f"{w.dtype}")
    if idx.device != w.device:
        raise ValueError(f"pack_tile: idx is on {idx.device}, w on {w.device}")


def pack_tile(idx: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """idx (bh, 64, 16) int32 in [0, 640), w (bh, 64, 16) fp32 -> the
    (bh, 64, 640) fp32 one-hot tiles of `variant` (a key of VARIANTS).
    Replaces the Pallas kernel of `tools/bench_pack_probe.py:78`. On a CUDA
    tensor the kernel (contiguous inputs); on a CPU tensor the plain
    version; any other device raises."""
    if idx.device.type not in ("cuda", "cpu"):
        raise ValueError(f"pack_tile runs on cuda or cpu, not {idx.device}")
    _check_inputs(idx, w, variant)
    if idx.device.type == "cpu":
        return pack_tile_reference(idx, w, variant)
    bh = idx.shape[0]
    if not 1 <= bh <= 65535 or not (idx.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"pack_tile: needs contiguous inputs and 1 <= bh <= 65535, got bh {bh}")
    out = torch.empty((bh, QT, TS), dtype=torch.float32, device=idx.device)
    lib = build_pack_tile_kernel().lib
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        code = lib.pack_tile_build(idx.data_ptr(), w.data_ptr(), out.data_ptr(), bh,
                                   list(VARIANTS).index(variant), stream)
    if code != 0:
        raise RuntimeError(f"pack_tile launch failed: "
                           f"{lib.pack_tile_error_string(code).decode()} ({code})")
    pack_tile.launches += 1
    return out


pack_tile.launches = 0  # kernel launches since the count was last reset


def probe_inputs(bh: int, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """idx in [0, 640) and w in [0, 1), drawn with numpy as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, TS, (bh, QT, JC)).astype(np.int32))
    w = torch.from_numpy(rng.random((bh, QT, JC)).astype(np.float32))
    return idx.to(device), w.to(device)


def chain_elements(bh: int) -> int:
    """The JAX tool's `el`: compare-select-add chain elements a call."""
    return bh * REPS * JC * QT * TS


def bound(variant: str, bh: int) -> dict:
    """Least time: the fewest lane-instructions the function needs over the
    card's issue rate, against its compares over the 64-lane integer pipe
    and the tile's bytes. One column a lane, a chain element is a compare
    and an add predicated on it (`oh` starts at +0 and never becomes -0, so
    skipping the add of 0 gives the select's bits): 2 instructions, one of
    them a compare. Two columns a lane share a compare, a mask and an add:
    1.5, half a compare. The null body converts and adds per column and k."""
    form, cmp_dtype, _ = VARIANTS[variant]
    el = chain_elements(bh)
    if form == "null":
        instructions, compares = 2 * bh * REPS * QT * TS, 0
    elif cmp_dtype == torch.int16:
        instructions, compares = 3 * el // 2, el // 2
    else:
        instructions, compares = 2 * el, el
    nbytes = bh * QT * JC * 8 + bh * QT * TS * 4  # idx and w read once, the tiles written once
    ops_ms = max(instructions / LANE_INSTRUCTIONS_PER_S,
                 compares / INT_LANE_INSTRUCTIONS_PER_S) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"lane_instructions": instructions, "int_pipe_compares": compares, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sass_counts() -> dict:
    """Per variant: the SASS instructions of its kernel instantiation, in
    all and per chain element of a thread (its chains are unrolled, so the
    listing is what a thread issues: its columns x 32 k chains of 16), its
    chains, selects (FSEL) and shared-memory loads (LDS), and the opcodes
    that occur most."""
    functions = sass_functions(disassemble(build_pack_tile_kernel().path))
    counts = {}
    for variant, (v, acc) in zip(VARIANTS, INSTANTIATIONS):
        chains = COLUMNS_PER_THREAD[variant] * REPS
        pattern = re.compile(rf"pack_tile_kernel\w*?ILi{v}ELi{acc}E")
        body = next(lines for name, lines in functions.items() if pattern.search(name))
        ops = Counter(line.split()[1] if line.startswith("@") else line.split()[0]
                      for line in body)
        counts[variant] = {
            "instructions": len(body), "per_chain_element": len(body) / (chains * JC),
            "chains": chains,
            "fsel": sum(n for op, n in ops.items() if op.startswith("FSEL")),
            "lds": sum(n for op, n in ops.items() if op.startswith("LDS")),
            "top_opcodes": dict(ops.most_common(6)),
        }
    return counts


def run(args) -> dict:
    device = resolve_device(args.device)
    idx, w = probe_inputs(args.bh, args.seed, device)
    calls = {"pack_tile": 0}
    el = chain_elements(args.bh)
    record = {"tool": "bench_pack_probe", **device_record(device), "seed": args.seed,
              "bh": args.bh, "reps": REPS, "jc": JC, "tile": [QT, TS], "chain_elements": el,
              "cases": []}
    print(json.dumps({k: v for k, v in record.items() if k != "cases"}), flush=True)
    sass = sass_counts() if device.type == "cuda" else {}
    for variant in VARIANTS:
        def build(variant=variant):
            calls["pack_tile"] += 1
            return pack_tile(idx, w, variant)

        got = build()
        want = pack_tile_reference(idx, w, variant)
        rec = {"part": "tile", "kernel": "pack_tile", "variant": variant,
               "exact": bool(torch.equal(got, want)),
               "max_abs_err": (got - want).abs().max().item(),
               "main": variant == MAIN_VARIANT,
               "columns_per_thread": COLUMNS_PER_THREAD[variant],
               "threads_per_block": TS // COLUMNS_PER_THREAD[variant],
               **bound(variant, args.bh)}
        kernel_ms = time_ms(build, args.iters, device)
        rec[ms_key("kernel", device)] = kernel_ms
        rec[ms_key("plain", device)] = time_ms(
            lambda variant=variant: pack_tile_reference(idx, w, variant), 3, device)
        rec["gel_per_s" if device.type == "cuda" else "cpu_gel_per_s"] = el / (kernel_ms * 1e-3) / 1e9
        rec["library_ms"] = None  # no one PyTorch call builds the tile in this order
        if variant in sass:
            rec["sass"] = sass[variant]
        record["cases"].append(rec)
        print(json.dumps(rec), flush=True)
    record["calls"] = calls
    return record


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bh", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(REPO / "build" / "bench_pack_probe.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    record = run(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
