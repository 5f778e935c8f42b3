"""The int8 tensor-core probe on the card (counterpart of tools/bench_int8.py).

The JAX tool asks whether an int8 x int8 -> int32 matmul reaches the TPU's
int8 MXU, three ways: timings of XLA's bf16 and int8 dots, the optimized
HLO grepped for an s8 dot, and a tiled Pallas int8 matmul. Here the same
three, for Hopper:

1. `floor`: the launch floor, one empty kernel launch (device time by CUDA
   events, and the host's cost per eager launch);
2. per size n (4096 and 8192 by default; n = 4000, a size that is not a
   multiple of the 128 x 256 tile, is checked too): the hand-written kernel
   `int8_gemm` (`csrc/int8_gemm.cu`, bound in `ops/int8.py`, where the
   served int8 path runs its K-major entry: a transpose pass that writes B K-major,
   then wgmma m64n256k32 s32.s8.s8 fed by TMA; the port of `pallas_int8`)
   against its plain version, exactly, its transpose pass against
   `b.t().contiguous()`, exactly, and its time in TOP/s (the transpose
   included) beside `torch._int_mm` (cuBLASLt's int8 GEMM, timed with B as
   given and column-major; the faster is the library column) and a bf16
   `torch.mm` with fp32 out (yardsticks only: the port never calls them);
3. `sass`: the built GEMM kernel's SASS grepped for the tensor-core int8
   ops, the counterpart of the HLO grep: the wgmma path is `IGMMA`, and
   `IMMA` (mma.sync) must not appear.

The plain version is not `torch.matmul` on int8, which returns int8 and
wraps on the CPU, and which cuBLAS does not take on the card: it is an
int64 product on the CPU and a float64 one on the card, both exact, since
|sum| <= K * 128**2 stays far below 2**53.

    python -m spotter_tpu_torch.tools.bench_int8 [--sizes 4096,8192]
        [--edge-size 4000] [--iters 20] [--seed 0] [--device cpu]
        [--out build/bench_int8.json]

Runs on cuda unless --device cpu is given (then only the plain versions
run, at whatever sizes are asked, and every time is a host-clock CPU
time). Prints one JSON line per measurement and writes the record.
"""

import argparse
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from spotter_tpu_torch.ops.int8 import (  # noqa: F401  (the tool's kernel, bound in ops/)
    MAX_K,
    TILE_MULTIPLE,
    _check_kernel_operands,
    build_int8_conv_kernel,
    build_int8_gemm_kernel,
    empty_launch,
    int8_gemm,
    int8_gemm_reference,
    transpose_s8,
    transpose_s8_reference,
)
from spotter_tpu_torch.tools.timing import (
    PEAK_BYTES_PER_S,
    PEAK_INT8_OPS,
    device_record,
    l2_flush_buffer,
    ms_key,
    resolve_device,
    time_ms,
)
from spotter_tpu_torch.utils.cuda_build import disassemble, sass_functions

REPO = Path(__file__).resolve().parents[2]
DEFAULT_SIZES = (4096, 8192)
EDGE_SIZE = 4000
SASS_WGMMA_VERDICT = "int8 wgmma path EMITTED (IGMMA, no IMMA)"


def operands(n: int, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, n) int8 operands in [-127, 127), drawn with numpy as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 127, (n, n), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 127, (n, n), dtype=np.int8))
    return a.to(device), b.to(device)


def floor_calibration(device: torch.device, iters: int) -> dict:
    """The launch floor: an empty kernel's device time, and the host's cost
    per eager launch over a run of back-to-back launches."""
    if device.type != "cuda":
        return {"part": "floor", "empty_launch": "not measured on the CPU"}
    device_ms = time_ms(empty_launch, iters, device)
    runs = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        empty_launch()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / runs * 1e6
    return {"part": "floor", "empty_kernel_ms": device_ms, "host_us_per_eager_launch": host_us}


def bf16_mm_fp32_out(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 with fp32 out, the JAX tool's bf16 yardstick
    (preferred_element_type=float32); the CPU has no such kernel, so there
    the operands are widened first."""
    if a16.device.type == "cuda":
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return torch.mm(a16.float(), b16.float())


def size_case(n: int, seed: int, iters: int, device: torch.device, flush, calls: dict,
              timed: bool = True) -> dict:
    """The kernel at n against its plain version, and its transpose pass
    against `b.t().contiguous()`, exactly; then the times of the kernel, the
    transpose alone, the plain version, torch._int_mm and the bf16
    yardstick."""
    a, b = operands(n, seed, device)

    def gemm():
        calls["int8_gemm"] += 1
        return int8_gemm(a, b)

    got = gemm()
    want = int8_gemm_reference(a, b)
    # cuBLASLt's int8 kernels want B K-major ("TN"): the library column is
    # the faster of B as the tool holds it and B column-major
    b_cm = b.t().contiguous().t()
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    rec = {
        "part": "gemm", "kernel": "int8_gemm", "n": n, "exact": bool(torch.equal(got, want)),
        "max_abs_err": err,
        "transpose_exact": bool(torch.equal(transpose_s8(b), transpose_s8_reference(b))),
        "library_exact": all(bool(torch.equal(torch._int_mm(a, bb), want)) for bb in (b, b_cm)),
    }
    del want
    ops = 2 * n**3
    nbytes = 2 * n * n + 4 * n * n  # both int8 operands read once, the int32 result written once
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    rec.update({"ops": ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    if not timed:
        return rec
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    times = {
        "kernel": time_ms(gemm, iters, device, flush),
        "plain": time_ms(lambda: int8_gemm_reference(a, b), max(2, iters // 5), device, flush),
        "library_b_row_major": time_ms(lambda: torch._int_mm(a, b), iters, device, flush),
        "library_b_col_major": time_ms(lambda: torch._int_mm(a, b_cm), iters, device, flush),
        "bf16_fp32_out": time_ms(lambda: bf16_mm_fp32_out(a16, b16), iters, device, flush),
    }
    times["library"] = min(times["library_b_row_major"], times["library_b_col_major"])
    for name, ms in times.items():
        rec[ms_key(name, device)] = ms
        rec[f"{name}_{'tops' if device.type == 'cuda' else 'cpu_tops'}"] = ops / ms / 1e9
    # the transpose pass alone, a part of the kernel's time
    rec[ms_key("transpose", device)] = time_ms(lambda: transpose_s8(b), iters, device, flush)
    return rec


# the wgmma int8 kernels whose SASS `sass_evidence` reads: (library build,
# the kernel's name in the listing); every instantiation of it is read
SASS_KERNELS = {"int8_gemm": (build_int8_gemm_kernel, "int8_gemm_kernel"),
                "conv_s8": (build_int8_conv_kernel, "conv_s8_kernel")}


def sass_evidence(device: torch.device, kernel: str = "int8_gemm") -> dict:
    """The built kernel's SASS (int8_gemm's GEMM, or every instantiation of
    conv_s8), grepped for the int8 tensor-core ops: the wgmma path is IGMMA;
    IMMA (mma.sync) or a float MMA (HMMA, HGMMA) would mean the kernel is
    not the wgmma int8 path."""
    if device.type != "cuda":
        return {"part": "sass", "verdict": "not available on the CPU (no CUDA toolkit)"}
    build, fragment = SASS_KERNELS[kernel]
    functions = sass_functions(disassemble(build().path))
    bodies = [body for name, body in functions.items() if fragment in name]
    code = [line for body in bodies for line in body]
    opcodes = [line.split()[1] if line.startswith("@") else line.split()[0] for line in code]
    igmma = [op for op in opcodes if op.startswith("IGMMA")]
    imma = [op for op in opcodes if op.startswith("IMMA")]
    float_mma = [op for op in opcodes if re.match(r"H(G)?MMA", op)]
    each_igmma = all(any("IGMMA" in line for line in body) for body in bodies)
    return {
        "part": "sass", "sass_of": kernel, "functions": len(bodies),
        "instructions": len(opcodes), "igmma_ops": len(igmma),
        "imma_ops": len(imma), "int8_mma_kinds": sorted(set(igmma + imma)),
        "float_mma_ops": len(float_mma),
        "examples": [line for line in code if "MMA" in line][:4],
        "verdict": (SASS_WGMMA_VERDICT if bodies and each_igmma and not imma and not float_mma
                    else "int8 wgmma path NOT in the SASS"),
    }


def run(args) -> dict:
    device = resolve_device(args.device)
    flush = l2_flush_buffer(device) if device.type == "cuda" else None
    calls = {"int8_gemm": 0}
    record = {"tool": "bench_int8", **device_record(device), "seed": args.seed, "cases": []}

    def emit(rec):
        record["cases"].append(rec)
        print(json.dumps(rec), flush=True)

    emit(floor_calibration(device, args.iters))
    for n in args.sizes:
        emit(size_case(n, args.seed, args.iters, device, flush, calls))
    if args.edge_size:
        emit(size_case(args.edge_size, args.seed, args.iters, device, flush, calls, timed=False))
    emit(sass_evidence(device))
    record["calls"] = calls
    return record


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, DEFAULT_SIZES)),
                    type=lambda s: [int(v) for v in s.split(",") if v])
    ap.add_argument("--edge-size", type=int, default=EDGE_SIZE,
                    help="an n that is not a multiple of the kernel's tile (0: skip)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(REPO / "build" / "bench_int8.json"))
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
