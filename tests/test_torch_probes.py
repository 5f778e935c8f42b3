"""The port's three measurement probes against the JAX tools' Pallas kernels.

Each probe's plain version (what its wrapper computes on a CPU tensor, and
what chip_smoke.py holds its CUDA kernel against on the card) is held
against the JAX tool's kernel run in Pallas interpret mode on the CPU, on
the same numpy-seeded inputs, exactly:

- row 9, `bench_int8.int8_gemm`: `pallas_int8`'s kernel is a closure, so
  its body and BlockSpecs are rebuilt here at n = 256 in blocks of
  64 x 256 x 64; int32, exact, also against `lax.dot_general`;
- row 10, `bench_pack_probe.pack_tile`: the tool's `_kernel` with `run`'s
  BlockSpecs and VMEM spaces at bh = 2, all eight variants. fp32, exact. The
  bf16 variants are exact only without XLA's excess precision (its CPU
  backend otherwise keeps adds in fp32 between ops, 1 bf16 ulp apart in
  ~1 % of the elements): they run in a subprocess started with
  XLA_FLAGS=--xla_allow_excess_precision=false, which must be set before
  JAX starts and must not reach other tests;
- row 11, `profile_r101.launch_probe`: the trivial kernel, exact.

Then each wrapper's device and input checks, and each tool's `main` on the
CPU at tiny sizes: well-formed JSON lines and the record file.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spotter_tpu_torch.tools import bench_int8, bench_pack_probe, profile_r101, timing
from tools import bench_pack_probe as jpack

REPO = Path(__file__).resolve().parents[1]
PACK_BH = 2
PACK_SEED = 3
FP32_VARIANTS = [v for v, (_, _, acc) in bench_pack_probe.VARIANTS.items() if acc == torch.float32]
BF16_VARIANTS = [v for v, (_, _, acc) in bench_pack_probe.VARIANTS.items() if acc == torch.bfloat16]
JAX_DTYPES = {torch.int32: "int32", torch.int16: "int16", torch.float32: "float32",
              torch.bfloat16: "bfloat16"}


# --- row 10: the one-hot tile build ------------------------------------------


def pack_inputs():
    rng = np.random.default_rng(PACK_SEED)
    idx = rng.integers(0, jpack.TS, (PACK_BH, jpack.QT, jpack.JC)).astype(np.int32)
    w = rng.random((PACK_BH, jpack.QT, jpack.JC)).astype(np.float32)
    return idx, w


def jax_pack_tile(idx, w, form, cmp_dtype, acc_dtype):
    """The JAX tool's kernel with `run`'s BlockSpecs, in interpret mode."""
    kernel = partial(jpack._kernel, variant=form, cmp_dtype=cmp_dtype, acc_dtype=acc_dtype)
    bh = idx.shape[0]
    spec_in = pl.BlockSpec((1, jpack.QT, jpack.JC), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((bh, jpack.QT, jpack.TS), jnp.float32),
        grid=(bh,),
        in_specs=[spec_in, spec_in],
        out_specs=pl.BlockSpec((1, jpack.QT, jpack.TS), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(w))
    return np.asarray(out)


# run in a fresh interpreter with XLA's excess precision off: each bf16 add
# of the JAX kernel then rounds to bf16, as the port's versions do
BF16_SCRIPT = """
import sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, {repo!r})
from tests.test_torch_probes import jax_pack_tile, pack_inputs
idx, w = pack_inputs()
outs = {{}}
for name, form, cmp_dtype, acc_dtype in {variants!r}:
    outs[name] = jax_pack_tile(idx, w, form, getattr(jnp, cmp_dtype), getattr(jnp, acc_dtype))
np.savez({out!r}, **outs)
"""


@pytest.fixture(scope="module")
def jax_bf16_tiles(tmp_path_factory):
    out = tmp_path_factory.mktemp("pack") / "bf16.npz"
    variants = [(f"v{i}", form, JAX_DTYPES[cmp], JAX_DTYPES[acc])
                for i, (form, cmp, acc) in enumerate(
                    bench_pack_probe.VARIANTS[v] for v in BF16_VARIANTS)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                         + " --xla_allow_excess_precision=false").strip()}
    script = BF16_SCRIPT.format(repo=str(REPO), variants=variants, out=str(out))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tiles = np.load(out)
    return {v: tiles[f"v{i}"] for i, v in enumerate(BF16_VARIANTS)}


@pytest.mark.parametrize("variant", FP32_VARIANTS)
def test_pack_tile_fp32_variants_equal_the_jax_kernel(variant):
    idx, w = pack_inputs()
    form, cmp_dtype, acc_dtype = bench_pack_probe.VARIANTS[variant]
    want = jax_pack_tile(idx, w, form, getattr(jnp, JAX_DTYPES[cmp_dtype]),
                         getattr(jnp, JAX_DTYPES[acc_dtype]))
    got = bench_pack_probe.pack_tile(torch.from_numpy(idx), torch.from_numpy(w), variant)
    assert got.dtype == torch.float32 and got.shape == (PACK_BH, 64, 640)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_pack_tile_bf16_variants_equal_the_jax_kernel(variant, jax_bf16_tiles):
    idx, w = pack_inputs()
    got = bench_pack_probe.pack_tile(torch.from_numpy(idx), torch.from_numpy(w), variant)
    np.testing.assert_array_equal(got.numpy(), jax_bf16_tiles[variant])


def test_pack_tile_formulations_agree_within_their_accumulator():
    """base, hoist and arith are one function per accumulator dtype; the
    bf16 tiles round where the fp32 ones do not."""
    idx, w = (torch.from_numpy(a) for a in pack_inputs())
    tiles = {v: bench_pack_probe.pack_tile(idx, w, v) for v in bench_pack_probe.VARIANTS}
    for group in (FP32_VARIANTS[1:], BF16_VARIANTS):
        for v in group[1:]:
            assert torch.equal(tiles[v], tiles[group[0]]), (v, group[0])
    assert not torch.equal(tiles["base i32/f32"], tiles["base i32/bf16"])


# --- row 9: the int8 GEMM ---------------------------------------------------


def jax_pallas_int8(a, b, bm=64, bk=256, bn=64):
    """`pallas_int8`'s kernel body and BlockSpecs, in interpret mode."""

    def kernel(a_ref, b_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            a_ref[...], b_ref[...], (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)

    n = a.shape[0]
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(n // bm, n // bn),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j: (i, 0)),
                  pl.BlockSpec((bk, bn), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.int32),
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))


def test_int8_gemm_equals_the_jax_kernel_and_dot_general():
    a, b = bench_int8.operands(256, seed=5, device=torch.device("cpu"))
    want = jax_pallas_int8(a.numpy(), b.numpy())
    dot = np.asarray(jax.lax.dot_general(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                         (((1,), (0,)), ((), ())),
                                         preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(want, dot)
    got = bench_int8.int8_gemm(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bench_int8.int8_gemm_reference(a, b).numpy(), want)


def test_int8_gemm_reference_does_not_wrap():
    """torch.matmul on int8 returns int8 and wraps; the plain version sums
    in int64 and returns the exact int32."""
    a = torch.full((16, 64), 127, dtype=torch.int8)
    b = torch.full((64, 16), -128, dtype=torch.int8)
    got = bench_int8.int8_gemm_reference(a, b)
    assert got.dtype == torch.int32 and (got == 64 * 127 * -128).all()


# --- row 11: the launch probe -----------------------------------------------


def test_launch_probe_equals_the_jax_kernel():
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True,
    )(jnp.asarray(x)))
    got = profile_r101.launch_probe(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the wrappers' checks ---------------------------------------------------


WRAPPERS = {
    "int8_gemm": (bench_int8, "build_int8_gemm_kernel"),
    "pack_tile": (bench_pack_probe, "build_pack_tile_kernel"),
    "launch_probe": (profile_r101, "build_launch_probe_kernel"),
}


def _calls(device="cpu"):
    a = torch.ones((32, 32), dtype=torch.int8, device=device)
    idx = torch.zeros((1, 64, 16), dtype=torch.int32, device=device)
    w = torch.ones((1, 64, 16), dtype=torch.float32, device=device)
    x = torch.ones((8, 128), dtype=torch.float32, device=device)
    return {
        "int8_gemm": lambda: bench_int8.int8_gemm(a, a),
        "pack_tile": lambda: bench_pack_probe.pack_tile(idx, w, "base i32/f32"),
        "launch_probe": lambda: profile_r101.launch_probe(x),
    }


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch, name):
    """A CPU tensor computes the plain version and neither builds nor
    launches a kernel; a tensor on any other device raises."""
    module, builder = WRAPPERS[name]
    builds = []
    monkeypatch.setattr(module, builder, lambda: builds.append(1))
    wrapper = getattr(module, name)
    before = wrapper.launches
    out = _calls()[name]()
    assert out.device.type == "cpu"
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        _calls("meta")[name]()
    assert builds == [] and wrapper.launches == before


def test_wrappers_raise_on_wrong_dtype_or_shape():
    i8 = torch.ones((32, 32), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        bench_int8.int8_gemm(i8.to(torch.int32), i8)
    with pytest.raises(ValueError, match="expected a"):
        bench_int8.int8_gemm(i8, torch.ones((16, 32), dtype=torch.int8))
    with pytest.raises(ValueError, match="a is on"):
        bench_int8.int8_gemm(i8, i8.to("meta"))
    idx = torch.zeros((1, 64, 16), dtype=torch.int32)
    w = torch.ones((1, 64, 16))
    with pytest.raises(TypeError, match="int32"):
        bench_pack_probe.pack_tile(idx.to(torch.int64), w, "base i32/f32")
    with pytest.raises(ValueError, match="shape"):
        bench_pack_probe.pack_tile(idx[:, :32], w[:, :32], "base i32/f32")
    with pytest.raises(ValueError, match="variant"):
        bench_pack_probe.pack_tile(idx, w, "base i8/f8")
    with pytest.raises(TypeError, match="float32"):
        profile_r101.launch_probe(torch.ones((8, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="empty"):
        profile_r101.launch_probe(torch.ones((0, 128)))


# --- the tools' entry points --------------------------------------------------


def _json_lines(text: str) -> list:
    recs = [json.loads(line) for line in text.splitlines() if line.strip()]
    assert recs and all(isinstance(r, dict) for r in recs)
    return recs


def test_bench_int8_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "bench_int8.json"
    assert bench_int8.main(["--device", "cpu", "--sizes", "32,64", "--edge-size", "48",
                            "--iters", "2", "--out", str(out)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    gemms = [r for r in lines if r["part"] == "gemm"]
    assert [r["n"] for r in gemms] == [32, 64, 48]
    assert all(r["exact"] and r["library_exact"] and r["max_abs_err"] == 0 for r in gemms)
    assert "kernel_cpu_ms" in gemms[0] and "kernel_ms" not in gemms[0]
    assert gemms[0]["library_cpu_ms"] == min(gemms[0]["library_b_row_major_cpu_ms"],
                                             gemms[0]["library_b_col_major_cpu_ms"])
    record = json.loads(out.read_text())
    assert record["device"] == "cpu" and record["cases"] == lines
    # one call to check and 1 + 2 to time at each timed size, one at the edge size
    assert record["calls"] == {"int8_gemm": 2 * 4 + 1}


def test_pack_probe_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "pack.json"
    assert bench_pack_probe.main(["--device", "cpu", "--bh", "1", "--iters", "1",
                                  "--out", str(out)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    tiles = [r for r in lines if r.get("part") == "tile"]
    assert [r["variant"] for r in tiles] == list(bench_pack_probe.VARIANTS)
    assert all(r["exact"] and r["library_ms"] is None for r in tiles)
    assert sum(r["main"] for r in tiles) == 1
    record = json.loads(out.read_text())
    assert record["chain_elements"] == 32 * 16 * 64 * 640
    assert record["calls"] == {"pack_tile": 8 * (1 + 1 + 1)}


def test_pack_probe_bound_is_two_instructions_an_element():
    """One column a lane: a compare and an add predicated on it a chain
    element, the compares also held to the 64-lane integer pipe; two
    columns a lane: 1.5 instructions and half a compare an element."""
    el = bench_pack_probe.chain_elements(16)
    base = bench_pack_probe.bound("base i32/f32", 16)
    packed = bench_pack_probe.bound("hoist i16/bf16 (2x-packed)", 16)
    assert base["lane_instructions"] == 2 * el and base["int_pipe_compares"] == el
    assert packed["lane_instructions"] == 3 * el // 2 and packed["int_pipe_compares"] == el // 2
    assert base["bound_by"] == packed["bound_by"] == "operations"
    assert base["bound_ms"] == pytest.approx(el / (132 * 64 * 1.98e9) * 1e3)
    assert packed["bound_ms"] == pytest.approx(1.5 * el / (132 * 128 * 1.98e9) * 1e3)


def test_profile_r101_main_on_the_cpu_with_the_tiny_model(tmp_path, capsys):
    out = tmp_path / "profile.json"
    assert profile_r101.main(["--device", "cpu", "--tiny", "--batch", "2", "--iters", "1",
                              "--layers-set", "1,2", "--out", str(out)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [r["part"] for r in lines] == ["layers", "layers", "layers_fit", "backbone", "topk",
                                          "msda", "launch"]
    launch = lines[-1]
    assert launch["exact"] and launch["graph"] == "not measured on the CPU"
    times = [k for r in lines for k in r if k.endswith("_ms") and k != "bound_ms"]
    assert times and all(k.endswith("_cpu_ms") for k in times), times
    record = json.loads(out.read_text())
    assert record["calls"]["launch_probe"] > 0 and record["tiny"] is True
    assert record["calls"]["launch_probe_graph"] == 0  # no CUDA graphs on the CPU


def test_profile_r101_takes_only_float32_and_the_default_parts():
    with pytest.raises(SystemExit, match="float32 only"):
        profile_r101.main(["--device", "cpu", "--tiny", "--dtype", "bfloat16"])
    with pytest.raises(SystemExit):
        profile_r101.parse_args(["--parts", "layers,stem2"])


def test_tools_run_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        timing.resolve_device(None)
    for tool in (bench_int8, bench_pack_probe, profile_r101):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(["--out", os.devnull])
    assert timing.resolve_device("cpu").type == "cpu"
    assert timing.ms_key("kernel", torch.device("cpu")) == "kernel_cpu_ms"
