"""Long self-attention: spotter_tpu_torch.ops.attention and the cutover in
spotter_tpu_torch.models.layers against spotter_tpu.models.layers.

- `self_attention_reference` (the plain version of the CUDA kernel) against
  the JAX package's plain einsum path, and against its splash kernel run in
  interpret mode at (1, 1100, 2, 128), as tests/test_flash_attention.py runs
  it. fp32 on both sides: atol 1e-5 against the einsum path (the same three
  products summed in another order: scores reach ~10, where an ulp is 1e-6,
  and an ulp of a score moves its weight by that much relative), and the
  einsum path's own 2e-3 against splash (splash's online softmax on the CPU);
- the wrappers on CPU tensors (the plain version, no launch counted), and
  the checks that stand before a kernel launch;
- the cutover: unmasked self-attention of FLASH_ATTN_MIN_SEQ tokens or more
  on a CUDA tensor takes `flash_self_attention` with q pre-scaled, shorter
  sequences, masked, cross and CPU attention never do, and
  SPOTTER_TPU_FLASH_ATTN=0 turns it off; bf16 tensors take the bf16
  instantiation, fp32 the fp32 one;
- the GELU and FLASH_IMPL knobs: their values, and the JAX package's error
  texts for a bad one; the GELU policy's two forms against JAX's.

The kernel itself runs only on the card: the `cuda`-marked test here, and
chip_smoke.py's kernel phase.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import layers as jl
from spotter_tpu_torch.models import layers as tl
from spotter_tpu_torch.models import yolos as tyolos
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.ops import attention as tattn

ROOT = str(pathlib.Path(__file__).resolve().parents[1])


def _qkv(b, s, h, hd, seed=0, logit_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * logit_scale * hd**-0.5).astype(np.float32)
    k = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v


def _jax_plain(q, k, v):
    """The JAX package's plain path on pre-scaled q (layers.py:594-601)."""
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k)
    weights = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", weights, v)


@pytest.mark.parametrize("shape", [(2, 70, 3, 64), (1, 129, 2, 128)])
def test_reference_matches_jax_einsum_path(shape):
    q, k, v = _qkv(*shape, logit_scale=3.0)
    want = np.asarray(_jax_plain(q, k, v))
    got = tattn.self_attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_bf16_matches_jax_einsum_path():
    """bf16 in, bf16 out on both sides; compared in fp32 within 2 bf16 ulps
    of |out| <= 1 (2**-7): the two round the scores and weights at the same
    places but sum in another order."""
    q, k, v = _qkv(2, 70, 3, 64, seed=1, logit_scale=3.0)
    want = np.asarray(_jax_plain(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    got = tattn.self_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2**-7)


def test_reference_matches_jax_splash_kernel_in_interpret_mode():
    q, k, v = _qkv(1, 1100, 2, 128, seed=2)
    want = np.asarray(jl._splash_self_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = tattn.self_attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_the_plain_version_on_the_cpu(dtype):
    wrapper = tattn.flash_attn_fp32 if dtype == torch.float32 else tattn.flash_attn_bf16
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 40, 2, 64))
    before = wrapper.launches
    got = wrapper(q, k, v)
    assert torch.equal(got, tattn.self_attention_reference(q, k, v))
    assert wrapper.launches == before, "a CPU call counted a kernel launch"
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError):
        wrapper(q.to(other), k, v)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        wrapper(*(t.to("meta") for t in (q, k, v)))


def test_kernel_input_checks():
    ok = [torch.zeros(1, 8, 2, 64) for _ in range(3)]
    tattn._check_inputs("t", torch.float32, *ok)
    with pytest.raises(ValueError, match="hd in"):
        tattn._check_inputs("t", torch.float32, *[torch.zeros(1, 8, 2, 32)] * 3)
    with pytest.raises(ValueError, match="one .B, S, H, hd. shape"):
        tattn._check_inputs("t", torch.float32, ok[0], ok[1], torch.zeros(1, 9, 2, 64))
    with pytest.raises(TypeError):
        tattn._check_inputs("t", torch.float32, ok[0], ok[1], ok[2].to(torch.bfloat16))
    strided = torch.zeros(1, 8, 2, 128)[..., ::2]  # hd stride 2
    with pytest.raises(ValueError, match="unit stride"):
        tattn._check_inputs("t", torch.float32, strided, ok[1], ok[2])
    # (B, S, H, hd) views of a (B, S, 3, H, hd) qkv projection pass
    qkv = torch.zeros(1, 8, 3, 2, 64)
    tattn._check_inputs("t", torch.float32, qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    # bf16 goes through TMA tensor maps: strides over (B, S, H) in multiples of
    # 8 elements (16 bytes) and 16-byte aligned starts
    bf = [t.to(torch.bfloat16) for t in ok]
    tattn._check_inputs("t", torch.bfloat16, *bf)
    qkv16 = qkv.to(torch.bfloat16)
    tattn._check_inputs("t", torch.bfloat16, qkv16[:, :, 0], qkv16[:, :, 1], qkv16[:, :, 2])
    padded = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64]  # h stride 68
    with pytest.raises(ValueError, match="multiples of 8"):
        tattn._check_inputs("t", torch.bfloat16, padded, bf[1], bf[2])
    shifted = torch.zeros(8 * 2 * 64 + 4, dtype=torch.bfloat16)[4:].view(1, 8, 2, 64)  # 8 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._check_inputs("t", torch.bfloat16, bf[0], shifted, bf[2])


class _Recorder:
    """Stands in for `flash_self_attention`: records its inputs and returns
    the plain version's output."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v):
        self.calls.append((q.clone(), k.clone(), v.clone()))
        return tattn.self_attention_reference(q, k, v)


@pytest.fixture
def on_cuda(monkeypatch):
    """Route the cutover as it would go on a CUDA tensor (FLASH_ATTN on)."""
    rec = _Recorder()
    monkeypatch.setattr(tl, "flash_attention_enabled", lambda x: tl.FLASH_ATTN_ENABLED)
    monkeypatch.setattr(tyolos, "flash_attention_enabled", lambda x: tl.FLASH_ATTN_ENABLED)
    monkeypatch.setattr(tl, "flash_self_attention", rec)
    monkeypatch.setattr(tyolos, "flash_self_attention", rec)
    return rec


def _yolos_attention(width=128, heads=2):
    cfg = dataclasses.replace(tzoo.tiny_yolos_config(), hidden_size=width, num_attention_heads=heads)
    model = tyolos.YolosAttention(cfg).eval()
    tzoo._init_flax_layers(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("s,taken", [(1023, False), (1024, True), (1100, True)])
def test_yolos_attention_cutover(on_cuda, monkeypatch, s, taken):
    model = _yolos_attention()
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((1, s, 128)).astype(np.float32))
    with torch.inference_mode():
        got = model(x)
    assert len(on_cuda.calls) == int(taken)
    if taken:
        q, k, _ = on_cuda.calls[0]
        with torch.inference_mode():
            raw_q = model.query(x).view(1, s, 2, 64)
        torch.testing.assert_close(q, raw_q * 64**-0.5, rtol=0, atol=0)  # pre-scaled
        assert q.shape == k.shape == (1, s, 2, 64)
        monkeypatch.setattr(tl, "FLASH_ATTN_ENABLED", False)
        with torch.inference_mode():
            plain = model(x)
        assert len(on_cuda.calls) == 1, "SPOTTER_TPU_FLASH_ATTN=0 still took the kernel"
        # same function: scale before q.k (kernel) vs after (plain path)
        torch.testing.assert_close(got, plain, atol=2e-6, rtol=1e-5)


def test_multi_head_attention_cutover(on_cuda):
    rng = np.random.default_rng(3)
    mha = tl.MultiHeadAttention(128, 2).eval()
    long_x = torch.from_numpy(rng.standard_normal((1, 1024, 128)).astype(np.float32))
    short_x = long_x[:, :1000]
    mask = torch.zeros(1, 1, 1024, 1024)
    with torch.inference_mode():
        mha(short_x)
        mha(long_x, attention_mask=mask)
        mha(long_x, key_value_states=long_x)
        assert on_cuda.calls == []
        mha(long_x, position_embeddings=long_x)
    assert len(on_cuda.calls) == 1


def test_cpu_tensors_never_take_the_kernel(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tl, "flash_self_attention", rec)
    monkeypatch.setattr(tyolos, "flash_self_attention", rec)
    with torch.inference_mode():
        _yolos_attention()(torch.zeros(1, 1100, 128))
        tl.MultiHeadAttention(128, 2)(torch.zeros(1, 1100, 128))
    assert rec.calls == []
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"))
    assert tl.flash_attention_enabled(cuda_like) is tl.FLASH_ATTN_ENABLED
    assert not tl.flash_attention_enabled(torch.zeros(1))
    monkeypatch.setattr(tl, "FLASH_ATTN_ENABLED", False)
    assert not tl.flash_attention_enabled(cuda_like)


@pytest.mark.parametrize("impl", ["auto", "flash", "splash"])
def test_flash_self_attention_dispatches_by_dtype(monkeypatch, impl):
    monkeypatch.setattr(tl, "FLASH_IMPL", impl)
    seen = []
    monkeypatch.setattr(tl, "flash_attn_fp32", lambda *a: seen.append("fp32"))
    monkeypatch.setattr(tl, "flash_attn_bf16", lambda *a: seen.append("bf16"))
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.zeros(1, 4, 1, 64, dtype=dtype)
        tl.flash_self_attention(t, t, t)
    assert seen == ["fp32", "bf16"]


def _jax_error(env: str, value: str) -> str:
    """The ValueError text spotter_tpu.models.layers raises at import for a
    bad knob value."""
    code = (
        "try:\n    import spotter_tpu.models.layers\nexcept ValueError as e:\n    print(e)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, env: value, "JAX_PLATFORMS": "cpu"},
    )
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize(
    "env,parse,good",
    [
        ("SPOTTER_TPU_GELU", tl.parse_gelu_mode, ("auto", "exact", "tanh")),
        ("SPOTTER_TPU_FLASH_IMPL", tl.parse_flash_impl, ("auto", "splash", "flash")),
    ],
)
def test_knob_values_and_error_texts_match_jax(env, parse, good):
    for value in good:
        assert parse(f" {value.upper()} ") == value
    with pytest.raises(ValueError) as err:
        parse("bogus")
    assert str(err.value) == _jax_error(env, "bogus")


def test_flash_attn_knob_is_read_like_jax():
    """SPOTTER_TPU_FLASH_ATTN: only "0" turns the kernel path off, in both
    packages (each module read again under each value)."""
    code = (
        "import importlib, os\n"
        "import spotter_tpu.models.layers as jl, spotter_tpu_torch.models.layers as tl\n"
        "for value in ('0', '1', 'no'):\n"
        "    os.environ['SPOTTER_TPU_FLASH_ATTN'] = value\n"
        "    importlib.reload(jl); importlib.reload(tl)\n"
        "    print(value, jl._FLASH_ATTN_ENABLED, tl.FLASH_ATTN_ENABLED)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.stdout.split("\n")[-4:-1] == ["0 False False", "1 True True", "no True True"], (
        proc.stdout + proc.stderr)


@pytest.mark.parametrize("mode", ["auto", "exact", "tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_policy_matches_jax(monkeypatch, mode, dtype):
    """fp32: atol 1e-6 (the same formula, other libm); bf16: one bf16 ulp,
    rtol 2**-7 (JAX rounds each elementwise step to bf16, torch computes in
    fp32 and rounds once), atol 2**-8 near zero."""
    monkeypatch.setattr(jl, "_GELU_MODE", mode)
    monkeypatch.setattr(tl, "GELU_MODE", mode)
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    want = np.asarray(jl._gelu(jnp.asarray(x, dtype)), np.float32)
    got = tl.get_activation("gelu")(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = dict(atol=1e-6) if dtype == "float32" else dict(atol=2**-8, rtol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    tanh = mode == "tanh" or (mode == "auto" and dtype == "bfloat16")
    form = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh" if tanh else "none")
    np.testing.assert_allclose(got.float().numpy(), form.numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1100, 2, 128), (2, 1100, 3, 64)])
def test_kernel_matches_plain_version_on_the_card(dtype, shape):
    """fp32: atol 2e-5 (fp32 sums over 1100 keys in another order); bf16:
    against the plain version in fp32 rounded to bf16, within one bf16 ulp
    of the largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _qkv(*shape, logit_scale=2.0))
    wrapper = tattn.flash_attn_fp32 if dtype == torch.float32 else tattn.flash_attn_bf16
    got = wrapper(q, k, v)
    want = tattn.self_attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    atol = 2e-5 if dtype == torch.float32 else 2**-8 * want.abs().max().item()
    assert (got.float() - want.to(dtype).float()).abs().max().item() <= atol
