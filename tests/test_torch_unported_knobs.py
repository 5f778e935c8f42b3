"""The JAX package's serving knobs: each serves as the JAX package's does, or,
where the port lacks the plane, is refused rather than ignored.

- The tenancy and result-cache planes are ported: every knob that used to
  be refused now brings the replica up, building the plane exactly when
  JAX's `tenancy.from_env` / `ResultCache.from_env` builds it; the knobs'
  off values serve without it, and a cache size that is not a number
  raises the JAX text. The output-integrity plane is ported:
  `SPOTTER_TPU_INTEGRITY` serves with the plane on (any value but "" and
  "0", the default) or off, and the plane's snapshot is in /metrics, not
  /healthz.
- `SPOTTER_TPU_MSDA_PRECISION`: "highest" and "default" (one bf16 pass,
  the MSDA kernels' one-pass mode) serve; any other value raises with the
  JAX package's own text, at build and when a forward runs.
"""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from spotter_tpu.caching import result_cache as jrc
from spotter_tpu.ops import msda as jmsda  # imported before any test sets the knob
from spotter_tpu.serving import tenancy as jtenancy
from spotter_tpu_torch.caching import result_cache
from spotter_tpu_torch.ops import msda
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import integrity, tenancy
from spotter_tpu_torch.serving import standalone as tstandalone

MODEL = "PekingU/rtdetr_v2_r101vd"
TENANCY_KNOBS = (
    tenancy.TENANT_KEYS_ENV, tenancy.TENANT_CONFIG_ENV, tenancy.TENANT_RPS_DEFAULT_ENV,
    tenancy.TENANT_TOP_K_ENV, tenancy.TENANT_EDGE_SECRET_ENV, tenancy.TENANT_TRUST_HEADER_ENV,
)
# the knobs the port refused while it lacked their planes
PLANE_KNOBS = [(knob, "x") for knob in TENANCY_KNOBS] + [
    ("SPOTTER_TPU_TENANT_KEYS", "k1:acme"),
    ("SPOTTER_TPU_CACHE_MAX_MB", "64"),
    ("SPOTTER_TPU_CACHE_MAX_MB", "0.5"),
]
INTEGRITY_VALUES = [("1", True), ("true", True), ("", False), ("0", False), (" 0 ", False)]
OFF_VALUES = [(knob, "") for knob in TENANCY_KNOBS] + [
    ("SPOTTER_TPU_TENANT_KEYS", "  "),
    ("SPOTTER_TPU_CACHE_MAX_MB", "0"),
    ("SPOTTER_TPU_CACHE_MAX_MB", ""),
    ("SPOTTER_TPU_CACHE_MAX_MB", "-1"),
    ("SPOTTER_TPU_INTEGRITY", ""),
    ("SPOTTER_TPU_INTEGRITY", "0"),
    ("SPOTTER_TPU_INTEGRITY", " 0 "),
]
ALL_KNOBS = (*TENANCY_KNOBS, result_cache.CACHE_MAX_MB_ENV, integrity.INTEGRITY_ENV)


@pytest.fixture
def clean_env(monkeypatch):
    for knob in ALL_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.delenv("SPOTTER_TPU_MSDA_PRECISION", raising=False)
    monkeypatch.delenv("SPOTTER_TPU_ADMIN_TOKEN", raising=False)
    return monkeypatch


@pytest.mark.parametrize("knob,value", PLANE_KNOBS, ids=lambda v: str(v))
def test_plane_knob_serves_as_jax_at_bring_up(clean_env, knob, value):
    """Formerly refusals: each knob brings the replica up, with the plane
    built exactly when the JAX package builds it (a tenancy knob alone such
    as SPOTTER_TPU_TENANT_TOP_K configures nothing there either)."""
    clean_env.setenv(knob, value)
    tapp.refuse_unported_planes()
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1,))
    assert det.engine.device.type == "cpu"
    assert (det.cache is None) == (jrc.ResultCache.from_env() is None)
    if det.cache is not None:
        assert det.cache.stats() == jrc.ResultCache.from_env().stats()
        assert det.batcher.result_cache is det.cache
    app = tstandalone.make_app(model_name=MODEL, device="cpu")
    assert (app["tenancy"] is None) == (jtenancy.from_env() is None)


@pytest.mark.parametrize("knob,value", OFF_VALUES, ids=lambda v: repr(v))
def test_unported_plane_knob_off_values_serve(clean_env, knob, value):
    clean_env.setenv(knob, value)
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1,))
    assert det.engine.device.type == "cpu"
    assert det.cache is None and tenancy.from_env() is None


def test_cache_size_must_be_a_number(clean_env):
    clean_env.setenv("SPOTTER_TPU_CACHE_MAX_MB", "lots")
    with pytest.raises(ValueError, match="must be a number") as want:
        jrc.ResultCache.from_env()
    with pytest.raises(ValueError, match="must be a number") as got:
        tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1,))
    assert str(got.value) == str(want.value)


async def _bring_up(app, polls: int = 600):
    """Start `app` (a bring-up app) and wait for /startupz to reach ready or
    failed; returns the client (caller closes it)."""
    client = TestClient(TestServer(app))
    await client.start_server()
    for _ in range(polls):
        body = await (await client.get("/startupz")).json()
        if body["state"] in ("ready", "failed"):
            break
        await asyncio.sleep(0.05)
    return client


@pytest.fixture
def tiny_bring_up(clean_env):
    """The standalone bring-up path on a tiny RT-DETR at buckets (1, 2)."""
    clean_env.setenv("SPOTTER_TPU_TINY", "1")
    clean_env.setenv("SPOTTER_TPU_BATCH_BUCKETS", "1,2")
    return clean_env


@pytest.mark.parametrize("value,plane_on", INTEGRITY_VALUES, ids=repr)
def test_integrity_knob_serves_with_the_plane_on_or_off(tiny_bring_up, value, plane_on):
    """Formerly a refusal: any SPOTTER_TPU_INTEGRITY value serves; every value
    but "" and "0" turns the plane on, which verifies before READY."""
    tiny_bring_up.setenv("SPOTTER_TPU_INTEGRITY", value)
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1,))
    assert det.engine.device.type == "cpu"
    assert integrity.integrity_enabled() is plane_on
    exits = []
    app = tstandalone.make_app(model_name=MODEL, device="cpu", bringup_exit_cb=exits.append,
                               integrity_exit_cb=exits.append)

    async def run():
        client = await _bring_up(app)
        try:
            startup = await (await client.get("/startupz")).json()
            snap = await (await client.get("/metrics")).json()
            return startup, snap
        finally:
            await client.close()

    startup, snap = asyncio.run(run())
    assert startup["state"] == "ready" and not exits
    assert ("integrity" in snap) is plane_on


def test_healthz_reports_integrity_off(tiny_bring_up):
    """/healthz carries no integrity key (the JAX /healthz has none); the
    plane's snapshot is in /metrics, after a passed verification."""
    app = tstandalone.make_app(model_name=MODEL, device="cpu")

    async def run():
        client = await _bring_up(app)
        try:
            resp = await client.get("/healthz")
            return resp.status, await resp.json(), await (await client.get("/metrics")).json()
        finally:
            await client.close()

    status, body, snap = asyncio.run(run())
    assert status == 200 and body["ready"] is True
    assert "integrity" not in body
    integ = snap["integrity"]
    assert integ["verifications_total"] == 1 and integ["verification_failures_total"] == 0
    assert integ["probe"]["pinned"] and integ["probe"]["pinned_buckets"] == [1, 2]
    assert integ["attest"]["attests_total"] == 1 and integ["attest"]["failures_total"] == 0


def _photo(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_msda_precision_highest_serves(clean_env):
    clean_env.setenv("SPOTTER_TPU_MSDA_PRECISION", "highest")
    clean_env.setattr(msda, "MSDA_PRECISION", "highest")
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1,))
    (dets,) = det.engine.detect([_photo(0)])
    assert isinstance(dets, list)


@pytest.mark.parametrize("family", [MODEL, "SenseTime/deformable-detr"])
def test_msda_precision_default_raises_at_build_and_forward(clean_env, family):
    """Formerly a refusal: SPOTTER_TPU_MSDA_PRECISION=default (the one-pass
    mode of MSDA rows 1-4) now builds and serves through
    build_detector_app, and each MSDA op of the forward runs it."""
    clean_env.setenv("SPOTTER_TPU_MSDA_PRECISION", "default")
    clean_env.setattr(msda, "MSDA_PRECISION", "default")
    seen = []
    real = msda.msda_gather_sum
    clean_env.setattr(msda, "msda_gather_sum",
                      lambda *a, **k: seen.append(k.get("precision", a[-1])) or real(*a, **k))
    det = tapp.build_detector_app(family, tiny=True, device="cpu", batch_buckets=(1,))
    (dets,) = det.engine.detect([_photo(1)])
    assert isinstance(dets, list)
    assert seen and set(seen) == {"default"}


def test_msda_precision_bogus_raises_with_the_jax_text(clean_env):
    clean_env.setenv("SPOTTER_TPU_MSDA_PRECISION", "Bogus")
    with pytest.raises(ValueError) as jax_err:
        jmsda._mxu_precision()
    with pytest.raises(ValueError) as port_err:
        tapp.build_detector_app(MODEL, tiny=True, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as forward_err:
        msda.check_msda_precision("Bogus")
    assert str(forward_err.value) == str(jax_err.value)


def test_msda_precision_unset_is_highest():
    assert msda.check_msda_precision(None) == "highest"
    assert msda.check_msda_precision(" HIGHEST ") == "highest"
