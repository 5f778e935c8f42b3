"""The port's tenant isolation plane (`spotter_tpu_torch.serving.tenancy`)
and its arbiters (scheduler, limiter, brownout) against the JAX package's,
on the same seeded inputs, under fake clocks.

Held: `TokenBucket` gives the same admit/shed sequence and Retry-After;
`resolve` maps a table of header sets (a spoofed header without the
token, the edge token, an API-key match and a mismatch, the trust opt-in)
to the same tenant ids; `drr_order` gives the same order on seeded items
and weights; a seeded flood gives the same admissions, sheds (kind,
Retry-After and text), `metrics_view` (top K plus `other`) and `snapshot`;
a config that cannot be read is handled with JAX's texts. The port's
`Scheduler` plans the same packs as JAX's over seeded tenant-tagged
`QueueItem`s (FIFO and slack-ordered) and returns the input list itself
with one tenant; the limiter revokes the same victim and brownout rung 4
scopes the same way.
"""

import asyncio
import json
import logging
import random

import numpy as np
import pytest

from spotter_tpu.engine.scheduler import QueueItem as JItem
from spotter_tpu.engine.scheduler import Scheduler as JScheduler
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.serving import overload as joverload
from spotter_tpu.serving import tenancy as jtenancy
from spotter_tpu_torch.engine.scheduler import QueueItem, Scheduler
from spotter_tpu_torch.ops.preprocess import PreprocessSpec
from spotter_tpu_torch.serving import overload, tenancy

TENANTS = ("acme", "hobby", "anon", "t3", "t4")
CONFIG = {"default": {"rps": 3, "burst": 4, "weight": 1, "max_inflight": 3},
          "tenants": {"acme": {"rps": 50, "weight": 4}, "hobby": {"rps": 2, "burst": 4},
                      "t3": {"weight": 2.5, "max_inflight": 0}}}


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _planes(config=CONFIG, seed=0, **kw):
    """(port plane, its clock), (JAX plane, its clock): same config, same
    seeded jitter."""
    out = []
    for mod in (tenancy, jtenancy):
        clock = Clock()
        out.append((mod.TenantPlane(config=config, clock=clock, rng=random.Random(seed), **kw),
                    clock))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_as_jax(seed):
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.uniform(0.5, 20)), float(rng.uniform(0.5, 30))
    (pc, jc) = Clock(), Clock()
    port, jax = tenancy.TokenBucket(rate, burst, clock=pc), jtenancy.TokenBucket(rate, burst,
                                                                                 clock=jc)
    for _ in range(300):
        dt = float(rng.exponential(1.0 / rate)) if rng.uniform() < 0.7 else 0.0
        pc.t += dt
        jc.t += dt
        n = float(rng.choice([1.0, 0.5, 2.0]))
        assert port.try_take(n) == jax.try_take(n)
        assert port.retry_after_s(n) == jax.retry_after_s(n)
        assert port.tokens == jax.tokens


HEADERS = [
    {},
    {"X-Spotter-Tenant": "acme"},
    {"X-Spotter-Tenant": "acme", "X-Spotter-Edge-Token": "s3cret"},
    {"X-Spotter-Tenant": "acme", "X-Spotter-Edge-Token": "wrong"},
    {"X-API-Key": "key-acme"},
    {"X-API-Key": "key-acme", "X-Spotter-Tenant": "acme"},
    {"X-API-Key": "key-acme", "X-Spotter-Tenant": "hobby"},
    {"X-API-Key": "nope", "X-Spotter-Tenant": "hobby"},
    {"X-API-Key": " key-hobby ", "X-Spotter-Tenant": "  "},
]


@pytest.mark.parametrize("secret,trust", [(None, False), ("s3cret", False), (None, True)])
def test_resolve_as_jax(secret, trust):
    keymap = {"key-acme": "acme", "key-hobby": "hobby"}
    (port, _), (jax, _) = _planes(key_map=keymap, edge_secret=secret, trust_header=trust)
    for headers in HEADERS + [None]:
        assert port.resolve(headers) == jax.resolve(headers), headers
    assert port.header_rejects_total == jax.header_rejects_total
    out, jout = {}, {}
    port.stamp(out, "acme")
    jax.stamp(jout, "acme")
    assert out == jout


@pytest.mark.parametrize("seed", range(3))
def test_drr_order_as_jax(seed):
    rng = np.random.default_rng(seed)
    config = {"tenants": {t: {"weight": float(rng.choice([0.5, 1, 2, 3.5]))} for t in TENANTS}}
    (port, _), (jax, _) = _planes(config=config)
    for _ in range(10):
        items = [(str(rng.choice(TENANTS + ("",))), i) for i in range(int(rng.integers(0, 30)))]
        got = port.drr_order(items, lambda it: it[0])
        assert got == jax.drr_order(items, lambda it: it[0])
    one = [("acme", i) for i in range(5)]
    assert port.drr_order(one, lambda it: it[0]) is one


def _shed(exc):
    return (type(exc).__name__, exc.kind, exc.tenant, exc.retry_after_s, str(exc), exc.status)


@pytest.mark.parametrize("seed", range(3))
def test_flood_admissions_and_views_as_jax(seed):
    """A seeded flood (hobby far over quota, a crowd of invented ids past
    top K): the same admissions, sheds, releases, views and snapshots."""
    rng = np.random.default_rng(seed)
    (port, pc), (jax, jc) = _planes(seed=seed, top_k=3)
    held = {"port": [], "jax": []}
    for step in range(400):
        tenant = str(rng.choice(TENANTS + tuple(f"x{i}" for i in range(6)),
                                p=[0.15, 0.4, 0.05, 0.1, 0.1] + [0.2 / 6] * 6))
        dt = float(rng.exponential(0.05))
        pc.t += dt
        jc.t += dt
        outcomes = []
        for name, plane in (("port", port), ("jax", jax)):
            try:
                held[name].append(plane.try_admit(tenant))
                outcomes.append("admit")
            except (tenancy.TenantQuotaError, jtenancy.TenantQuotaError) as exc:
                outcomes.append(_shed(exc))
        assert outcomes[0] == outcomes[1], step
        if held["port"] and rng.uniform() < 0.5:
            i = int(rng.integers(0, len(held["port"])))
            good = [True, False, None][int(rng.integers(0, 3))]
            held["port"].pop(i).release(good)
            held["jax"].pop(i).release(good)
        assert port.top_occupancy_tenant() == jax.top_occupancy_tenant()
        assert port.over_share(tenant) == jax.over_share(tenant)
    assert port.metrics_view() == jax.metrics_view()
    assert "other" in port.metrics_view()
    assert port.snapshot() == jax.snapshot()
    for t in TENANTS:
        port.record_outcome(t, False)
        jax.record_outcome(t, False)
    assert port.snapshot() == jax.snapshot()


BAD_CONFIGS = ['{"default": {"rps": 5}', "not-a-path-or-json", '["a list"]',
               '{"tenants": {"a": {"rps": "x"}}}']


def test_config_parse_errors_as_jax(monkeypatch, tmp_path, caplog):
    keys = tmp_path / "keys.json"
    keys.write_text("[1, 2]")
    bad_json = tmp_path / "bad.json"
    bad_json.write_text("{")
    cases = [{jtenancy.TENANT_CONFIG_ENV: c} for c in BAD_CONFIGS] + [
        {jtenancy.TENANT_KEYS_ENV: str(keys)}, {jtenancy.TENANT_KEYS_ENV: str(bad_json)},
        {jtenancy.TENANT_KEYS_ENV: str(tmp_path / "missing.json")},
        {jtenancy.TENANT_RPS_DEFAULT_ENV: "lots"},
        {jtenancy.TENANT_RPS_DEFAULT_ENV: "2", jtenancy.TENANT_TOP_K_ENV: "many"},
    ]
    for env in cases:
        for knob in (jtenancy.TENANT_CONFIG_ENV, jtenancy.TENANT_KEYS_ENV,
                     jtenancy.TENANT_RPS_DEFAULT_ENV, jtenancy.TENANT_TOP_K_ENV):
            monkeypatch.delenv(knob, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = []
        for mod in (tenancy, jtenancy):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                try:
                    plane = mod.from_env()
                    result = ("plane", plane.snapshot(), plane._tenant_cfg, plane._key_map)
                except Exception as exc:  # the plane's first use raises it
                    result = ("raise", type(exc).__name__, str(exc))
                if result[0] == "plane":
                    try:
                        plane.try_admit("a")
                    except Exception as exc:
                        result = ("raise", type(exc).__name__, str(exc))
            got.append((result, [r.getMessage() for r in caplog.records]))
        assert got[0] == got[1], env


def _items(mod, rng, n):
    return [mod(image=None, fut=None, tenant=str(rng.choice(TENANTS)),
                cls=str(rng.choice(["slo", "bulk"])), t_submit=float(i)) for i in range(n)]


@pytest.mark.parametrize("ragged", [False, True], ids=["fifo", "slack"])
@pytest.mark.parametrize("seed", range(2))
def test_scheduler_plans_as_jax(seed, ragged):
    (port_plane, _), (jax_plane, _) = _planes(
        config={"tenants": {"acme": {"weight": 3}, "t3": {"weight": 0.5}}})
    sched = Scheduler(spec=PreprocessSpec(mode="fixed", size=(64, 64)), ragged=ragged)
    sched.tenancy = port_plane
    jsched = JScheduler(spec=JSpec(mode="fixed", size=(64, 64)), ragged=ragged,
                        tenancy=jax_plane)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 40))
    pending, jpending = _items(QueueItem, np.random.default_rng(seed), n), _items(
        JItem, np.random.default_rng(seed), n)
    while pending:
        target = int(rng.integers(1, 9))
        pack = sched.plan(pending, target, now=0.0).items
        jpack = jsched.plan(jpending, target, now=0.0).items
        assert [it.t_submit for it in pack] == [it.t_submit for it in jpack]
        assert [it.t_submit for it in pending] == [it.t_submit for it in jpending]
    assert not jpending


def test_scheduler_returns_the_input_list_with_one_tenant():
    (plane, _), _ = _planes()
    sched = Scheduler()
    sched.tenancy = plane
    items = [QueueItem(image=None, fut=None, tenant="acme", t_submit=float(i)) for i in range(5)]
    assert sched._tenant_order(items) is items
    assert Scheduler()._tenant_order(items) is items
    assert sched._classwise_tenant_order(items) is items
    pending = list(items)
    assert all(a is b for a, b in zip(sched.plan(pending, 5).items, items)) and pending == []


@pytest.mark.parametrize("seed", range(2))
def test_limiter_revokes_the_same_victim_as_jax(seed):
    """Bulk admissions of several tenants queued and revocable, the limit
    full: each slo arrival revokes the same tenant's newest bulk on both
    sides (the top-occupancy tenant's first)."""
    rng = np.random.default_rng(seed)
    sides = []
    for plane_mod, over in ((tenancy, overload), (jtenancy, joverload)):
        clock = Clock()
        plane = plane_mod.TenantPlane(config={"tenants": {"acme": {"weight": 3}}}, clock=clock)
        limiter = over.AdaptiveLimiter(target_ms=50.0, floor=1, ceiling=12, clock=clock)
        limiter.tenancy = plane
        sides.append((plane, limiter, []))
    order = [str(t) for t in rng.choice(TENANTS[:4], 12)]
    for tenant in order:
        for plane, limiter, log in sides:
            slot = plane.try_admit(tenant)  # occupancy, as the HTTP layer holds it
            adm = limiter.try_admit("bulk", tenant)
            adm.attach_revoke(lambda t=tenant, a=adm, log=log: log.append((t, id(a))))
            log.append(("slot", slot))
    victims = []
    for plane, limiter, log in sides:
        got = []
        for _ in range(4):
            before = len(log)
            assert limiter.try_admit("slo", "hobby") is not None
            got.append(log[before][0] if len(log) > before else None)
        victims.append(got)
    assert victims[0] == victims[1] and victims[0][0] is not None


def test_brownout_rung_4_scopes_as_jax():
    (port_plane, _), (jax_plane, _) = _planes()
    for plane in (port_plane, jax_plane):
        for t, n in (("acme", 1), ("hobby", 3), ("t3", 2)):
            for _ in range(n):
                plane.try_admit(t)
    got = []
    for over, plane in ((overload, port_plane), (joverload, jax_plane)):
        b = over.BrownoutController(lambda: True)
        b.tenancy = plane
        answers = [b.shed_bulk(t) for t in (*TENANTS, None)]
        b._rung = over.RUNG_BULK_503
        answers += [b.shed_bulk(t) for t in (*TENANTS, None)]
        b.tenancy = None
        answers += [b.shed_bulk(t) for t in (*TENANTS, None)]
        b._rung = over.RUNG_STALE
        answers += [b.stale_ok(), b.markers()]
        got.append(answers)
    assert got[0] == got[1]
    assert any(got[0][6:12]) and not all(got[0][6:11])


def test_batcher_threads_tenant_into_queue_items():
    """`submit(tenant=...)` stamps the item, and the attached plane reaches
    the scheduler, limiter and brownout."""
    from spotter_tpu_torch.engine.batcher import MicroBatcher
    from spotter_tpu_torch.engine.metrics import Metrics

    class Engine:
        metrics = Metrics()
        batch_buckets = (1, 2)
        seen: list = []

        def detect(self, images):
            return [[] for _ in images]

    engine = Engine()
    (plane, _), _ = _planes()
    limiter = overload.AdaptiveLimiter(target_ms=50.0)
    brownout = overload.BrownoutController(lambda: False)
    batcher = MicroBatcher(engine, max_delay_ms=1.0, limiter=limiter, brownout=brownout)
    batcher.attach_tenancy(plane)
    assert batcher.scheduler.tenancy is limiter.tenancy is brownout.tenancy is plane
    planned = []
    real_plan = batcher.scheduler.plan

    def plan(pending, target, now=None):
        planned.extend(it.tenant for it in pending)
        return real_plan(pending, target, now)

    batcher.scheduler.plan = plan

    async def run():
        await asyncio.gather(batcher.submit(object(), tenant="acme"),
                             batcher.submit(object(), tenant="hobby", cls="bulk"))
        await batcher.stop()

    asyncio.run(run())
    assert sorted(planned) == ["acme", "hobby"]
    assert json.dumps(limiter.snapshot())
