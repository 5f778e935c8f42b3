"""The micro-batcher's dispatch policy (port of spotter_tpu.engine.scheduler).

Two policies:

- **FIFO (default):** the pack is the first `target` items in arrival
  order, padded by the engine to its static bucket.
- **Slack-ordered (`SPOTTER_TPU_RAGGED=1`, opt-in):** the pump looks
  `LOOKAHEAD_FACTOR` times past the fill target, and the pack takes slo
  before bulk, then least deadline slack first, then arrival order.

Under either policy a pack draws from one query group only
(`QueueItem.group`: an open-vocabulary request's query set, None for the
deployment's own vocabulary): the engine runs one query set per forward.
The leader's group goes first (the queue head under FIFO, the
highest-priority item when slack-ordered); other groups stay pending and
lead a later plan.

With the tenancy plane attached (`Scheduler.tenancy`, serving/tenancy.py)
the order among items of different tenants is deficit-weighted
round-robin: under FIFO over the pending items, when slack-ordered within
each request class (slo before bulk stays structural). With tenancy off, or
one tenant present, the input list itself is used, so FIFO is bit-identical.

What the JAX scheduler adds on top is not ported: the packing of
mixed-size images into one smaller canvas (only `shortest_edge` specs, the
DETR family, have a variable valid region; RT-DETR's 640x640 canvas is
fixed). A batcher of a shortest-edge model under SPOTTER_TPU_RAGGED=1
raises (ROADMAP Queue 1 item 6): the JAX package would stage its images
into smaller canvases, and so compute another result.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Optional

from spotter_tpu_torch.serving.overload import SLO

RAGGED_ENV = "SPOTTER_TPU_RAGGED"

# how far past the fill target the slack-ordered pump looks: a 2x window lets
# an slo arrival displace queued bulk without holding anything longer than
# one dispatch
LOOKAHEAD_FACTOR = 2


def ragged_enabled() -> bool:
    return os.environ.get(RAGGED_ENV, "0").strip() not in ("", "0")


@dataclass
class QueueItem:
    """One queued unit of engine work."""

    image: object  # PIL.Image
    fut: object  # asyncio.Future
    deadline: Optional[object] = None  # resilience.Deadline
    trace: Optional[object] = None  # obs.Trace
    t_submit: float = 0.0
    adm: Optional[object] = None  # overload.Admission
    cls: str = SLO
    # the resolved tenant id, for the DRR order and the per-tenant scoping
    # (None: tenancy unconfigured)
    tenant: Optional[str] = None
    # an open-vocabulary request's caching.text_cache.QuerySet; its key is
    # this item's batch group (None: the deployment's own vocabulary)
    qset: Optional[object] = field(default=None, compare=False)
    # the caller's dict the batcher writes the bucket the item ran in into
    # (the golden probe's); None for traffic
    info: Optional[dict] = field(default=None, compare=False)

    @property
    def group(self) -> Optional[str]:
        return self.qset.key if self.qset is not None else None


class Scheduler:
    """Dispatch policy over pending `QueueItem`s. The batcher owns the
    pending buffer and hands it in by reference (chosen items are removed)."""

    def __init__(self, ragged: bool = False) -> None:
        self.ragged = bool(ragged)
        # a serving.tenancy.TenantPlane (`MicroBatcher.attach_tenancy`), or
        # None (unconfigured)
        self.tenancy = None

    @classmethod
    def from_env(cls) -> "Scheduler":
        return cls(ragged=ragged_enabled())

    @property
    def fifo(self) -> bool:
        return not self.ragged

    def gather_target(self, target: int) -> int:
        """How many items the pump should hold before planning: the fill
        target under FIFO, a lookahead window when slack-ordered."""
        return target if self.fifo else target * LOOKAHEAD_FACTOR

    @staticmethod
    def priority_key(item: QueueItem, now: float):
        """slo before bulk, then least slack first (no deadline = infinite
        slack), then arrival order."""
        slack = item.deadline.remaining() if item.deadline is not None else float("inf")
        return (0 if item.cls == SLO else 1, slack, item.t_submit)

    def _tenant_order(self, items: list) -> list:
        """DRR across the tenants present in `items`. Returns the input list
        itself, not a copy, when tenancy is off or one tenant is present."""
        if self.tenancy is None or len(items) <= 1:
            return items
        return self.tenancy.drr_order(items, lambda it: it.tenant)

    def _classwise_tenant_order(self, items: list) -> list:
        """DRR within each request class: slo before bulk and the slack
        order stay structural; only the order among same-class items of
        different tenants changes."""
        if self.tenancy is None:
            return items
        slo = [it for it in items if it.cls == SLO]
        bulk = [it for it in items if it.cls != SLO]
        o_slo, o_bulk = self._tenant_order(slo), self._tenant_order(bulk)
        if o_slo is slo and o_bulk is bulk:
            return items
        return list(o_slo) + list(o_bulk)

    def plan(self, pending: list[QueueItem], target: int, now: Optional[float] = None) -> list:
        """Pick (and remove from `pending`) the next dispatch's items, all of
        the leader's query group."""
        target = max(1, target)
        if len({it.group for it in pending}) > 1:
            now = time.monotonic() if now is None else now
            leader = pending[0] if self.fifo else min(
                pending, key=lambda it: self.priority_key(it, now))
            selected = [it for it in pending if it.group == leader.group]
            pack = self._plan_from(selected, target, now)
            chosen = {id(it) for it in pack}
            pending[:] = [it for it in pending if id(it) not in chosen]
            return pack
        return self._plan_from(pending, target, now)

    def _plan_from(self, pending: list[QueueItem], target: int, now: Optional[float]) -> list:
        if self.fifo:
            ordered = self._tenant_order(pending)
            if ordered is pending:
                # tenancy off or one tenant: the plain FIFO drain
                pack = pending[:target]
                del pending[: len(pack)]
                return pack
            pack = ordered[:target]
            chosen = {id(it) for it in pack}
            pending[:] = [it for it in pending if id(it) not in chosen]
            return pack
        now = time.monotonic() if now is None else now
        items = sorted(pending, key=lambda it: self.priority_key(it, now))
        pack = self._classwise_tenant_order(items)[:target]
        chosen = {id(it) for it in pack}
        pending[:] = [it for it in pending if id(it) not in chosen]
        return pack
