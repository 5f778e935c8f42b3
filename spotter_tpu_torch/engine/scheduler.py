"""The micro-batcher's dispatch policy (port of spotter_tpu.engine.scheduler).

Two policies:

- **FIFO (default):** the pack is the first `target` items in arrival
  order, padded by the engine to its static bucket (`PackPlan.canvas_hw`
  None). Its padded-pixel waste is still measured against that bucket, so
  the per-bucket baseline is observable.
- **Ragged (`SPOTTER_TPU_RAGGED=1`, opt-in):** the pump looks
  `LOOKAHEAD_FACTOR` times past the fill target, the order is slo before
  bulk, then least deadline slack, then arrival, and mixed-size photos pack
  into one padded canvas, built full-fill min-growth:

  1. **Mandatory tier:** deadline-carrying items whose slack has shrunk to
     `SPOTTER_TPU_RAGGED_URGENT_MS` (default 100) enter in slack order,
     never displaced by a better-packing neighbour.
  2. **Seed:** with no urgent item, the highest-priority item seeds the
     pack, so the oldest work always dispatches.
  3. **Backfill:** the remaining slots fill from the priority order,
     preferring items that fit the current snapped canvas; only when none
     fits does the canvas grow, by the item that grows it least.

  A pack fills to the target whenever the pending buffer can: a dispatch
  costs its padded batch times its canvas area whether slots are full or
  not. Canvases snap up to multiples of `SPOTTER_TPU_RAGGED_STEP` (default
  128), capped at the spec's static bucket, so the number of shapes (and
  of CUDA graphs, engine/graphs.py) stays bounded: at the DETR family's
  1333x1333 bucket at most 11x11 canvases a batch bucket. Only
  `shortest_edge` specs (Deformable-DETR and the DETR lineage) have a
  variable valid region; fixed-size specs get the slack order and keep
  their one canvas. An engine with no spec (a stub) packs by the images'
  own sizes, as the JAX scheduler does.

Under either policy a pack draws from one query group only
(`QueueItem.group`: an open-vocabulary request's query set, None for the
deployment's own vocabulary): the engine runs one query set per forward.
The leader's group goes first (the queue head under FIFO, the
highest-priority item when ragged); other groups stay pending and lead a
later plan.

With the tenancy plane attached (`Scheduler.tenancy`, serving/tenancy.py)
the order among items of different tenants is deficit-weighted
round-robin: under FIFO over the pending items, when ragged within each
request class (slo before bulk stays structural). With tenancy off, or one
tenant present, the input list itself is used, so FIFO is bit-identical.

One rule the JAX scheduler lacks: an item that carries `info` (the golden
probe's) only shares a ragged pack whose canvas is its own snapped
canvas, so every probe's answer comes from the canvas its pins were taken
at (serving/integrity.py). A canvas changes a shortest-edge model's
answer: each convolution spreads the photo into the zero pad beside it,
and a smaller canvas cuts those features off. With no such item the plan
is the JAX plan.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from spotter_tpu_torch.ops.preprocess import shortest_edge_size
from spotter_tpu_torch.serving.overload import SLO

RAGGED_ENV = "SPOTTER_TPU_RAGGED"
RAGGED_STEP_ENV = "SPOTTER_TPU_RAGGED_STEP"
DEFAULT_RAGGED_STEP = 128
RAGGED_URGENT_MS_ENV = "SPOTTER_TPU_RAGGED_URGENT_MS"
DEFAULT_RAGGED_URGENT_MS = 100.0

# how far past the fill target the ragged pump looks: a 2x window lets a
# same-shape backfill displace a canvas-growing straggler (and an slo arrival
# queued bulk) without holding anything longer than one dispatch
LOOKAHEAD_FACTOR = 2


def ragged_enabled() -> bool:
    return os.environ.get(RAGGED_ENV, "0").strip() not in ("", "0")


def ragged_step() -> int:
    raw = os.environ.get(RAGGED_STEP_ENV, "").strip()
    try:
        step = int(raw) if raw else DEFAULT_RAGGED_STEP
    except ValueError:
        raise ValueError(f"{RAGGED_STEP_ENV} must be an integer, got {raw!r}")
    return max(1, step)


def image_hw(image) -> tuple[int, int]:
    """(h, w) of a PIL image or an (H, W, 3) array."""
    if hasattr(image, "height"):
        return int(image.height), int(image.width)
    return int(image.shape[0]), int(image.shape[1])


@dataclass
class QueueItem:
    """One queued unit of engine work."""

    image: object  # PIL.Image or uint8 (H, W, 3) array
    fut: object  # asyncio.Future
    deadline: Optional[object] = None  # resilience.Deadline
    trace: Optional[object] = None  # obs.Trace
    t_submit: float = 0.0
    adm: Optional[object] = None  # overload.Admission
    cls: str = SLO
    # the resolved tenant id, for the DRR order and the per-tenant scoping
    # (None: tenancy unconfigured)
    tenant: Optional[str] = None
    # the image's valid (h, w) once staged, cached by the ragged plan
    dims: Optional[tuple[int, int]] = field(default=None, compare=False)
    # an open-vocabulary request's caching.text_cache.QuerySet; its key is
    # this item's batch group (None: the deployment's own vocabulary)
    qset: Optional[object] = field(default=None, compare=False)
    # the caller's dict the batcher writes the bucket and canvas the item
    # ran in into (the golden probe's); None for traffic
    info: Optional[dict] = field(default=None, compare=False)

    @property
    def group(self) -> Optional[str]:
        return self.qset.key if self.qset is not None else None


@dataclass
class PackPlan:
    """One dispatch: the packed items, the padded canvas they stage into
    (None: the spec's static bucket), and the pack's padded-pixel waste in
    percent (None without a spec)."""

    items: list[QueueItem]
    canvas_hw: Optional[tuple[int, int]] = None
    padding_waste_pct: Optional[float] = None


class Scheduler:
    """Dispatch policy over pending `QueueItem`s. The batcher owns the
    pending buffer and hands it in by reference (chosen items are removed)."""

    def __init__(
        self,
        spec=None,
        ragged: bool = False,
        step: Optional[int] = None,
        urgent_ms: Optional[float] = None,
        tenancy=None,
    ) -> None:
        # a serving.tenancy.TenantPlane (`MicroBatcher.attach_tenancy`), or
        # None (unconfigured)
        self.tenancy = tenancy
        self.spec = spec
        self.step = step if step is not None else ragged_step()
        if urgent_ms is None:
            raw = os.environ.get(RAGGED_URGENT_MS_ENV, "").strip()
            urgent_ms = float(raw) if raw else DEFAULT_RAGGED_URGENT_MS
        self.urgent_ms = urgent_ms
        # only shortest_edge specs have a variable valid region; an engine
        # with no spec (a stub) packs by the images' own sizes
        self.canvas_capable = spec is None or getattr(spec, "mode", None) == "shortest_edge"
        self.ragged = bool(ragged)

    @classmethod
    def from_env(cls, engine) -> "Scheduler":
        spec = getattr(getattr(engine, "built", None), "preprocess_spec", None)
        return cls(spec=spec, ragged=ragged_enabled())

    @property
    def fifo(self) -> bool:
        return not self.ragged

    def gather_target(self, target: int) -> int:
        """How many items the pump should hold before planning: the fill
        target under FIFO, a lookahead window when ragged."""
        return target if self.fifo else target * LOOKAHEAD_FACTOR

    def item_dims(self, item: QueueItem) -> tuple[int, int]:
        """The item's valid (h, w) once staged: its shortest-edge resize,
        the static canvas for the other specs, its own size with no spec.
        Cached on the item."""
        if item.dims is not None:
            return item.dims
        spec = self.spec
        if spec is None:
            dims = image_hw(item.image)
        elif spec.mode == "shortest_edge":
            dims = shortest_edge_size(image_hw(item.image), spec.size[0], spec.size[1])
        else:  # fixed / pad_square: every image fills the static canvas
            dims = spec.input_hw
        item.dims = dims
        return dims

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

    def _full_canvas(self) -> Optional[tuple[int, int]]:
        return self.spec.input_hw if self.spec is not None else None

    def _snap(self, hw: tuple[int, int]) -> tuple[int, int]:
        """Round a canvas up to the step grid, capped at the static bucket."""
        cap = self._full_canvas()
        out = []
        for i, d in enumerate(hw):
            s = -(-d // self.step) * self.step
            if cap is not None:
                s = min(s, cap[i])
            out.append(max(s, d if cap is None else min(d, cap[i])))
        return (out[0], out[1])

    @staticmethod
    def _waste_pct(dims: Sequence[tuple[int, int]], canvas: tuple[int, int]) -> float:
        area = canvas[0] * canvas[1]
        if not dims or area <= 0:
            return 0.0
        valid = sum(h * w for h, w in dims)
        return 100.0 * (1.0 - valid / (len(dims) * area))

    @staticmethod
    def _padded_batch(n: int, buckets: Optional[Sequence[int]]) -> int:
        """The batch size the engine pads `n` items to."""
        if not buckets:
            return n
        for b in sorted(buckets):
            if n <= b:
                return b
        return max(buckets)

    def plan(
        self,
        pending: list[QueueItem],
        target: int,
        now: Optional[float] = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> PackPlan:
        """Pick (and remove from `pending`) the next dispatch's pack, all of
        the leader's query group. `buckets` is the ladder the engine pads
        to (the JAX signature's; the pack fills to `target` either way)."""
        target = max(1, target)
        if len({it.group for it in pending}) > 1:
            now = time.monotonic() if now is None else now
            leader = pending[0] if self.fifo else min(
                pending, key=lambda it: self.priority_key(it, now))
            selected = [it for it in pending if it.group == leader.group]
            plan = self._plan_from(selected, target, now, buckets)
            chosen = {id(it) for it in plan.items}
            pending[:] = [it for it in pending if id(it) not in chosen]
            return plan
        return self._plan_from(pending, target, now, buckets)

    def _static_plan(self, pack: list[QueueItem]) -> PackPlan:
        """A pack staged to the static bucket, its waste against it."""
        full = self._full_canvas()
        waste = (self._waste_pct([self.item_dims(it) for it in pack], full)
                 if full is not None and pack else None)
        return PackPlan(pack, None, waste)

    def _plan_from(
        self,
        pending: list[QueueItem],
        target: int,
        now: Optional[float] = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> PackPlan:
        """The one-group policy body (see `plan`); mutates `pending`."""
        if self.fifo:
            ordered = self._tenant_order(pending)
            if ordered is pending:
                # tenancy off or one tenant: the plain FIFO drain
                pack = pending[:target]
                del pending[: len(pack)]
            else:
                pack = ordered[:target]
                chosen = {id(it) for it in pack}
                pending[:] = [it for it in pending if id(it) not in chosen]
            return self._static_plan(pack)

        now = time.monotonic() if now is None else now
        items = sorted(pending, key=lambda it: self.priority_key(it, now))
        items = self._classwise_tenant_order(items)

        if not self.canvas_capable:
            # fixed-canvas spec: the slack order only, the static canvas
            pack = items[:target]
            chosen = {id(it) for it in pack}
            pending[:] = [it for it in pending if id(it) not in chosen]
            return self._static_plan(pack)

        # mandatory tier: urgent deadline items, in slack order
        pack: list[QueueItem] = []
        pool: list[QueueItem] = []
        for it in items:
            if (
                len(pack) < target
                and it.deadline is not None
                and it.deadline.remaining() * 1000.0 <= self.urgent_ms
                and self._joins(pack, it)
            ):
                pack.append(it)
            else:
                pool.append(it)
        if not pack and pool:
            pack.append(pool.pop(0))  # seed: the highest-priority item
        run_h = max((self.item_dims(it)[0] for it in pack), default=0)
        run_w = max((self.item_dims(it)[1] for it in pack), default=0)

        # backfill: fit-first in priority order, then least-growth
        while len(pack) < target and pool:
            ch, cw = self._snap((run_h, run_w))
            fit_idx = None
            grow_idx = None
            grow_area = None
            for i, it in enumerate(pool):
                if not self._joins(pack, it):
                    continue
                h, w = self.item_dims(it)
                if h <= ch and w <= cw:
                    fit_idx = i
                    break
                gh, gw = self._snap((max(run_h, h), max(run_w, w)))
                if grow_area is None or gh * gw < grow_area:
                    grow_idx, grow_area = i, gh * gw
            pick = fit_idx if fit_idx is not None else grow_idx
            if pick is None:
                break  # nothing left may join a pack holding a probe
            it = pool.pop(pick)
            h, w = self.item_dims(it)
            run_h, run_w = max(run_h, h), max(run_w, w)
            pack.append(it)

        canvas = self._snap((run_h, run_w))
        chosen = {id(it) for it in pack}
        pending[:] = [it for it in pending if id(it) not in chosen]
        return PackPlan(
            pack,
            canvas,
            self._waste_pct([self.item_dims(it) for it in pack], canvas),
        )

    def _joins(self, pack: list[QueueItem], item: QueueItem) -> bool:
        """Whether `item` may join `pack` under the probe rule: every item
        of a pack that holds an `info` item fits that item's own snapped
        canvas, so the pack's canvas is that canvas. Always True when
        neither `item` nor the pack carries `info`."""
        members = pack + [item]
        anchors = [self._snap(self.item_dims(it)) for it in members if it.info is not None]
        if not anchors:
            return True
        limit_h, limit_w = min(a[0] for a in anchors), min(a[1] for a in anchors)
        return all(self.item_dims(it)[0] <= limit_h and self.item_dims(it)[1] <= limit_w
                   for it in members)
