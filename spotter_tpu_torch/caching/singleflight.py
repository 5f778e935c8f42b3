"""Async single-flight coalescing: N concurrent calls, one underlying flight
(the port's copy of spotter_tpu.caching.singleflight).

The detector uses it for URL-level coalescing (N concurrent requests for
one URL perform one fetch); the MicroBatcher's keyed submit gives the same
fan-out contract at the content-hash level.

Contract:
- the flight runs in its own task, never under a waiter: one waiter's
  expired `Deadline` or client disconnect detaches that waiter only, and
  the flight's result still fills the cache;
- a failed flight fans its exception to every attached waiter once;
- flights are keyed per instance, so two detectors never share state.
"""

import asyncio
from typing import Awaitable, Callable, Optional


class SingleFlight:
    """In-flight call coalescing keyed by string. `on_coalesced` (optional)
    is called once per waiter that attached to an existing flight."""

    def __init__(self, on_coalesced: Optional[Callable[[], None]] = None) -> None:
        self._flights: dict[str, asyncio.Task] = {}
        self._on_coalesced = on_coalesced

    def in_flight(self, key: str) -> bool:
        task = self._flights.get(key)
        return task is not None and not task.done()

    def __len__(self) -> int:
        return len(self._flights)

    async def run(self, key: str, factory: Callable[[], Awaitable], deadline=None,
                  what: str = "shared flight"):
        """Await the (possibly shared) flight for `key`. `factory` runs only
        when no flight for `key` is in progress, and must not bake any one
        waiter's deadline into the flight: the per-waiter `deadline` is
        applied here, around a shield, so its expiry cancels only this
        waiter's wait."""
        task = self._flights.get(key)
        if task is None or task.done():
            task = asyncio.create_task(factory())
            # consume the exception even if every waiter detached first
            task.add_done_callback(self._reap(key))
            self._flights[key] = task
        elif self._on_coalesced is not None:
            self._on_coalesced()
        if deadline is None:
            return await asyncio.shield(task)
        return await deadline.wait_for(asyncio.shield(task), what)

    def _reap(self, key: str):
        def done(task: asyncio.Task) -> None:
            if self._flights.get(key) is task:
                del self._flights[key]
            if not task.cancelled():
                task.exception()  # mark retrieved; waiters re-raise their own

        return done
