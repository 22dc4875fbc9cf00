"""Host-side data loading utilities.

TPU-native equivalents of the reference loader stack (SURVEY §2.7):

- :class:`PrefetchLoader` — background-thread prefetch with an operation
  watchdog (cached_replay_dataloader.py prefetch thread + watchdog.py hung-op
  detection, folded into one class).
- :class:`JointLoader` — interleaves several loaders by ratio
  (joint_dataloader.py IterativeJointDataLoader).
- :class:`CachedReplayLoader` — decode once, replay/augment k times
  (cached_replay_dataloader.py duplicate_batches).

A verbatim copy of ``chronoedit_tpu/data/loaders.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator


class PrefetchLoader:
    """Wrap an iterable with an N-deep background prefetch queue.

    ``watchdog_s`` logs a warning when a single upstream ``next()`` exceeds
    the budget (the reference warns at 600 s, watchdog.py:27-80)."""

    def __init__(self, source: Iterable, depth: int = 2,
                 watchdog_s: float = 600.0, warn_fn: Callable[[str], None] = print):
        self.source = source
        self.depth = depth
        self.watchdog_s = watchdog_s
        self.warn_fn = warn_fn

    def __iter__(self) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: list[BaseException] = []

        def worker():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            t0 = time.monotonic()
            while True:
                try:
                    item = q.get(timeout=min(self.watchdog_s, 60.0))
                    break
                except queue.Empty:
                    waited = time.monotonic() - t0
                    if waited >= self.watchdog_s:
                        self.warn_fn(
                            f"[loader watchdog] next() stuck for {waited:.0f}s")
                        t0 = time.monotonic()  # keep warning periodically
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


class JointLoader:
    """Interleave loaders by integer ratios, e.g. image:video = 4:1
    (IterativeJointDataLoader, joint_dataloader.py:25-139)."""

    def __init__(self, loaders: dict[str, tuple[Iterable, int]]):
        self.loaders = loaders

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        iters = {k: iter(src) for k, (src, _) in self.loaders.items()}
        schedule: list[str] = []
        for name, (_, ratio) in self.loaders.items():
            schedule.extend([name] * ratio)
        while True:
            for name in schedule:
                yield name, next(iters[name])


class CachedReplayLoader:
    """Yield each upstream batch ``replays`` times, optionally re-augmented
    (one expensive decode feeding several train steps,
    cached_replay_dataloader.py:28-180)."""

    def __init__(self, source: Iterable, replays: int = 2,
                 augment: Callable[[Any, int], Any] | None = None):
        self.source = source
        self.replays = replays
        self.augment = augment

    def __iter__(self) -> Iterator[Any]:
        for batch in self.source:
            for i in range(self.replays):
                yield self.augment(batch, i) if self.augment else batch
