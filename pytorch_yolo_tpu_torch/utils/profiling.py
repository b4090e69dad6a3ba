"""Timing and throughput stats for the video loop and the server.

A copy of ``StageStats`` and ``PipelineStats`` from
``pytorch_yolo_tpu/utils/profiling.py`` (host clocks; the device work they
bracket ends in a device-to-host copy, which synchronizes).  The JAX
package's ``profile_pipeline`` / ``profile_stages`` are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class StageStats:
    name: str
    samples_ms: list[float] = dataclasses.field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.samples_ms.append(seconds * 1e3)

    def summary(self) -> dict[str, float]:
        if not self.samples_ms:
            return {"count": 0}
        a = np.asarray(self.samples_ms)
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "min_ms": float(a.min()),
            "max_ms": float(a.max()),
        }


class PipelineStats:
    """Per-stage latency percentiles + end-to-end throughput."""

    def __init__(self) -> None:
        self.stages: dict[str, StageStats] = {}
        self._t0: float | None = None
        self.items = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        s = self.stages.setdefault(name, StageStats(name))
        t = time.perf_counter()
        try:
            yield
        finally:
            s.add(time.perf_counter() - t)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def count(self, n: int = 1) -> None:
        self.items += n

    def throughput(self) -> float:
        if self._t0 is None or self.items == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self.items / dt if dt > 0 else 0.0

    def report(self) -> str:
        lines = [f"items: {self.items}  throughput: {self.throughput():.2f}/s"]
        for name, s in self.stages.items():
            m = s.summary()
            if m.get("count"):
                lines.append(
                    f"  {name:<10} mean {m['mean_ms']:7.2f} ms  p50 {m['p50_ms']:7.2f}"
                    f"  p95 {m['p95_ms']:7.2f}  n={m['count']}"
                )
        return "\n".join(lines)
