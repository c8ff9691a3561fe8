"""Fault tolerance: failure detection, straggler mitigation, restart policy.

On a real multi-pod fleet the signals come from the coordination service
(missed heartbeats, slow all-reduce participants); here the monitor consumes
per-host step-duration reports — injected by tests/examples — and the driver
(launch/train.py) wires detection → checkpoint-restore → continue.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 50
    max_restarts: int = 3
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 2.5  # step > factor × rolling median ⇒ straggler
    straggler_window: int = 32
    straggler_patience: int = 3  # consecutive flags before action


class HeartbeatMonitor:
    """Tracks per-host liveness from heartbeat timestamps."""

    def __init__(self, hosts: list[str], timeout_s: float):
        self.timeout_s = timeout_s
        self.last_seen = {h: time.monotonic() for h in hosts}

    def beat(self, host: str, now: float | None = None):
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[str]:
        t = time.monotonic() if now is None else now
        return [h for h, seen in self.last_seen.items() if t - seen > self.timeout_s]


class StragglerDetector:
    """Rolling-median outlier filter over per-host step durations.

    A host whose step time exceeds ``factor × median`` for ``patience``
    consecutive steps is flagged for mitigation (preemptive restart /
    traffic re-route — the driver decides)."""

    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.history: dict[str, deque] = {}
        self.flags: dict[str, int] = {}

    def report(self, host: str, step_time_s: float) -> bool:
        """Record a measurement.  Returns True if host is now a confirmed
        straggler."""
        h = self.history.setdefault(host, deque(maxlen=self.cfg.straggler_window))
        h.append(step_time_s)
        med = self._global_median()
        if med > 0 and step_time_s > self.cfg.straggler_factor * med:
            self.flags[host] = self.flags.get(host, 0) + 1
        else:
            self.flags[host] = 0
        return self.flags.get(host, 0) >= self.cfg.straggler_patience

    def _global_median(self) -> float:
        all_t = sorted(t for h in self.history.values() for t in h)
        if not all_t:
            return 0.0
        return all_t[len(all_t) // 2]


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-restart supervision with exponential backoff."""

    max_restarts: int = 3
    backoff_s: float = 1.0
    restarts: int = 0

    def on_failure(self, exc: BaseException) -> float:
        """Returns backoff seconds before retry; raises if budget exhausted."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted after {self.restarts - 1} restarts"
            ) from exc
        return self.backoff_s * (2 ** (self.restarts - 1))


class FaultInjector:
    """Deterministic fault injection for tests/examples: raises at the
    configured steps (simulating preemption / device loss)."""

    def __init__(self, fail_at_steps: set[int]):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")
