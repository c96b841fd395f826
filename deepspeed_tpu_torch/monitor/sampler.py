"""Background snapshot daemon: the telemetry plane's time axis (the port
of ``deepspeed_tpu/monitor/sampler.py``).

The registry (``monitor/metrics.py``) is a point-in-time aggregate; the
sampler turns it into a series: every ``interval_s`` it appends one
registry snapshot — including the labeled ``serving/phase_ms`` /
``serving/wasted_tokens`` ledger families — to a size-rotated JSONL
sink (the ``cli health`` / ``cli top`` offline source) and to an
in-memory ring, refreshes the
flight-recorder loss gauges (``events/dropped``/``events/capacity``),
and — when an :class:`~deepspeed_tpu_torch.monitor.slo.SloEngine` is attached
— runs one burn-rate evaluation tick.

Cost discipline (the ``serving_metrics_steady`` contract): a tick is
host-side dict work only — ``registry.snapshot()``, JSON serialization,
an append — with **zero device work**, so the
daemon can run beside a hot serving loop without perturbing it. That is
why a tick deliberately does NOT call ``sample_memory_gauges`` (HBM
stats are a device query; the engines refresh those on their own step
cadence). Nothing here imports torch.

Determinism: :meth:`tick` is the whole step — the background thread
only supplies a wall-clock cadence. Tests and trace replay call
``tick()`` themselves, so SLO evaluation ticks line up reproducibly
with a replayed request trace.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class MetricsSampler:
    """Periodic registry snapshots → rotated JSONL + ring (+ SLO ticks).

    ``path=None`` keeps the series in the ring only. Rotation: when the
    sink would exceed ``max_bytes``, it shifts ``path -> path.1 -> ...
    -> path.<keep>`` (oldest dropped), so the live file always tails
    cleanly. ``start()`` runs ticks on a daemon thread; ``stop()`` joins
    it. Also a context manager."""

    def __init__(self, registry=None, *, interval_s: float = 1.0,
                 path: Optional[str] = None, max_bytes: int = 16 << 20,
                 keep: int = 2, ring: int = 512, slo=None, ctl=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if keep < 1:
            raise ValueError("keep must be >= 1")
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.interval_s = float(interval_s)
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self.slo = slo
        self.ctl = ctl
        self.ring: deque = deque(maxlen=max(1, int(ring)))
        self.seq = 0
        self._lock = threading.Lock()     # manual tick() vs daemon thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- one sampling step (the deterministic unit) ---- #

    def tick(self) -> Dict:
        """Take one snapshot: refresh recorder-loss gauges, run one SLO
        evaluation tick, snapshot the registry, append to ring + sink.
        Returns the record. Host-side only — no device work, ever."""
        with self._lock:
            self.seq += 1
            from deepspeed_tpu_torch.monitor.events import export_recorder_metrics
            export_recorder_metrics(self.registry)
            breaches: List[Dict] = []
            if self.slo is not None:
                breaches = self.slo.sample()
            actions = []
            if self.ctl is not None:
                # controller ticks AFTER the SLO evaluation (it reads the
                # burn gauges that sample() just refreshed) and BEFORE the
                # snapshot, so ctl/knob gauges in this record are current
                actions = self.ctl.tick()
            rec: Dict = {"ts": time.time(), "seq": self.seq}
            if breaches:
                # breach markers ride the snapshot line so an offline
                # tail (cli top over the JSONL) sees the firing even
                # between counter reads
                rec["slo_breaches"] = breaches
            if actions:
                rec["ctl_actions"] = [a.to_payload() for a in actions]
            rec.update(self.registry.snapshot())
            self.ring.append(rec)
            if self.path:
                self._append(rec)
            return rec

    def _append(self, rec: Dict) -> None:
        line = json.dumps(rec) + "\n"
        path = os.path.abspath(self.path)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size and size + len(line) > self.max_bytes:
            self._rotate(path)
        with open(path, "a") as f:
            f.write(line)

    def _rotate(self, path: str) -> None:
        for i in range(self.keep, 0, -1):
            src = path if i == 1 else f"{path}.{i - 1}"
            dst = f"{path}.{i}"
            try:
                os.replace(src, dst)
            except OSError:
                pass        # a missing intermediate just shortens history

    # ---- background cadence ---- #

    def start(self) -> "MetricsSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="ds-metrics-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry must not crash
                # the host process; a failing sink degrades to ring-only
                pass

    def stop(self, final_tick: bool = True,
             timeout: Optional[float] = 5.0) -> None:
        """Stop the daemon (and by default take one last snapshot so
        shutdown state lands in the series)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        if final_tick:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — shutdown must not raise
                pass

    def __enter__(self) -> "MetricsSampler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def sampler_from_config(tcfg, registry=None, events=None, ctl=None
                        ) -> Optional[MetricsSampler]:
    """Build the sampler (with an attached SLO engine when
    ``telemetry.slo`` declares objectives, and an attached
    :class:`~deepspeed_tpu_torch.monitor.controller.AdaptiveController` when
    the caller passes one) a :class:`TelemetryConfig` asks for. None
    when neither sampler nor slo is enabled. The caller owns
    ``start()``/``stop()``."""
    scfg = getattr(tcfg, "sampler", None)
    slo_cfg = getattr(tcfg, "slo", None)
    slo_on = slo_cfg is not None and slo_cfg.enabled
    if not ((scfg is not None and scfg.enabled) or slo_on):
        return None
    from deepspeed_tpu_torch.monitor.slo import slo_from_config
    slo = slo_from_config(slo_cfg, registry=registry, events=events) \
        if slo_on else None
    return MetricsSampler(
        registry, interval_s=scfg.interval_s, path=scfg.path,
        max_bytes=scfg.max_bytes, keep=scfg.keep, ring=scfg.ring,
        slo=slo, ctl=ctl)
