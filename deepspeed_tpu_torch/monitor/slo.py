"""Burn-rate SLO engine: config-declared objectives over sampled metrics
(the port of ``deepspeed_tpu/monitor/slo.py``).

One-shot threshold alerts ("p99 > 500 ms right now") page on noise and
sleep through slow leaks; the SRE-workbook answer — and this module — is
**multi-window burn rates**: an objective declares how much of the traffic
may be bad (``objective: 0.99`` = 1 % error budget), the engine samples
the cumulative good/bad event counts once per sampler tick, and an alert
fires only when EVERY configured window (a long one proving the budget
loss is sustained, a short one proving it is still happening) burns
budget at ``burn_rate_threshold`` or faster. A window reads zero burn
until the ring holds its full history — a fresh-from-startup engine
cannot page off a long window that has degenerated to a one-tick delta. A burn rate of 1.0 means the
error budget exactly runs out at the SLO period's end; 10 means ten times
that fast.

Two objective kinds:

- ``latency`` — a histogram plus a per-observation budget: ``bad`` =
  observations above ``threshold_ms``, counted through the registry's
  bucket ladder (:meth:`Histogram.count_le`), so "p99 TTFT ≤ 500 ms"
  becomes "≤ 1 % of TTFT observations above 500 ms".
- ``ratio`` — two counters: ``bad`` = ``metric``, total =
  ``total_metric`` (e.g. rejected / submitted requests).

Evaluation is **deterministic given the observation trace**: the engine
keeps a ring of per-tick cumulative counts, windows are measured in
ticks (never wall time), and a breach re-fires at most once per longest
window — replaying the same request trace through the same tick sequence
fires the same alerts at the same ticks (the scheduler-pin discipline,
applied to alerting). Breaches emit a typed ``slo.breach`` flight-
recorder event, increment ``slo/breaches{objective=}``, and the
per-window ``slo/burn_rate{objective=,window=}`` gauges refresh every
tick — all of which surface in ``health_summary``, ``cli top``, and
the ``/metrics`` plane.

This module is part of the telemetry exposition plane: host-side dict
arithmetic only: nothing here imports torch or touches a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_WINDOWS = (60, 5)


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declared objective (see ``telemetry.slo.objectives``)."""
    name: str
    metric: str                     # histogram (latency) / bad counter (ratio)
    kind: str = "latency"           # "latency" | "ratio"
    threshold_ms: float = 0.0       # latency: per-observation budget
    objective: float = 0.99         # good-fraction target (p99 -> 0.99)
    total_metric: str = ""          # ratio: denominator counter
    windows: Tuple[int, ...] = DEFAULT_WINDOWS   # ticks, longest first
    burn_rate_threshold: float = 1.0

    def __post_init__(self):
        if self.kind not in ("latency", "ratio"):
            raise ValueError(f"slo objective {self.name!r}: kind "
                             f"{self.kind!r} (expected latency|ratio)")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo objective {self.name!r}: objective "
                             f"{self.objective} outside (0, 1)")
        if self.kind == "latency" and self.threshold_ms <= 0:
            raise ValueError(f"slo objective {self.name!r}: latency kind "
                             "needs threshold_ms > 0")
        if self.kind == "ratio" and not self.total_metric:
            raise ValueError(f"slo objective {self.name!r}: ratio kind "
                             "needs total_metric")
        if not self.windows or any(w < 1 for w in self.windows):
            raise ValueError(f"slo objective {self.name!r}: windows must "
                             "be >= 1 tick")

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


def parse_objectives(raw: Sequence[Dict], *,
                     default_windows: Sequence[int] = DEFAULT_WINDOWS,
                     default_burn_rate_threshold: float = 1.0
                     ) -> List[SloObjective]:
    """Objective dicts (the ``telemetry.slo.objectives`` list) →
    :class:`SloObjective`, filling section-level defaults."""
    out: List[SloObjective] = []
    for i, d in enumerate(raw):
        if not isinstance(d, dict):
            raise ValueError(f"slo objective #{i} must be a dict, got "
                             f"{type(d).__name__}")
        d = dict(d)
        unknown = set(d) - {"name", "metric", "kind", "threshold_ms",
                            "objective", "total_metric", "windows",
                            "burn_rate_threshold"}
        if unknown:
            raise ValueError(f"slo objective #{i}: unknown keys "
                             f"{sorted(unknown)}")
        if "metric" not in d:
            raise ValueError(f"slo objective #{i}: missing 'metric'")
        d.setdefault("name", d["metric"])
        d.setdefault("windows", list(default_windows))
        d.setdefault("burn_rate_threshold", default_burn_rate_threshold)
        d["windows"] = tuple(int(w) for w in d["windows"])
        out.append(SloObjective(**d))
    names = [o.name for o in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo objective names in {names}")
    return out


def serving_objectives(ttft_p99_ms: Optional[float] = None,
                       tpot_p99_ms: Optional[float] = None,
                       error_rate: Optional[float] = None) -> List[Dict]:
    """The stock serving objective set (the serving front-end's
    ``--slo-ttft-ms`` etc.) as config dicts: p99 TTFT / p99 TPOT latency budgets plus an
    admission-rejection rate bound."""
    objs: List[Dict] = []
    if ttft_p99_ms:
        objs.append({"name": "ttft_p99", "metric": "serving/ttft_ms",
                     "kind": "latency", "threshold_ms": float(ttft_p99_ms),
                     "objective": 0.99})
    if tpot_p99_ms:
        objs.append({"name": "tpot_p99", "metric": "serving/tpot_ms",
                     "kind": "latency", "threshold_ms": float(tpot_p99_ms),
                     "objective": 0.99})
    if error_rate:
        objs.append({"name": "error_rate",
                     "metric": "serving/rejected_requests",
                     "kind": "ratio", "total_metric": "serving/requests",
                     "objective": 1.0 - float(error_rate)})
    return objs


class SloEngine:
    """Evaluate objectives against the live registry, once per sampler
    tick. The sampler owns the cadence (:meth:`sample` is its hook);
    tests and trace replay call :meth:`sample` directly for a fully
    deterministic tick sequence."""

    def __init__(self, objectives: Sequence[SloObjective], registry=None,
                 events=None):
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.events = events            # flight recorder or None
        self.objectives = list(objectives)
        self.tick = 0
        # per-objective ring of cumulative (total, bad) samples; one more
        # entry than the longest window so a full window has its base
        self._rings: Dict[str, List[Tuple[float, float]]] = \
            {o.name: [] for o in self.objectives}
        self._last_fire: Dict[str, int] = {}
        self._ensure_series()

    def _ensure_series(self) -> None:
        """Pre-create the slo/* families (zero-valued breach counters
        must appear in snapshots before the first breach)."""
        for o in self.objectives:
            self._breaches.labels(objective=o.name)
            for w in o.windows:
                self._burn.labels(objective=o.name, window=str(w))

    @property
    def _breaches(self):
        return self.registry.counter(
            "slo/breaches",
            "burn-rate alerts fired (every configured window burning "
            "past burn_rate_threshold; at most one firing per longest "
            "window)", labelnames=("objective",))

    @property
    def _burn(self):
        return self.registry.gauge(
            "slo/burn_rate",
            "error-budget burn rate per evaluation window (1.0 = budget "
            "gone exactly at the SLO period's end)",
            labelnames=("objective", "window"))

    # ---- one tick ---- #

    def _read(self, o: SloObjective) -> Tuple[float, float]:
        """Cumulative (total, bad) event counts for one objective, read
        atomically (one registry lock hold — a concurrent observe cannot
        tear total away from bad)."""
        if o.kind == "latency":
            fam = self.registry.histogram(o.metric)
            child = fam._only()
            with self.registry._lock:
                total = float(child.count)
                bad = total - float(child.count_le(o.threshold_ms))
            return total, bad
        bad_fam = self.registry.counter(o.metric)
        total_fam = self.registry.counter(o.total_metric)
        with self.registry._lock:
            return float(total_fam.value), float(bad_fam.value)

    def sample(self) -> List[Dict]:
        """One evaluation tick: read cumulative counts, refresh the
        burn-rate gauges, fire breaches. Returns the breach dicts fired
        THIS tick (empty most ticks). Host-side arithmetic only."""
        self.tick += 1
        fired: List[Dict] = []
        for o in self.objectives:
            ring = self._rings[o.name]
            ring.append(self._read(o))
            horizon = max(o.windows) + 1
            if len(ring) > horizon:
                del ring[:len(ring) - horizon]
            burns: Dict[int, float] = {}
            for w in o.windows:
                if len(ring) <= w:
                    # a window with incomplete history reads ZERO burn:
                    # the long window's whole job is proving the loss is
                    # SUSTAINED, and a fresh-from-startup engine whose
                    # 60-tick window degenerated to a 2-tick delta would
                    # page on the first blip instead
                    burns[w] = 0.0
                else:
                    base = ring[len(ring) - 1 - w]
                    d_total = ring[-1][0] - base[0]
                    d_bad = ring[-1][1] - base[1]
                    frac = d_bad / d_total if d_total > 0 else 0.0
                    burns[w] = frac / o.error_budget
                self._burn.labels(objective=o.name, window=str(w)) \
                    .set(burns[w])
            breach = all(b >= o.burn_rate_threshold
                         for b in burns.values())
            if not breach:
                continue
            last = self._last_fire.get(o.name)
            if last is not None and self.tick - last < max(o.windows):
                continue            # one firing per longest window
            self._last_fire[o.name] = self.tick
            self._breaches.labels(objective=o.name).inc()
            info = {"objective": o.name, "tick": self.tick,
                    "burn_rate": round(min(burns.values()), 4),
                    "threshold": o.burn_rate_threshold,
                    "windows": list(o.windows)}
            if self.events is not None:
                self.events.emit("slo.breach", objective=o.name,
                                 tick=self.tick,
                                 burn_rate=info["burn_rate"],
                                 threshold=o.burn_rate_threshold,
                                 window=max(o.windows))
            fired.append(info)
        return fired


def slo_from_config(slo_cfg, registry=None, events=None
                    ) -> Optional[SloEngine]:
    """Build the engine a ``telemetry.slo`` config block asks for (None
    when disabled or no objectives are declared)."""
    if slo_cfg is None or not slo_cfg.enabled:
        return None
    objectives = parse_objectives(
        slo_cfg.objectives, default_windows=slo_cfg.windows,
        default_burn_rate_threshold=slo_cfg.burn_rate_threshold)
    if not objectives:
        return None
    return SloEngine(objectives, registry=registry, events=events)
