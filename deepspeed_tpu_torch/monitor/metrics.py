"""Process-local metrics registry (the telemetry substrate): a copy of
``deepspeed_tpu/monitor/metrics.py`` (standard library only), with the
same series names, snapshot schema and exposition text, so a snapshot from
either package reads the same.

The serving/training stacks this reproduces are tuned almost entirely
through iteration-level stats (Orca/vLLM serving counters, PaLM-style MFU
accounting); this module is the common sink every layer writes into:

- :class:`Counter` / :class:`Gauge` / :class:`Histogram` families with
  optional label fan-out (``family.labels(op="all_reduce").inc()``),
  thread-safe behind one registry lock.
- Histograms keep **streaming quantiles** in constant memory: observations
  land in geometrically spaced buckets (ratio ``2**0.25`` ≈ ±9 % relative
  error per quantile) plus exact count/sum/min/max.
- ``snapshot()`` returns a plain JSON-able dict; ``to_prometheus()`` emits
  text exposition format; ``write_jsonl()`` appends snapshots to a file;
  ``publish()`` fans scalar series out through the existing
  ``MonitorMaster`` sinks (TensorBoard / W&B / CSV).
- Disabled mode is a per-op flag check and immediate return — **no device
  work, no ``torch.cuda.synchronize``, no allocation** — so hot paths can keep
  their instrumentation calls unconditionally.

One process-global registry (:func:`get_registry`) is shared by the
training engine, the inference engine/scheduler, the comms logger, and the
compile watchdog, so one ``snapshot()`` sees the whole system.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# ------------------------------------------------------------------ #
# histogram bucketing: geometric ladder covering 1e-9 .. ~1e12 at ratio
# 2**0.25 (~19% bucket width => quantile relative error ~9%); shared by
# every histogram so snapshots merge trivially
_BUCKET_RATIO = 2.0 ** 0.25
_BUCKET_LO = 1e-9
_N_BUCKETS = int(math.ceil(math.log(1e12 / _BUCKET_LO, _BUCKET_RATIO))) + 1
_BOUNDS: List[float] = [_BUCKET_LO * _BUCKET_RATIO ** i for i in range(_N_BUCKETS)]


def _label_key(labelnames: Tuple[str, ...], labelvalues: Tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Metric:
    """One concrete series (a family child). Not built directly — ask the
    registry for a family and (optionally) ``.labels(...)`` it."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labelnames: Tuple[str, ...] = (),
                 labelvalues: Tuple[str, ...] = ()):
        self._reg = registry
        self.name = name
        self.labelnames = labelnames
        self.labelvalues = labelvalues

    @property
    def series_name(self) -> str:
        return self.name + _label_key(self.labelnames, self.labelvalues)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg._enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: inc by negative {amount}")
        with self._reg._lock:
            self.value += amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0.0

    def set(self, value: float) -> None:
        if not self._reg._enabled:
            return
        with self._reg._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg._enabled:
            return
        with self._reg._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # sparse bucket map (most series touch a handful of buckets)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # last exemplar: (bucket idx, label dict, observed value) — the
        # OpenMetrics-style breadcrumb linking a percentile back to the
        # request that produced it (e.g. {"rid": "17"} on serving/ttft_ms)
        self._exemplar: Optional[Tuple[int, Dict[str, str], float]] = None

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        if not self._reg._enabled:
            return
        value = float(value)
        idx = bisect.bisect_left(_BOUNDS, value) if value > _BUCKET_LO else 0
        with self._reg._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if exemplar is not None:
                self._exemplar = (idx, {str(k): str(v)
                                        for k, v in exemplar.items()}, value)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= target:
                lo = _BOUNDS[idx - 1] if idx > 0 else 0.0
                hi = _BOUNDS[idx] if idx < len(_BOUNDS) else self.max
                mid = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
                # clamp into the exactly-tracked envelope
                return min(max(mid, self.min), self.max)
        return self.max

    def quantile(self, q: float) -> float:
        """Streaming quantile estimate (geometric-midpoint of the bucket
        holding the q-th observation); exact at the recorded min/max ends."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._reg._lock:
            return self._quantile_locked(q)

    def count_le(self, value: float) -> int:
        """Observations ≤ ``value``, up to bucket quantization: the cut
        rounds up to the bucket boundary ``value`` itself would land in,
        so the answer is exact whenever ``value`` is compared against the
        same ladder observations use (the SLO engine's good-event count —
        deterministic given the observation trace)."""
        cut = (bisect.bisect_left(_BOUNDS, float(value))
               if value > _BUCKET_LO else 0)
        with self._reg._lock:
            return sum(n for idx, n in self._buckets.items() if idx <= cut)

    def summary(self) -> Dict[str, float]:
        # ONE lock over the whole read: count/sum/min/max and the three
        # quantiles must come from the same instant — a concurrent observe
        # between two reads could otherwise yield a torn p50 > max snapshot
        # (the registry lock is re-entrant, so _quantile_locked nests fine)
        with self._reg._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "mean": self.sum / self.count,
                    "p50": self._quantile_locked(0.50),
                    "p90": self._quantile_locked(0.90),
                    "p99": self._quantile_locked(0.99)}


class _Family:
    """A named metric family: either a single unlabeled series (all metric
    ops proxy to it) or a label fan-out via :meth:`labels`."""

    def __init__(self, registry: "MetricsRegistry", cls, name: str,
                 help: str, labelnames: Tuple[str, ...]):
        self._reg = registry
        self._cls = cls
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], _Metric] = {}
        if not labelnames:
            self._default = cls(registry, name)
            self._children[()] = self._default
        else:
            self._default = None

    @property
    def kind(self) -> str:
        return self._cls.kind

    def labels(self, **labelvalues) -> _Metric:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, "
                             f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._reg._lock:
            child = self._children.get(key)
            if child is None:
                child = self._cls(self._reg, self.name, self.labelnames, key)
                self._children[key] = child
        return child

    def children(self) -> List[_Metric]:
        with self._reg._lock:
            return list(self._children.values())

    # unlabeled convenience proxies
    def _only(self) -> _Metric:
        if self._default is None:
            raise ValueError(f"{self.name} is labeled ({self.labelnames}); "
                             "use .labels(...)")
        return self._default

    def inc(self, amount: float = 1.0):
        self._only().inc(amount)

    def dec(self, amount: float = 1.0):
        self._only().dec(amount)

    def set(self, value: float):
        self._only().set(value)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None):
        self._only().observe(value, exemplar=exemplar)

    # single-series reads (used pervasively by tests/tools)
    @property
    def value(self):
        return self._only().value

    def summary(self):
        return self._only().summary()

    def quantile(self, q: float):
        return self._only().quantile(q)

    def count_le(self, value: float):
        return self._only().count_le(value)


class MetricsRegistry:
    """Get-or-create metric families; snapshot/export them."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._enabled = enabled

    # ---- lifecycle ---- #

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Disabled mode: every record op returns after one flag check —
        no locks taken, no allocation, and never any device call."""
        self._enabled = bool(enabled)

    def reset(self) -> None:
        """Drop every family (fresh snapshot; used between bench metrics)."""
        with self._lock:
            self._families.clear()

    # ---- family constructors (get-or-create, type-checked) ---- #

    def _family(self, cls, name: str, help: str,
                labelnames: Iterable[str]) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(self, cls, name, help, labelnames)
                self._families[name] = fam
            elif fam._cls is not cls or fam.labelnames != labelnames:
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} with labels "
                    f"{labelnames}; existing is {fam.kind} with {fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._family(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._family(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = ()) -> _Family:
        return self._family(Histogram, name, help, labelnames)

    # ---- export ---- #

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able view: ``{"counters": {series: value}, "gauges": {...},
        "histograms": {series: {count,sum,min,max,mean,p50,p90,p99}}}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for child in fam.children():
                key = child.series_name
                if fam.kind == "counter":
                    out["counters"][key] = child.value
                elif fam.kind == "gauge":
                    out["gauges"][key] = child.value
                else:
                    out["histograms"][key] = child.summary()
        return out

    def to_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition: names sanitized (``/`` → ``_``),
        label values escaped per the text format (``\\``, ``\"``,
        newline), histograms as cumulative ``_bucket{le=}``/``_sum``/
        ``_count`` series. With ``exemplars=True`` a histogram's last
        exemplar (observe's ``exemplar=`` breadcrumb, e.g. the request
        id behind the newest TTFT sample) rides its bucket line
        OpenMetrics-style (``... # {rid="17"} 123.4``) — exemplars are
        ILLEGAL in the classic 0.0.4 text format (a strict scraper
        rejects the whole body), so callers must only request them when
        the scraper negotiated OpenMetrics (see
        ``monitor.exporter.render_exposition``)."""
        lines: List[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            pname = _prom_name(fam.name)
            if fam.help:
                help_text = fam.help.replace("\\", "\\\\").replace("\n",
                                                                   "\\n")
                lines.append(f"# HELP {pname} {help_text}")
            lines.append(f"# TYPE {pname} {fam.kind}")
            for child in fam.children():
                labels = _prom_labels(child.labelnames, child.labelvalues)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{pname}{labels} {_fmt(child.value)}")
                else:
                    cum = 0
                    base = labels[1:-1] if labels else ""
                    sep = "," if base else ""
                    with self._lock:
                        buckets = sorted(child._buckets.items())
                        count, total = child.count, child.sum
                        exemplar = child._exemplar
                    for idx, n in buckets:
                        cum += n
                        le = _BOUNDS[idx] if idx < len(_BOUNDS) else math.inf
                        line = (f'{pname}_bucket{{{base}{sep}'
                                f'le="{_fmt(le)}"}} {cum}')
                        if exemplars and exemplar is not None \
                                and exemplar[0] == idx:
                            ex = ",".join(
                                f'{k}="{_escape_label(v)}"'
                                for k, v in exemplar[1].items())
                            line += f" # {{{ex}}} {_fmt(exemplar[2])}"
                        lines.append(line)
                    lines.append(f'{pname}_bucket{{{base}{sep}le="+Inf"}} '
                                 f'{count}')
                    lines.append(f"{pname}_sum{labels} {_fmt(total)}")
                    lines.append(f"{pname}_count{labels} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str, step: Optional[int] = None,
                    extra: Optional[Dict] = None) -> None:
        """Append one snapshot line to ``path`` (creating parent dirs)."""
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        if extra:
            rec.update(extra)
        rec.update(self.snapshot())
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def publish(self, monitor, step: int) -> None:
        """Fan scalar series out through a ``MonitorMaster`` (counters and
        gauges as-is; histograms as mean/p50/p99/count sub-series)."""
        if monitor is None or not getattr(monitor, "enabled", False):
            return
        snap = self.snapshot()
        events = []
        for key, v in snap["counters"].items():
            events.append((f"Telemetry/{key}", float(v), step))
        for key, v in snap["gauges"].items():
            events.append((f"Telemetry/{key}", float(v), step))
        for key, s in snap["histograms"].items():
            for stat in ("mean", "p50", "p99", "count"):
                events.append((f"Telemetry/{key}/{stat}", float(s[stat]), step))
        if events:
            monitor.write_events(events)


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in "_:"
        if i == 0 and ch.isdigit():
            ok = False
        out.append(ch if ok else "_")
    return "".join(out)


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash first)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labelnames: Tuple[str, ...],
                 labelvalues: Tuple[str, ...]) -> str:
    """Exposition-format label block (escaped — unlike the snapshot's
    ``_label_key``, which keeps raw values as stable dict keys)."""
    if not labelnames:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ------------------------------------------------------------------ #
# text-format parsing: the scrape half of the plane (a /metrics scrape
# read back) and the exposition tests' round-trip oracle


def _parse_series(line: str):
    """``name{labels} value [# exemplar]`` → (name, {label: value},
    float). Honors text-format escapes in label values; exemplar suffixes
    are tolerated and dropped. Raises ValueError on a malformed line."""
    name_end = len(line)
    labels: Dict[str, str] = {}
    rest = line
    brace = line.find("{")
    if brace != -1:
        name_end = brace
        i = brace + 1
        while True:
            while i < len(line) and line[i] in ", ":
                i += 1
            if i < len(line) and line[i] == "}":
                i += 1
                break
            eq = line.index("=", i)
            key = line[i:eq].strip()
            if line[eq + 1] != '"':
                raise ValueError(f"unquoted label value in {line!r}")
            j = eq + 2
            val: List[str] = []
            while line[j] != '"':
                ch = line[j]
                if ch == "\\":
                    nxt = line[j + 1]
                    val.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt,
                                                                    nxt))
                    j += 2
                else:
                    val.append(ch)
                    j += 1
            labels[key] = "".join(val)
            i = j + 1
        rest = line[i:]
    else:
        sp = line.index(" ")
        name_end = sp
        rest = line[sp:]
    # value, with any " # {exemplar} v" suffix dropped
    rest = rest.strip()
    if " # " in rest:
        rest = rest.split(" # ", 1)[0].strip()
    else:
        rest = rest.split()[0]
    v = math.inf if rest == "+Inf" else (-math.inf if rest == "-Inf"
                                         else float(rest))
    return line[:name_end], labels, v


def parse_prometheus_text(text: str) -> Dict[str, Dict]:
    """Parse Prometheus text exposition back into the snapshot schema:
    ``{"counters": {...}, "gauges": {...}, "histograms": {series:
    summary}}`` (the shape :meth:`MetricsRegistry.snapshot` produces).

    Histogram summaries are rebuilt from the cumulative ``_bucket``
    series with the registry's own geometric-midpoint quantile rule;
    min/max — lost by the format — degrade to the occupied bucket
    envelope's bounds. Series names keep their sanitized form
    (``serving_ttft_ms``). Untyped or
    malformed lines are skipped, not fatal (a scrape must survive a
    foreign exporter's extensions)."""
    types: Dict[str, str] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    raw_hist: Dict[str, Dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        try:
            name, labels, value = _parse_series(line)
        except (ValueError, IndexError):
            continue
        base, suffix = name, ""
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and types.get(name[:-len(suf)]) \
                    == "histogram":
                base, suffix = name[:-len(suf)], suf
                break
        if suffix:
            le = labels.pop("le", None)
            # label order preserved as exposed (the registry exposes its
            # declared order, so round-trips reproduce snapshot keys)
            series = base + _label_key(tuple(labels),
                                       tuple(labels.values()))
            h = raw_hist.setdefault(series,
                                    {"buckets": [], "sum": 0.0, "count": 0})
            if suffix == "_bucket" and le is not None:
                h["buckets"].append((math.inf if le == "+Inf"
                                     else float(le), value))
            elif suffix == "_sum":
                h["sum"] = value
            elif suffix == "_count":
                h["count"] = int(value)
            continue
        series = name + _label_key(tuple(labels), tuple(labels.values()))
        if types.get(name) == "counter":
            counters[series] = value
        else:
            gauges[series] = value
    return {"counters": counters, "gauges": gauges,
            "histograms": {k: _hist_from_buckets(h)
                           for k, h in raw_hist.items()}}


def _hist_from_buckets(h: Dict) -> Dict[str, float]:
    """Histogram summary from parsed cumulative buckets (same
    geometric-midpoint quantile rule the live registry uses, with the
    bucket envelope standing in for the lost exact min/max)."""
    count, total = int(h["count"]), float(h["sum"])
    if count == 0:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
    buckets = sorted((le, cum) for le, cum in h["buckets"]
                     if le != math.inf)
    # per-bucket (lo, hi, n) deltas from the cumulative series. The
    # exposition is SPARSE (only occupied buckets appear), so a bucket's
    # true lower bound may sit between the previous exposed ``le`` and
    # this one: when the bound matches the registry's shared geometric
    # ladder, snap ``lo`` to the ladder's adjacent bound (a foreign
    # exporter's arbitrary bounds fall back to the exposed neighbor)
    deltas: List[Tuple[float, float, int]] = []
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        n = int(cum) - prev_cum
        if n > 0:
            lo = prev_le
            i = bisect.bisect_left(_BOUNDS, le * (1 - 1e-9))
            if i < len(_BOUNDS) and abs(_BOUNDS[i] - le) <= 1e-9 * le:
                lo = max(lo, _BOUNDS[i - 1] if i > 0 else 0.0)
            deltas.append((lo, le, n))
        prev_le, prev_cum = le, int(cum)
    if prev_cum < count:                      # the +Inf overflow bucket
        deltas.append((prev_le, prev_le if prev_le > 0 else 1.0,
                       count - prev_cum))
    lo_env = deltas[0][0] if deltas else 0.0
    hi_env = deltas[-1][1] if deltas else 0.0

    def q(frac: float) -> float:
        target = frac * count
        seen = 0
        for lo, hi, n in deltas:
            seen += n
            if seen >= target:
                mid = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
                return min(max(mid, lo_env), hi_env)
        return hi_env

    return {"count": count, "sum": total, "min": lo_env, "max": hi_env,
            "mean": total / count, "p50": q(0.50), "p90": q(0.90),
            "p99": q(0.99)}


# ------------------------------------------------------------------ #
# snapshot schema validation (the CI smoke test's contract)

SNAPSHOT_SECTIONS = ("counters", "gauges", "histograms")
_HIST_KEYS = {"count", "sum", "min", "max", "mean", "p50", "p90", "p99"}


def validate_snapshot(snap: Dict) -> None:
    """Raise ``ValueError`` unless ``snap`` is a structurally valid
    registry snapshot (the three sections, numeric scalars, complete
    histogram summaries)."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be a dict, got {type(snap).__name__}")
    for section in SNAPSHOT_SECTIONS:
        if section not in snap:
            raise ValueError(f"snapshot missing section {section!r}")
        if not isinstance(snap[section], dict):
            raise ValueError(f"snapshot[{section!r}] must be a dict")
    for sec in ("counters", "gauges"):
        for k, v in snap[sec].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"{sec}[{k!r}] is not numeric: {v!r}")
    for k, s in snap["histograms"].items():
        if not isinstance(s, dict) or not _HIST_KEYS.issubset(s):
            raise ValueError(f"histograms[{k!r}] missing keys "
                             f"{_HIST_KEYS - set(s or ())}")


# ------------------------------------------------------------------ #
# process-global registry

_global_registry: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _global_registry
    if _global_registry is None:
        with _global_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry
