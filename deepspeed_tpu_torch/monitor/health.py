"""Training health observatory (the port of
``deepspeed_tpu/monitor/health.py``): sentinels, anomaly detectors, memory
telemetry, and the ``health`` screen of ``python -m deepspeed_tpu_torch.cli``.

- **Numerics sentinels** (:func:`compute_sentinels`): a compact per-step
  summary (non-finite grad/param element counts, pre-clip global grad norm,
  param/update norms, update/param ratio, per-layer-group norm buckets) as
  ONE small fp32 tensor on the device. The training engine gathers its parts
  inside the update it already runs (``runtime/engine.py``): the bucket norms
  reuse the per-leaf norms of the pre-clip global norm, and the update norm
  is taken from ``new - old`` of each leaf against a scratch copy, because
  the port's optimizers write the masters in place and return no update
  vector. The vector rides the one host read a telemetry-on step already
  makes.

- **Host-side anomaly detectors** (:class:`HealthMonitor`) over a ring
  buffer of :class:`StepHealth` records — loss spike (EWMA robust
  z-score), grad-norm explosion, plateau, sustained fp16 overflow skips,
  non-finite numerics, a data-stall detector comparing host wait time
  against the bracketed device step time, and consecutive checkpoint-save
  failures. Each firing increments a ``health/anomalies{type=}`` counter
  and, per the configured action, emits a rate-limited warning and/or a
  **debug bundle** (telemetry snapshot + chrome trace + last-K step
  records + the flight recorder's tail) to disk.

- **Memory telemetry** (:func:`sample_memory_gauges`) — per-device
  live/peak/limit/headroom gauges from the accelerator's memory report plus
  host RSS.

- **The ``health`` CLI** (:func:`health_cli`) — tails the JSONL telemetry
  sink and renders a one-screen status table. The text and the
  ``--json`` summary are the JAX package's, key for key.

Only :func:`compute_sentinels` and :func:`bucket_norms` touch tensors;
everything else is host-side Python.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.utils.logging import logger

# ------------------------------------------------------------------ #
# sentinels

#: fixed head of the sentinel vector; per-layer-group grad-norm buckets
#: follow (one slot per bucket name).
SENTINEL_FIELDS = ("nonfinite_grads", "nonfinite_params", "grad_norm",
                   "param_norm", "update_norm", "update_ratio")


def make_bucket_assignment(names: Iterable[str], max_buckets: int
                           ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Map each port leaf (``names`` order) to a layer-group bucket.

    Groups are the top-level keys of the JAX package's parameter tree in
    the order its flatten meets them (the port's per-layer leaves grouped
    into the JAX leaves they form, ``runtime/utils.jax_leaves``), so the
    bucket names, and the norms summed into them, are the JAX package's.
    When there are more groups than ``max_buckets``, the tail collapses
    into an ``"other"`` bucket."""
    from deepspeed_tpu_torch.runtime.utils import jax_leaves
    names = list(names)
    heads = []
    for path in jax_leaves(names):
        if path[0] not in heads:
            heads.append(path[0])
    if max_buckets < 1:
        max_buckets = 1
    if len(heads) > max_buckets:
        bucket_names = tuple(heads[:max_buckets - 1]) + ("other",)
        index = {h: min(i, max_buckets - 1) for i, h in enumerate(heads)}
    else:
        bucket_names = tuple(heads)
        index = {h: i for i, h in enumerate(heads)}
    assignment = tuple(index[n.split(".", 1)[0]] for n in names)
    return assignment, bucket_names


def bucket_norms(leaf_norms: Sequence, assignment: Sequence[int], n_buckets: int):
    """Per-bucket norms from per-leaf norms (0-dim fp32 tensors, one a leaf
    in ``assignment`` order): ``sqrt(sum ||g||^2)`` over each bucket's
    leaves, as a ``[n_buckets]`` fp32 tensor on the norms' device."""
    import torch
    if not n_buckets:
        return torch.zeros((0,), dtype=torch.float32)
    dev = leaf_norms[0].device if len(leaf_norms) else None
    sq = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(n_buckets)]
    for nrm, b in zip(leaf_norms, assignment):
        sq[b] = sq[b] + torch.square(nrm.float())
    return torch.sqrt(torch.stack(sq))


def compute_sentinels(nonfinite_grads, nonfinite_params, grad_norm, param_norm,
                      update_norm, buckets):
    """The per-step numerics summary as one fp32 tensor of
    ``len(SENTINEL_FIELDS) + len(buckets)`` entries (the layout of the JAX
    package's ``compute_sentinels``), from its parts, each a 0-dim tensor
    on the device (no host sync):

    - non-finite element counts over the unscaled, pre-clip grads and the
      post-update params (the masters, or the fp32 params);
    - the pre-clip global grad norm (the one the clip used, never
      recomputed);
    - the param norm, the applied-update norm (zero on an fp16 skip step)
      and their ratio ``update / (param + 1e-12)``;
    - the per-layer-group grad-norm buckets (:func:`bucket_norms`)."""
    import torch
    f = lambda v: torch.as_tensor(v, dtype=torch.float32).reshape(()).to(buckets.device)
    un, pn = f(update_norm), f(param_norm)
    base = torch.stack([f(nonfinite_grads), f(nonfinite_params), f(grad_norm), pn, un,
                        un / (pn + 1e-12)])
    return torch.cat([base, buckets.float()])


def sentinel_to_dict(vec, names: Sequence[str]) -> Dict[str, Any]:
    """Host-side view of a sentinel vector: named scalars + a
    ``bucket_norms`` sub-dict."""
    import numpy as np
    v = np.asarray(vec, np.float32)
    out: Dict[str, Any] = {f: float(v[i]) for i, f in enumerate(SENTINEL_FIELDS)}
    off = len(SENTINEL_FIELDS)
    out["bucket_norms"] = {n: float(v[off + i]) for i, n in enumerate(names)
                           if off + i < v.size}
    return out


# ------------------------------------------------------------------ #
# memory telemetry


def host_rss_bytes() -> int:
    """Resident set size of this process (0 when unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    try:
        import resource
        # ru_maxrss is the PEAK rss — a usable fallback; linux reports
        # kilobytes, macOS reports bytes
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except Exception:
        return 0


def sample_memory_gauges(registry=None, accelerator=None) -> Dict[str, Any]:
    """Refresh the ``mem/*`` gauges from ``accelerator.memory_report()``
    (device live/peak/limit/headroom bytes per device) plus host RSS;
    returns the sampled report. A device without memory stats (the CPU)
    contributes an empty entry and no gauges. ``accelerator`` defaults to
    the CUDA one when a device is there, else the CPU's."""
    if registry is None:
        from deepspeed_tpu_torch.monitor.metrics import get_registry
        registry = get_registry()
    report: Dict[str, Any] = {"devices": {}, "host_rss_bytes": host_rss_bytes()}
    try:
        if accelerator is None:
            from deepspeed_tpu_torch.accelerator.real_accelerator import default_accelerator
            accelerator = default_accelerator()
        devmap = accelerator.memory_report()
    except Exception:
        devmap = {}
    report["devices"] = devmap
    in_use = registry.gauge("mem/hbm_bytes_in_use",
                            "live HBM bytes per device", labelnames=("device",))
    peak = registry.gauge("mem/hbm_peak_bytes",
                          "peak HBM bytes per device", labelnames=("device",))
    limit = registry.gauge("mem/hbm_bytes_limit",
                           "allocator byte limit per device",
                           labelnames=("device",))
    headroom = registry.gauge("mem/hbm_headroom_bytes",
                              "limit - live bytes per device",
                              labelnames=("device",))
    for name, st in devmap.items():
        if not st:
            continue
        in_use.labels(device=name).set(st.get("bytes_in_use", 0))
        peak.labels(device=name).set(st.get("peak_bytes_in_use", 0))
        limit.labels(device=name).set(st.get("bytes_limit", 0))
        headroom.labels(device=name).set(st.get("headroom_bytes", 0))
    registry.gauge("mem/host_rss_bytes",
                   "host resident set size").set(report["host_rss_bytes"])
    return report


# ------------------------------------------------------------------ #
# host-side records + detectors


@dataclasses.dataclass
class StepHealth:
    """One step's host-side health record (everything a detector reads).
    ``grad_norm=None`` means "not measured" (skips the norm-based
    detectors) — a non-finite FLOAT means the grads really blew up."""
    step: int
    loss: float
    grad_norm: Optional[float] = None
    nonfinite_grads: float = 0.0
    nonfinite_params: float = 0.0
    update_ratio: float = 0.0
    skipped: bool = False               # fp16 overflow skip-update step
    loss_scale: float = 1.0
    step_time_s: float = 0.0            # bracketed compiled-step wall time
    wait_time_s: float = 0.0            # host time since the previous step
    bucket_norms: Tuple[float, ...] = ()


class HealthMonitor:
    """Ring buffer of :class:`StepHealth` + the anomaly detectors.

    Detector catalogue (all thresholds on :class:`HealthConfig`):

    - ``nonfinite`` — any non-finite grad/param element, loss, or grad
      norm on a step that was NOT an fp16 skip (skipped steps are the
      loss scaler doing its job; persistence is ``overflow``'s domain).
    - ``loss_spike`` — robust z-score of the loss against an EWMA
      mean/variance exceeds ``loss_spike_zscore`` (after warmup).
    - ``grad_explosion`` — grad norm > ``grad_norm_factor`` × its EWMA.
    - ``plateau`` — no relative loss improvement for ``plateau_steps``.
    - ``overflow`` — ``overflow_window`` CONSECUTIVE fp16 skip steps
      (re-fires every further window while the run stays stuck).
    - ``data_stall`` — wait/(wait+step) above ``data_stall_fraction`` for
      ``data_stall_steps`` consecutive steps: the input pipeline, not the
      device, is the bottleneck.
    - ``ckpt_failure`` — ``ckpt_failure_consecutive`` checkpoint saves in a
      row failed after exhausting their retry budget (flaky/full storage):
      the run is training fine but silently losing its recovery points.
      Fed by :meth:`observe_checkpoint`, not :meth:`observe_step`.

    Every firing increments ``health/anomalies{type=}``; ``action``
    escalates: ``record`` (counters only) → ``warn`` (+ rate-limited log,
    at most one per detector per ``window`` steps) → ``dump`` (+ a debug
    bundle via :meth:`dump_bundle`, at most ``dump_limit`` per run)."""

    DETECTORS = ("nonfinite", "loss_spike", "grad_explosion", "plateau",
                 "overflow", "data_stall", "ckpt_failure")
    ACTIONS = ("record", "warn", "dump")

    def __init__(self, config, registry=None, bucket_names: Sequence[str] = (),
                 snapshot_fn: Optional[Callable[[], Dict]] = None,
                 trace_export_fn: Optional[Callable[[str], str]] = None):
        if config.action not in self.ACTIONS:
            raise ValueError(f"telemetry.health.action={config.action!r} "
                             f"(expected one of {self.ACTIONS})")
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.cfg = config
        self.registry = registry
        self.bucket_names = tuple(bucket_names)
        self._snapshot_fn = snapshot_fn
        self._trace_export_fn = trace_export_fn
        self.ring: deque = deque(maxlen=max(config.window,
                                            config.keep_last_steps))
        self._n = 0
        self._ewma_loss: Optional[float] = None
        self._ewvar_loss = 0.0
        self._ewma_gnorm: Optional[float] = None
        self._best_loss = math.inf
        self._since_best = 0
        self._consec_skips = 0
        self._consec_stall = 0
        self._consec_ckpt_failures = 0
        self._ckpt_lock = threading.Lock()
        self._wait_total = 0.0
        self._busy_total = 0.0
        self._fired_counts: Dict[str, int] = {}
        self._last_warn: Dict[str, int] = {}
        self._last_dump_step: Optional[int] = None
        self._dumps = 0
        self.ensure()

    # families resolved per access (same pattern as ServingTelemetry) so a
    # registry reset between bench metrics can't orphan them

    @property
    def anomalies(self):
        return self.registry.counter(
            "health/anomalies", "detector firings by type",
            labelnames=("type",))

    @property
    def loss_ewma_gauge(self):
        return self.registry.gauge("health/loss_ewma",
                                   "EWMA of the training loss")

    @property
    def grad_norm_gauge(self):
        return self.registry.gauge("health/grad_norm",
                                   "last step's pre-clip global grad norm")

    @property
    def consec_skips_gauge(self):
        return self.registry.gauge("health/consecutive_skips",
                                   "consecutive fp16 overflow-skipped steps")

    def ensure(self) -> None:
        """Pre-create every series (incl. a zero child per detector type)
        so a clean run's snapshot shows explicit zeros, not absences."""
        for t in self.DETECTORS:
            self.anomalies.labels(type=t)
        self.loss_ewma_gauge, self.grad_norm_gauge
        self.consec_skips_gauge

    def set_bucket_names(self, names: Sequence[str]) -> None:
        """Called by the engine once the sentinel bucket layout is known
        (at trace time of the first compiled step)."""
        self.bucket_names = tuple(names)

    # ---- the per-step entry point ---- #

    def observe_step(self, rec: StepHealth) -> List[str]:
        """Feed one step record through every detector; returns the list
        of detectors that fired (and applies the configured action)."""
        cfg = self.cfg
        self._n += 1
        self.ring.append(rec)
        fired: List[str] = []
        loss_ok = math.isfinite(rec.loss)
        # grad_norm None = "not measured" (norm detectors skip); only a
        # non-finite MEASURED norm is an anomaly
        gn_known = rec.grad_norm is not None
        gn_ok = gn_known and math.isfinite(rec.grad_norm)

        # nonfinite: immediate, but NOT on fp16 skip steps (the scaler
        # already handled those; sustained skips are `overflow`)
        if not rec.skipped and (rec.nonfinite_grads > 0
                                or rec.nonfinite_params > 0
                                or not loss_ok or (gn_known and not gn_ok)):
            fired.append("nonfinite")

        # loss spike: robust z-score against EWMA mean/var
        if loss_ok:
            if self._ewma_loss is None:
                self._ewma_loss = rec.loss
            else:
                sd = math.sqrt(max(self._ewvar_loss, 0.0))
                denom = sd + 1e-8 + 1e-3 * abs(self._ewma_loss)
                if (self._n > cfg.warmup_steps
                        and (rec.loss - self._ewma_loss) / denom
                        > cfg.loss_spike_zscore):
                    fired.append("loss_spike")
                a = cfg.loss_ewma_alpha
                delta = rec.loss - self._ewma_loss
                self._ewma_loss += a * delta
                self._ewvar_loss = (1 - a) * (self._ewvar_loss + a * delta * delta)
            self.loss_ewma_gauge.set(self._ewma_loss)

        # grad-norm explosion
        if gn_ok:
            if (self._ewma_gnorm is not None and self._n > cfg.warmup_steps
                    and rec.grad_norm > cfg.grad_norm_factor
                    * max(self._ewma_gnorm, 1e-12)):
                fired.append("grad_explosion")
            a = cfg.loss_ewma_alpha
            self._ewma_gnorm = (rec.grad_norm if self._ewma_gnorm is None
                                else self._ewma_gnorm
                                + a * (rec.grad_norm - self._ewma_gnorm))
            self.grad_norm_gauge.set(rec.grad_norm)

        # plateau
        if cfg.plateau_steps and loss_ok:
            tol = cfg.plateau_rel_improvement * max(abs(self._best_loss), 1e-8)
            if not math.isfinite(self._best_loss) \
                    or rec.loss < self._best_loss - tol:
                self._best_loss = rec.loss
                self._since_best = 0
            else:
                self._since_best += 1
                if self._since_best >= cfg.plateau_steps:
                    fired.append("plateau")
                    self._since_best = 0

        # sustained fp16 overflow
        self._consec_skips = self._consec_skips + 1 if rec.skipped else 0
        self.consec_skips_gauge.set(self._consec_skips)
        if (cfg.overflow_window and self._consec_skips
                and self._consec_skips % cfg.overflow_window == 0):
            fired.append("overflow")

        # data stall (the published cumulative gauge is the engine's
        # train/data_stall_fraction — ONE series; these totals only feed
        # report() so a standalone monitor still summarizes)
        self._wait_total += max(rec.wait_time_s, 0.0)
        self._busy_total += max(rec.step_time_s, 0.0)
        per_step = rec.wait_time_s / max(rec.wait_time_s + rec.step_time_s,
                                         1e-9)
        self._consec_stall = (self._consec_stall + 1
                              if per_step > cfg.data_stall_fraction else 0)
        if (cfg.data_stall_steps and self._consec_stall
                and self._consec_stall % cfg.data_stall_steps == 0):
            fired.append("data_stall")

        if fired:
            self._act(fired, rec)
        return fired

    def observe_checkpoint(self, success: bool, step: Optional[int] = None
                           ) -> List[str]:
        """Checkpoint-writer result feed (sync saves and the async writer's
        completion callback both land here). Fires ``ckpt_failure`` after
        ``ckpt_failure_consecutive`` failures in a row, then resets so a
        persistently-broken store re-fires once per further run of K.

        Serialized under a lock: sync saves land here on the training thread
        while async results arrive on the writer thread, and the consecutive
        counter must not lose an increment or a reset between them."""
        with self._ckpt_lock:
            if success:
                self._consec_ckpt_failures = 0
                return []
            self._consec_ckpt_failures += 1
            k = self.cfg.ckpt_failure_consecutive
            if not k or self._consec_ckpt_failures < k:
                return []
            self._consec_ckpt_failures = 0
            self._fired_counts["ckpt_failure"] = \
                self._fired_counts.get("ckpt_failure", 0) + 1
        self.anomalies.labels(type="ckpt_failure").inc()
        if self.cfg.action != "record":
            at = self._n if step is None else int(step)
            if at - self._last_warn.get("ckpt_failure", -10**12) >= self.cfg.window:
                self._last_warn["ckpt_failure"] = at
                logger.warning(
                    f"health: ckpt_failure — {k} consecutive checkpoint "
                    f"saves failed (storage flaky or full); the run keeps "
                    f"training but is NOT gaining recovery points. Next "
                    f"warning in {self.cfg.window} steps.")
        return ["ckpt_failure"]

    # ---- actions ---- #

    def _act(self, fired: List[str], rec: StepHealth) -> None:
        cfg = self.cfg
        for t in fired:
            self._fired_counts[t] = self._fired_counts.get(t, 0) + 1
            self.anomalies.labels(type=t).inc()
        if cfg.action == "record":
            return
        to_warn = [t for t in fired
                   if rec.step - self._last_warn.get(t, -10**12) >= cfg.window]
        if to_warn:
            for t in to_warn:
                self._last_warn[t] = rec.step
            gn_s = "n/a" if rec.grad_norm is None else f"{rec.grad_norm:.4g}"
            logger.warning(
                f"health: {'+'.join(to_warn)} at step {rec.step} "
                f"(loss={rec.loss:.4g}, grad_norm={gn_s}, "
                f"nonfinite_grads={rec.nonfinite_grads:.0f}, "
                f"skipped={rec.skipped}, loss_scale={rec.loss_scale:.4g}, "
                f"wait/step={rec.wait_time_s * 1e3:.1f}/"
                f"{rec.step_time_s * 1e3:.1f}ms). "
                f"Next warning for these detectors in {cfg.window} steps.")
        if cfg.action == "dump" and self._dumps < cfg.dump_limit and \
                (self._last_dump_step is None
                 or rec.step - self._last_dump_step >= cfg.window):
            try:
                self.dump_bundle(fired, rec)
            except Exception as e:  # diagnostics must never kill the step
                logger.warning(f"health: debug-bundle dump failed: {e}")

    def dump_bundle(self, fired: Sequence[str], rec: StepHealth) -> str:
        """Write a debug bundle directory: ``report.json`` (what fired and
        the triggering record), ``steps.jsonl`` (last-K ring records),
        ``telemetry.json`` (full registry snapshot) and ``trace.json``
        (chrome trace) when the engine provided exporters. Returns the
        bundle path."""
        path = os.path.join(self.cfg.dump_dir,
                            f"step{rec.step:08d}_{'+'.join(fired)}")
        os.makedirs(path, exist_ok=True)
        report = {"ts": time.time(), "step": rec.step, "fired": list(fired),
                  "record": dataclasses.asdict(rec),
                  "anomaly_counts": dict(self._fired_counts),
                  "bucket_names": list(self.bucket_names),
                  "config": _config_dict(self.cfg)}
        with open(os.path.join(path, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        with open(os.path.join(path, "steps.jsonl"), "w") as f:
            for r in list(self.ring)[-self.cfg.keep_last_steps:]:
                f.write(json.dumps(dataclasses.asdict(r)) + "\n")
        if self._snapshot_fn is not None:
            try:
                with open(os.path.join(path, "telemetry.json"), "w") as f:
                    json.dump(self._snapshot_fn(), f, indent=2)
            except Exception as e:
                logger.warning(f"health: telemetry snapshot in bundle failed: {e}")
        if self._trace_export_fn is not None:
            try:
                self._trace_export_fn(os.path.join(path, "trace.json"))
            except Exception as e:
                logger.warning(f"health: trace export in bundle failed: {e}")
        # the flight-recorder tail (events.jsonl): the causal timeline —
        # checkpoint phases, fp16 skips, serving lifecycle — leading into
        # the anomaly (present when telemetry.events is on)
        from deepspeed_tpu_torch.monitor.events import dump_events_jsonl
        dump_events_jsonl(path)
        self._dumps += 1
        self._last_dump_step = rec.step
        logger.warning(f"health: debug bundle written to {path} "
                       f"({self._dumps}/{self.cfg.dump_limit})")
        return path

    # ---- reporting ---- #

    def report(self) -> Dict[str, Any]:
        """One-call health summary: detector counts, EWMAs, stall
        fraction, the last step record, and a fresh memory sample."""
        tot = self._wait_total + self._busy_total
        return {
            "enabled": True,
            "steps": self._n,
            "anomalies": {t: self._fired_counts.get(t, 0)
                          for t in self.DETECTORS},
            "ewma_loss": self._ewma_loss,
            "ewma_grad_norm": self._ewma_gnorm,
            "consecutive_skips": self._consec_skips,
            "data_stall_fraction": (self._wait_total / tot) if tot > 0 else 0.0,
            "last": dataclasses.asdict(self.ring[-1]) if self.ring else None,
            "bucket_names": list(self.bucket_names),
            "dumps": self._dumps,
            "memory": sample_memory_gauges(self.registry),
        }


def _config_dict(cfg) -> Dict:
    if dataclasses.is_dataclass(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if isinstance(getattr(cfg, f.name), (int, float, str, bool, type(None)))}
    for attr in ("model_dump", "dict"):
        fn = getattr(cfg, attr, None)
        if callable(fn):
            try:
                return {k: v for k, v in fn().items()
                        if isinstance(v, (int, float, str, bool, type(None)))}
            except Exception:
                pass
    return {}


# ------------------------------------------------------------------ #
# the `health` CLI: tail the JSONL sink, render one screen


def read_last_snapshots(path: str, n: int = 2,
                        tail_bytes: int = 1 << 19) -> List[Dict]:
    """Last ``n`` parseable JSONL records of ``path`` (bounded tail read,
    so multi-GB sinks tail in O(tail_bytes)). Empty list when the file is
    missing or holds no valid records."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - tail_bytes))
            chunk = f.read()
    except OSError:
        return []
    if size > tail_bytes:
        # drop the (possibly mid-record) first line of the tail window
        chunk = chunk.split(b"\n", 1)[-1]
    recs: List[Dict] = []
    for line in chunk.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            recs.append(rec)
    return recs[-n:]


def labeled_series(section: Dict, name: str) -> Dict[str, float]:
    """``{label_value: value}`` for every ``name{k="v"}`` series in a
    snapshot section (shared by the CLI renderer and bench.py's blob)."""
    out = {}
    prefix = name + "{"
    for k, v in section.items():
        if k.startswith(prefix) and k.endswith("}"):
            inner = k[len(prefix):-1]
            label = inner.split("=", 1)[-1].strip('"') if "=" in inner else inner
            out[label] = v
    return out


def multilabel_series(section: Dict, name: str):
    """``[({label: value}, metric_value)]`` for every ``name{k="v",...}``
    series — the multi-label sibling of :func:`labeled_series` (e.g.
    ``slo/burn_rate{objective=,window=}``). Values containing commas or
    quotes are beyond this tail parser and are skipped, matching the
    snapshot keys the registry actually writes."""
    out = []
    prefix = name + "{"
    for k, v in section.items():
        if not (k.startswith(prefix) and k.endswith("}")):
            continue
        labels = {}
        ok = True
        for part in k[len(prefix):-1].split(","):
            kk, eq, vv = part.partition("=")
            if not eq:
                ok = False
                break
            labels[kk.strip()] = vv.strip().strip('"')
        if ok:
            out.append((labels, v))
    return out


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _fmt(v: Optional[float], spec: str = ".3g", missing: str = "-") -> str:
    if v is None:
        return missing
    try:
        return format(float(v), spec)
    except (TypeError, ValueError):
        return missing


def render_health_table(rec: Dict, prev: Optional[Dict] = None) -> str:
    """One-screen status table from a telemetry JSONL record (a registry
    snapshot line). ``prev`` (the previous record) sharpens the step-rate
    and loss-trend readouts. Thin wrapper: the metric-key extraction lives
    ONCE in :func:`health_summary`; this renders its dict (so the table
    and ``cli health --json`` can never drift apart)."""
    return render_summary_table(health_summary(rec, prev))


def render_summary_table(s: Dict[str, Any]) -> str:
    """Render a :func:`health_summary` dict as the one-screen table.
    Sections absent from the summary are omitted."""
    lines: List[str] = []
    step = s.get("step")
    ts = s.get("ts")
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)) if ts else ""
    lines.append(f"deepspeed_tpu health — step {step if step is not None else '?'}"
                 f"  {when}".rstrip())
    lines.append("-" * 64)

    # ---- train throughput ---- #
    train = s.get("train")
    if train is not None:
        st = train.get("step_time_ms")
        rate = train.get("steps_per_sec")
        if rate is None and st and st.get("mean"):
            rate = 1000.0 / st["mean"]
        parts = [f"steps {train['steps']}"]
        if st:
            parts.append(f"step {st['mean']:.1f}ms (p50 {st['p50']:.1f}, "
                         f"p99 {st['p99']:.1f})")
        if rate:
            parts.append(f"rate {rate:.2f}/s")
        if "tokens_per_sec" in train:
            parts.append(f"tok/s {train['tokens_per_sec']:,.0f}")
        if "mfu" in train:
            parts.append(f"MFU {train['mfu']:.3f}")
        lines.append("train    " + "   ".join(parts))

    # ---- loss / grad ---- #
    loss = s.get("loss")
    if loss is not None:
        parts = []
        if "loss" in loss:
            trend = ""
            if "delta" in loss:
                d = loss["delta"]
                trend = " ↓" if d < 0 else (" ↑" if d > 0 else " →")
            parts.append(f"loss {_fmt(loss['loss'], '.4g')}{trend}")
        if "ewma" in loss:
            parts.append(f"ewma {_fmt(loss['ewma'], '.4g')}")
        gn = loss.get("grad_norm_hist")
        if gn:
            cur = loss.get("grad_norm")
            cur_s = f"{_fmt(cur)} " if cur is not None else ""
            parts.append(f"grad_norm {cur_s}(p50 {_fmt(gn['p50'])}, "
                         f"p99 {_fmt(gn['p99'])})")
        if parts:
            lines.append("loss     " + "   ".join(parts))

    # ---- fp16 / skips ---- #
    fp16 = s.get("fp16")
    if fp16 is not None:
        parts = []
        if "loss_scale" in fp16:
            parts.append(f"loss_scale {_fmt(fp16['loss_scale'], '.6g')}")
        if "skipped_steps" in fp16:
            # denominator: the snapshot's step stamp (advances on both the
            # train_batch and trio paths; the train/steps counter is
            # train_batch-only and would render "N/0" for trio runs)
            total = s.get("step") or (s.get("train") or {}).get("steps", 0)
            parts.append(f"skipped {int(fp16['skipped_steps'])}"
                         f"/{int(total)} steps")
        if "consecutive_skips" in fp16:
            parts.append(f"consecutive {int(fp16['consecutive_skips'])}")
        lines.append("fp16     " + "   ".join(parts))

    # ---- anomalies / stall ---- #
    anoms = s.get("anomalies")
    stall = s.get("data_stall_fraction")
    if anoms is not None or stall is not None:
        nonzero = {k: v for k, v in sorted((anoms or {}).items()) if v}
        a_s = ", ".join(f"{k}:{v}" for k, v in nonzero.items()) \
            if nonzero else ("none" if anoms else "-")
        parts = [f"anomalies {a_s}"]
        if stall is not None:
            parts.append(f"data-stall {stall:.1%}")
        lines.append("health   " + "   ".join(parts))

    # ---- memory ---- #
    mem = s.get("memory")
    if mem is not None:
        used = mem.get("hbm_bytes_in_use") or {}
        lim = mem.get("hbm_bytes_limit") or {}
        peak = mem.get("hbm_peak_bytes") or {}
        head = mem.get("hbm_headroom_bytes") or {}
        rss = mem.get("host_rss_bytes")
        parts = []
        if used:
            mx = max(used, key=used.get)
            u, l2, p = used[mx], lim.get(mx, 0), peak.get(mx, 0)
            line = f"HBM {_fmt_bytes(u)}"
            if l2:
                line += f"/{_fmt_bytes(l2)}"
            if p:
                line += f" (peak {_fmt_bytes(p)}"
                if head.get(mx) is not None:
                    line += f", headroom {_fmt_bytes(head[mx])}"
                line += ")"
            parts.append(line + f" [{mx}]")
        if rss:
            parts.append(f"host RSS {_fmt_bytes(rss)}")
        if parts:
            lines.append("memory   " + "   ".join(parts))

    # ---- serving ---- #
    serving = s.get("serving")
    if serving is not None and ("ttft_ms" in serving
                                or "queue_depth" in serving):
        parts = []
        ttft = serving.get("ttft_ms")
        if ttft:
            parts.append(f"TTFT p50 {ttft['p50']:.1f}ms p99 {ttft['p99']:.1f}ms")
        tpot = serving.get("tpot_ms")
        if tpot:
            parts.append(f"TPOT p50 {tpot['p50']:.2f}ms")
        qw = serving.get("queue_wait_ms")
        if qw:
            # submit->admit wait: the async loop's queueing-delay readout
            parts.append(f"wait p50 {qw['p50']:.1f}ms")
        if "queue_depth" in serving:
            parts.append(f"queue {int(serving['queue_depth'])}")
        if "running" in serving:
            parts.append(f"running {int(serving['running'])}")
        if "kv_block_utilization" in serving:
            line = f"KV util {serving['kv_block_utilization']:.2f}"
            if "kv_blocks_free" in serving:
                line += f" free {int(serving['kv_blocks_free'])}"
            if "kv_fragmentation" in serving:
                line += f" frag {serving['kv_fragmentation']:.2f}"
            if serving.get("tp", 1) > 1:
                # head-sharded pools: the block counts above are GLOBAL
                # per slice, not per shard — annotate so a tp pool is not
                # misread as 1/tp of the memory
                line += f" [tp={int(serving['tp'])}]"
            parts.append(line)
        lookups = serving.get("prefix_cache_lookups", 0)
        if lookups:
            hits = serving.get("prefix_cache_hits", 0)
            line = f"cache {int(hits)}/{int(lookups)} ({hits / lookups:.0%})"
            toks = serving.get("prefix_cache_hit_tokens", 0)
            if toks:
                line += f" +{int(toks)}tok"
            if "cold_blocks" in serving:
                line += f" cold {int(serving['cold_blocks'])}"
            parts.append(line)
        spills = serving.get("kv_spills", 0)
        fh = serving.get("kv_fetch_hits", 0)
        if spills or fh or serving.get("kv_host_blocks"):
            # tiered KV cache: host-tier hits / spills (the re-hit rate of
            # demoted content) + what the host pool currently holds
            line = f"host {int(fh)}H/{int(spills)}S"
            if spills:
                line += f" ({fh / spills:.0%})"
            ft = serving.get("kv_fetch_tokens", 0)
            if ft:
                line += f" +{int(ft)}tok"
            if "kv_host_blocks" in serving:
                line += f" {int(serving['kv_host_blocks'])}blk"
                if serving.get("kv_host_bytes"):
                    line += f"/{_fmt_bytes(serving['kv_host_bytes'])}"
            if serving.get("kv_host_errors"):
                line += f" err {int(serving['kv_host_errors'])}"
            parts.append(line)
        prop = serving.get("spec_proposed_tokens", 0)
        if prop:
            # speculation on: accepted/proposed candidates + rate
            acc = serving.get("spec_accepted_tokens", 0)
            line = f"spec {int(acc)}/{int(prop)} ({acc / prop:.0%})"
            rb = serving.get("spec_rollbacks", 0)
            if rb:
                line += f" rb {int(rb)}"
            parts.append(line)
        if "preemptions" in serving:
            parts.append(f"preempt {int(serving['preemptions'])}")
        if serving.get("rejected_requests"):
            # admission control is turning traffic away: pool pressure
            parts.append(f"rejected {int(serving['rejected_requests'])}")
        faults = serving.get("step_faults") or {}
        n_faults = sum(faults.values())
        restarts = serving.get("engine_restarts", 0)
        retries = serving.get("request_retries", 0)
        if n_faults or restarts or retries:
            # the fault-containment story: contained step faults, how many
            # retried per-request, how many cost an engine rebuild
            line = f"faults {int(n_faults)}"
            if retries:
                line += f" retry {int(retries)}"
            if restarts:
                line += f" restart {int(restarts)}"
            parts.append(line)
        if serving.get("timeouts"):
            parts.append(f"timeout {int(serving['timeouts'])}")
        if serving.get("shed_requests"):
            # load shedding is dropping queued work: sustained = capacity
            parts.append(f"shed {int(serving['shed_requests'])}")
        if parts:
            lines.append("serving  " + "   ".join(parts))

    # ---- request phase ledger (serving/phase_ms, anatomy order) ---- #
    ph = (serving or {}).get("phases") or {}
    if ph:
        order = ["intake", "queue", "prefill", "prefill_chunk", "cow",
                 "fetch", "spill", "handoff", "verify", "decode"]
        pparts = []
        for p in order + sorted(set(ph) - set(order)):
            reps = ph.get(p)
            if not reps:
                continue
            n = sum(int(v.get("count", 0)) for v in reps.values())
            tot = sum(float(v.get("sum", 0.0)) for v in reps.values())
            p99 = max(float(v.get("p99", 0.0)) for v in reps.values())
            # count-weighted fleet mean / worst-replica p99
            pparts.append(f"{p} {tot / max(n, 1):.1f}/{p99:.1f}ms")
        if pparts:
            lines.append("phases   " + "  ".join(pparts) + "  [mean/p99]")
    wt = (serving or {}).get("wasted_tokens") or {}
    if wt:
        wparts = [f"{cause} {int(sum(reps.values()))}"
                  for cause, reps in sorted(wt.items())
                  if sum(reps.values())]
        if wparts:
            lines.append("wasted   " + "   ".join(wparts) + " tok")

    # ---- replica router (dp serving axis) ---- #
    rep = s.get("replicas")
    if rep is not None:
        parts = []
        names = sorted(set(rep.get("requests", {}))
                       | set(rep.get("healthy", {}))
                       | set(rep.get("queue_depth", {}))
                       | set(rep.get("drained_requests", {})))
        for name in names:
            ok = rep.get("healthy", {}).get(name)
            # DOWN = breaker-tripped/stopped/draining: the router is
            # steering its traffic (and drained its in-flight) elsewhere
            line = (f"{name} {'up' if ok is None or ok else 'DOWN'}"
                    f" q{int(rep.get('queue_depth', {}).get(name, 0))}"
                    f" {int(rep.get('requests', {}).get(name, 0))}req")
            drained = rep.get("drained_requests", {}).get(name, 0)
            if drained:
                line += f" drained {int(drained)}"
            parts.append(line)
        if rep.get("handoffs"):
            # disaggregated prefill->decode transfers via the host tier
            parts.append(f"handoff {int(rep['handoffs'])}")
        if parts:
            lines.append("replicas " + "   ".join(parts))

    # ---- SLO burn rates ---- #
    slo = s.get("slo")
    if slo is not None:
        parts = []
        burn = slo.get("burn_rate") or {}
        fired = slo.get("breaches") or {}
        for obj in sorted(set(burn) | set(fired)):
            wins = burn.get(obj, {})
            # longest window first, matching the (long, short) config order
            ws = " ".join(
                f"{w}t {wins[w]:.2f}x"
                for w in sorted(wins, key=lambda x: -int(x)
                                if str(x).lstrip("-").isdigit() else 0))
            line = f"{obj} " + (f"burn {ws}" if ws else "burn -")
            n = int(fired.get(obj, 0))
            if n:
                line += f" BREACH x{n}"
            parts.append(line)
        if parts:
            lines.append("slo      " + "   ".join(parts))

    # ---- adaptive controller pane ---- #
    ctl = s.get("ctl")
    if ctl is not None:
        parts = []
        for name, kv in (ctl.get("knobs") or {}).items():
            v, b = kv.get("value"), kv.get("baseline")
            seg = f"{name} {int(v)}"
            if b is not None and v != b:
                # tightened away from config: show the baseline it left
                seg += f"<cfg {int(b)}>"
            parts.append(seg)
        if parts:
            lines.append("ctl      " + "   ".join(parts))
        info = []
        la = ctl.get("last_action")
        if la:
            info.append(f"last {la.get('direction')} {la.get('knob')} "
                        f"@t{la.get('tick')} [{la.get('reason')}]")
        n = ctl.get("actions_in_window")
        if n:
            info.append(f"{int(n)} action(s) this window")
        if info:
            lines.append("         " + "   ".join(info))

    # ---- flight-recorder ring loss ---- #
    ev = s.get("events")
    if ev and ev.get("dropped"):
        lines.append(f"events   dropped {int(ev['dropped'])} "
                     f"(ring {int(ev.get('capacity', 0))}) — trace tail "
                     "truncated")

    if len(lines) == 2:
        lines.append("(no recognized series in this snapshot)")
    return "\n".join(lines)


def health_summary(rec: Dict, prev: Optional[Dict] = None) -> Dict[str, Any]:
    """The machine-readable form of :func:`render_health_table`: the same
    snapshot-derived values the table shows, as a nested dict (consumed by
    ``cli health --json`` so CI and scripts never screen-scrape the
    table). Sections with no data are omitted; the raw snapshot rides
    along under ``"snapshot"``."""
    g = rec.get("gauges", {}) or {}
    c = rec.get("counters", {}) or {}
    h = rec.get("histograms", {}) or {}
    out: Dict[str, Any] = {"step": rec.get("step"), "ts": rec.get("ts")}

    train: Dict[str, Any] = {}
    st = h.get("train/step_time_ms")
    if st or "train/steps" in c:
        train["steps"] = int(c.get("train/steps", 0))
        if st:
            train["step_time_ms"] = st
        ts = rec.get("ts")
        if prev and ts and prev.get("ts") and "train/steps" in c \
                and "train/steps" in (prev.get("counters") or {}):
            dt = ts - prev["ts"]
            dsteps = c["train/steps"] - prev["counters"]["train/steps"]
            if dt > 0 and dsteps > 0:
                train["steps_per_sec"] = dsteps / dt
        for key, name in (("train/tokens_per_sec", "tokens_per_sec"),
                          ("train/mfu", "mfu")):
            if key in g:
                train[name] = g[key]
    if train:
        out["train"] = train

    loss: Dict[str, Any] = {}
    for key, name in (("train/loss", "loss"), ("health/loss_ewma", "ewma"),
                      ("health/grad_norm", "grad_norm")):
        if key in g:
            loss[name] = g[key]
    pg = (prev or {}).get("gauges") or {}
    if "train/loss" in g and "train/loss" in pg:
        loss["delta"] = g["train/loss"] - pg["train/loss"]   # trend
    if h.get("train/grad_norm", {}).get("count"):
        loss["grad_norm_hist"] = h["train/grad_norm"]
    if loss:
        out["loss"] = loss

    fp16: Dict[str, Any] = {}
    for key, name in (("train/loss_scale", "loss_scale"),
                      ("train/skipped_steps", "skipped_steps"),
                      ("health/consecutive_skips", "consecutive_skips")):
        if key in g:
            fp16[name] = g[key]
    if fp16:
        out["fp16"] = fp16

    anoms = labeled_series(c, "health/anomalies")
    if anoms:
        out["anomalies"] = {k: int(v) for k, v in sorted(anoms.items())}
    if "train/data_stall_fraction" in g:
        out["data_stall_fraction"] = g["train/data_stall_fraction"]

    mem: Dict[str, Any] = {}
    for key, name in (("mem/hbm_bytes_in_use", "hbm_bytes_in_use"),
                      ("mem/hbm_peak_bytes", "hbm_peak_bytes"),
                      ("mem/hbm_bytes_limit", "hbm_bytes_limit"),
                      ("mem/hbm_headroom_bytes", "hbm_headroom_bytes")):
        series = labeled_series(g, key)
        if series:
            mem[name] = series
    if "mem/host_rss_bytes" in g:
        mem["host_rss_bytes"] = g["mem/host_rss_bytes"]
    if mem:
        out["memory"] = mem

    serving: Dict[str, Any] = {}
    for key, name in (("serving/ttft_ms", "ttft_ms"),
                      ("serving/tpot_ms", "tpot_ms"),
                      ("serving/queue_wait_ms", "queue_wait_ms")):
        if h.get(key, {}).get("count"):
            serving[name] = h[key]
    for key, name in (("serving/queue_depth", "queue_depth"),
                      ("serving/running", "running"),
                      ("serving/kv_block_utilization", "kv_block_utilization"),
                      ("serving/kv_blocks_free", "kv_blocks_free"),
                      ("serving/kv_fragmentation", "kv_fragmentation"),
                      ("serving/cold_blocks", "cold_blocks"),
                      ("serving/kv_host_blocks", "kv_host_blocks"),
                      ("serving/kv_host_bytes", "kv_host_bytes"),
                      ("serving/tp", "tp"),
                      ("serving/spec_acceptance_rate",
                       "spec_acceptance_rate")):
        if key in g:
            serving[name] = g[key]
    for key, name in (("serving/prefix_cache_lookups", "prefix_cache_lookups"),
                      ("serving/prefix_cache_hits", "prefix_cache_hits"),
                      ("serving/prefix_cache_hit_tokens",
                       "prefix_cache_hit_tokens"),
                      ("serving/spec_proposed_tokens", "spec_proposed_tokens"),
                      ("serving/spec_accepted_tokens", "spec_accepted_tokens"),
                      ("serving/spec_rollbacks", "spec_rollbacks"),
                      ("serving/kv_spills", "kv_spills"),
                      ("serving/kv_fetch_hits", "kv_fetch_hits"),
                      ("serving/kv_fetch_tokens", "kv_fetch_tokens"),
                      ("serving/kv_host_errors", "kv_host_errors"),
                      ("serving/preemptions", "preemptions"),
                      ("serving/rejected_requests", "rejected_requests"),
                      ("serving/engine_restarts", "engine_restarts"),
                      ("serving/request_retries", "request_retries"),
                      ("serving/timeouts", "timeouts"),
                      ("serving/shed_requests", "shed_requests")):
        if key in c:
            serving[name] = c[key]
    faults = labeled_series(c, "serving/step_faults")
    if faults:
        # contained engine-step exceptions by dispatch site (serving.fault)
        serving["step_faults"] = {k: int(v) for k, v in sorted(faults.items())}
    # request latency anatomy: {phase: {replica: histogram summary}} —
    # the phase ledger the trace/top/scrape surfaces all render from
    phases: Dict[str, Dict[str, Any]] = {}
    for labels, v in multilabel_series(h, "serving/phase_ms"):
        p, rep = labels.get("phase"), labels.get("replica")
        if p is not None and rep is not None and (v or {}).get("count"):
            phases.setdefault(p, {})[rep] = v
    if phases:
        serving["phases"] = phases
    # wasted-work accounting: {cause: {replica: tokens}}
    wasted: Dict[str, Dict[str, int]] = {}
    for labels, v in multilabel_series(c, "serving/wasted_tokens"):
        cause, rep = labels.get("cause"), labels.get("replica")
        if cause is not None and rep is not None:
            wasted.setdefault(cause, {})[rep] = int(v)
    if wasted:
        serving["wasted_tokens"] = wasted
    if serving:
        out["serving"] = serving

    # ---- replica router (dp serving axis, inference/router.py) ---- #
    replicas: Dict[str, Any] = {}
    for key, name in (("router/requests", "requests"),
                      ("router/drained_requests", "drained_requests")):
        series = labeled_series(c, key)
        if series:
            replicas[name] = {k: int(v) for k, v in sorted(series.items())}
    for key, name in (("router/healthy", "healthy"),
                      ("router/queue_depth", "queue_depth")):
        series = labeled_series(g, key)
        if series:
            replicas[name] = {k: v for k, v in sorted(series.items())}
    if "router/handoffs" in c:
        replicas["handoffs"] = int(c["router/handoffs"])
    if replicas:
        out["replicas"] = replicas

    # ---- SLO burn rates / breaches (monitor/slo.py) ---- #
    slo: Dict[str, Any] = {}
    breaches = labeled_series(c, "slo/breaches")
    if breaches:
        slo["breaches"] = {k: int(v) for k, v in sorted(breaches.items())}
    burn: Dict[str, Dict[str, float]] = {}
    for labels, v in multilabel_series(g, "slo/burn_rate"):
        obj = labels.get("objective")
        win = labels.get("window")
        if obj is not None and win is not None:
            burn.setdefault(obj, {})[win] = v
    if burn:
        slo["burn_rate"] = burn
    if slo:
        out["slo"] = slo

    # ---- adaptive controller posture (monitor/controller.py) ---- #
    ctl: Dict[str, Any] = {}
    knobs = labeled_series(g, "ctl/knob")
    if knobs:
        base = labeled_series(g, "ctl/knob_baseline")
        ctl["knobs"] = {k: {"value": v, "baseline": base.get(k)}
                        for k, v in sorted(knobs.items())}
    acts: Dict[str, Dict[str, int]] = {}
    for labels, v in multilabel_series(c, "ctl/actions"):
        kn, d = labels.get("knob"), labels.get("direction")
        if kn is not None and d is not None and v:
            acts.setdefault(kn, {})[d] = int(v)
    if acts:
        ctl["actions"] = acts
    pc = (prev or {}).get("counters") or {}
    if prev is not None and knobs:
        # movements since the previous snapshot: the pane's
        # actions-per-window readout (0 = posture held)
        now = sum(v for k, v in c.items() if k.startswith("ctl/actions{"))
        before = sum(v for k, v in pc.items()
                     if k.startswith("ctl/actions{"))
        ctl["actions_in_window"] = int(now - before)
    last = None
    for labels, v in multilabel_series(g, "ctl/last_action"):
        if last is None or v > last[0]:
            last = (v, labels)
    if last is not None:
        ctl["last_action"] = {"tick": int(last[0]),
                              "knob": last[1].get("knob"),
                              "direction": last[1].get("direction"),
                              "reason": last[1].get("reason")}
    if ctl:
        out["ctl"] = ctl

    # ---- flight-recorder ring loss (events/dropped gauges) ---- #
    if "events/dropped" in g:
        out["events"] = {"dropped": int(g["events/dropped"]),
                         "capacity": int(g.get("events/capacity", 0))}

    out["snapshot"] = rec
    return out


def health_cli(argv: Optional[List[str]] = None) -> int:
    """``cli health <telemetry.jsonl>`` — live one-screen status table
    tailing the JSONL telemetry sink (``--once`` renders a single table
    and exits; ``--json`` prints the latest snapshot's summary as JSON
    and exits; default follows at ``--interval`` seconds)."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.cli health",
        description="live training/serving health screen over a JSONL "
                    "telemetry sink (telemetry.jsonl_path)")
    parser.add_argument("path", help="JSONL telemetry sink to tail")
    parser.add_argument("--once", action="store_true",
                        help="render one table and exit (no follow loop)")
    parser.add_argument("--json", action="store_true",
                        help="print the latest snapshot summary as JSON "
                             "and exit (machine-readable --once)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds (default 2)")
    args = parser.parse_args(argv)

    if args.once or args.json:
        recs = read_last_snapshots(args.path, 2)
        if not recs:
            if args.json:
                print(json.dumps({"error": "no telemetry records",
                                  "path": args.path}))
            else:
                print(f"health: no telemetry records in {args.path}")
            return 1
        prev = recs[-2] if len(recs) > 1 else None
        if args.json:
            print(json.dumps(health_summary(recs[-1], prev)))
        else:
            print(render_health_table(recs[-1], prev))
        return 0
    try:
        while True:
            recs = read_last_snapshots(args.path, 2)
            body = (render_health_table(recs[-1],
                                        recs[-2] if len(recs) > 1 else None)
                    if recs else f"health: waiting for records in {args.path} ...")
            sys.stdout.write("\033[2J\033[H" + body + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
