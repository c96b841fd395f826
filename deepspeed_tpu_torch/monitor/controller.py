"""Deterministic SLO-burn-rate autopilot with an auditable decision ledger
(the port of ``deepspeed_tpu/monitor/controller.py``: the decision core,
the live wrapper with a caller-supplied ``apply_fn``, replay and explain;
its wiring into a live server waits for async serving, ROADMAP.md queue 1
item 5.1).

The observability plane ends at "exposes metrics"; this module closes the
loop. An :class:`AdaptiveController`, ticked by the existing
``MetricsSampler``, maps burn-rate state (the TTFT / TPOT / goodput
objectives of ``monitor/slo.py``, plus spec acceptance, queue depth, KV
pressure and wasted-token rates from the phase ledger) to typed knob
actions:

- TTFT burning            -> shrink the prefill chunk + tighten admission
- TPOT burning, spec cold -> drop speculative ``k``
- goodput burning         -> shed earlier, admit less, keep pool headroom
- KV pressure, host OK    -> raise host-spill aggressiveness
- sustained headroom      -> step every knob back toward config, one rung
                             per cooldown window

Each knob moves on a **ladder** (index 0 = the config baseline, higher =
tighter posture) whose rungs are the JAX package's, chosen there so every
value stays inside the compile buckets its engine already owns — chunk
sizes move only between 128-multiples, spec ``k`` only within its fixed
pow2 verify window. Per-knob **cooldown ticks**
plus a tighten/relax **hysteresis band** (relax only below
``relax_threshold`` for ``relax_after`` consecutive ticks) keep an
oscillating burn rate from flapping a knob.

Every observation -> decision -> application is a typed flight-recorder
event (``ctl.observe`` / ``ctl.decide`` / ``ctl.apply`` / ``ctl.revert``
in ``EVENT_KINDS``), forming the decision ledger, and the registry grows
``ctl/knob{name=}`` gauges plus ``ctl/actions{knob=,direction=}``
counters so any ``/metrics`` scrape explains *why* the system holds its
current posture. :class:`DecisionCore` is a pure function of its
observation trace — no wall time, no RNG — so :func:`replay_decisions`
over a recorded ``events.jsonl`` reproduces the exact action sequence
(the scheduler/router determinism discipline, applied to control).

This module is part of the telemetry exposition plane: host-side dict
arithmetic only: nothing here imports torch or touches a device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

TIGHTEN = "tighten"
RELAX = "relax"

# bounded reason vocabulary (safe as metric label values)
REASON_TTFT = "ttft_burn"
REASON_TPOT = "tpot_burn"
REASON_GOODPUT = "goodput_burn"
REASON_KV = "kv_pressure"
REASON_HEADROOM = "headroom"
REASON_RESTART = "restart"

#: every knob the controller may drive, in its deterministic scan order
KNOB_NAMES = ("prefill_chunk", "spec_k", "max_queue", "min_free_blocks",
              "shed_depth", "kv_spill")


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One runtime-adjustable serving knob.

    ``ladder[0]`` is the config baseline; ascending index = tighter
    posture. Rungs are fixed at build time (:func:`knobs_from_serving`)
    so every reachable value is known up front.
    """
    name: str
    ladder: Tuple[int, ...]

    def __post_init__(self):
        if len(self.ladder) < 2:
            raise ValueError(f"knob {self.name!r}: ladder needs >= 2 rungs "
                             f"(got {self.ladder!r})")
        if len(set(self.ladder)) != len(self.ladder):
            raise ValueError(f"knob {self.name!r}: duplicate ladder rungs "
                             f"{self.ladder!r}")

    @property
    def baseline(self) -> int:
        return self.ladder[0]


@dataclasses.dataclass(frozen=True)
class KnobAction:
    """One decided knob movement (a ``ctl.decide`` ledger entry)."""
    tick: int
    knob: str
    direction: str          # TIGHTEN | RELAX
    value: int              # the new knob value
    prev: int               # the value it moved away from
    reason: str             # bounded REASON_* vocabulary
    at_baseline: bool       # True when this relax lands back on config

    def to_payload(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One sampler tick's folded controller inputs.

    Burn rates are folded per objective class (min across windows — the
    breach semantics — then max across the class's objectives), so the
    ledger entry is self-contained: :class:`DecisionCore` never re-reads
    the registry, which is what makes replay exact.
    """
    tick: int
    ttft_burn: float = 0.0
    tpot_burn: float = 0.0
    goodput_burn: float = 0.0
    queue_depth: float = 0.0
    kv_util: float = 0.0
    kv_free: float = 0.0
    spec_acceptance: float = 1.0
    host_tier_ok: bool = False
    wasted_rate: float = 0.0        # wasted tokens this tick (all causes)

    def to_payload(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, d: Dict[str, Any]) -> "Observation":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def max_burn(self) -> float:
        return max(self.ttft_burn, self.tpot_burn, self.goodput_burn)


# ---------------------------------------------------------------------- #
# ladder builders
# ---------------------------------------------------------------------- #

def _chunk_ladder(chunk: int) -> Optional[Tuple[int, ...]]:
    """Descending 128-multiples below the configured chunk size.

    Chunked prefill pads each step to a 128-bucket
    (``engine._bucket``), so any 128-multiple <= the baseline reuses a
    program the warm engine has already compiled. Chunking is never
    ENABLED mid-flight (baseline 0 stays 0): turning it on would route
    prefill through chunk-sized buckets the engine never built.
    """
    if chunk <= 0:
        return None
    rungs = [chunk]
    step = (chunk // 2 // 128) * 128
    while step >= 128 and len(rungs) < 4:
        if step < rungs[-1]:
            rungs.append(step)
        step //= 2
        step = (step // 128) * 128
    if len(rungs) < 2 and chunk > 128:
        rungs.append(128)
    return tuple(rungs) if len(rungs) >= 2 else None


def _spec_ladder(k: int) -> Optional[Tuple[int, ...]]:
    """Descending spec ``k`` rungs, ending at 0 (spec off).

    The verify program pads candidates to a FIXED pow2 window set from
    the configured ``k`` at session open, so any ``k' <= k`` — including
    0, which degenerates to the already-compiled pure-decode step — is
    compile-free. Rungs: baseline, then the next pow2 window edges down
    (``2^i - 1``), then 0.
    """
    if k <= 0:
        return None
    rungs = [k]
    edge = (1 << max(k.bit_length() - 1, 0)) - 1    # e.g. k=4 -> 3
    while edge > 0:
        if edge < rungs[-1]:
            rungs.append(edge)
        edge = (1 << max(edge.bit_length() - 1, 0)) - 1
    rungs.append(0)
    return tuple(rungs)


def knobs_from_serving(serving, policy=None,
                       pinned: Sequence[str] = ()) -> List[KnobSpec]:
    """Build the knob set a :class:`ServingConfig` admits.

    Knobs whose baseline makes movement meaningless (chunking off, spec
    off, spill already on) are omitted rather than built immovable, and
    any name in ``pinned`` (config ``telemetry.ctl.knobs.<name>: off``)
    is excluded — the controller simply never sees it.
    """
    pinned = set(pinned)
    out: List[KnobSpec] = []

    def add(name: str, ladder: Optional[Tuple[int, ...]]) -> None:
        if ladder is not None and name not in pinned:
            out.append(KnobSpec(name, ladder))

    add("prefill_chunk", _chunk_ladder(int(serving.prefill_chunk_tokens)))

    spec = serving.speculative
    k = int(spec.k) if getattr(spec, "mode", "off") != "off" else 0
    add("spec_k", _spec_ladder(k))

    q = int(getattr(policy, "admission_max_queue", 0) or 0)
    if q > 0:
        ladder = [q]
        for v in (max(q // 2, 1), max(q // 4, 1)):
            if v < ladder[-1]:
                ladder.append(v)
        add("max_queue", tuple(ladder) if len(ladder) >= 2 else None)
    else:
        # baseline "unbounded": tightening imposes a bound at all
        add("max_queue", (0, 16, 8, 4))

    m = int(getattr(policy, "admission_min_free_blocks", 0) or 0)
    add("min_free_blocks", (m, m + 2, m + 4))

    s = int(serving.fault.shed_queue_depth)
    if s > 0:
        add("shed_depth", (s, max(s // 2, 1)) if s > 1 else None)
    else:
        add("shed_depth", (0, 16, 8))

    kv = serving.kv_host
    if kv.enabled and getattr(kv, "spill", "auto") == "off":
        # host tier present but demotion disabled: the one rung up turns
        # spill on (0 = config's fetch-only, 1 = demote cold blocks)
        add("kv_spill", (0, 1))

    return out


# ---------------------------------------------------------------------- #
# the pure decision core
# ---------------------------------------------------------------------- #

class _KnobState:
    __slots__ = ("idx", "last_tick")

    def __init__(self):
        self.idx = 0                # ladder index (0 = baseline)
        self.last_tick: Optional[int] = None


class DecisionCore:
    """Pure observation-trace -> action-sequence function.

    Holds only ladder indices, cooldown stamps and the headroom streak;
    :meth:`decide` consumes a folded :class:`Observation` and returns the
    actions for that tick. No clocks, no RNG, no registry reads — feeding
    the same observation sequence always yields the same actions, which
    is what :func:`replay_decisions` pins.
    """

    def __init__(self, knobs: Sequence[KnobSpec], *,
                 tighten_threshold: float = 1.0,
                 relax_threshold: float = 0.25,
                 cooldown_ticks: int = 5,
                 relax_after: int = 10,
                 spec_accept_floor: float = 0.5,
                 kv_util_high: float = 0.9):
        self.knobs: Dict[str, KnobSpec] = {}
        for k in knobs:
            if k.name in self.knobs:
                raise ValueError(f"duplicate knob {k.name!r}")
            self.knobs[k.name] = k
        self.tighten_threshold = float(tighten_threshold)
        self.relax_threshold = float(relax_threshold)
        self.cooldown_ticks = int(cooldown_ticks)
        self.relax_after = int(relax_after)
        self.spec_accept_floor = float(spec_accept_floor)
        self.kv_util_high = float(kv_util_high)
        self._state: Dict[str, _KnobState] = \
            {name: _KnobState() for name in self.knobs}
        self._headroom_streak = 0

    # current values, for gauges / panes / re-application
    def values(self) -> Dict[str, int]:
        return {name: spec.ladder[self._state[name].idx]
                for name, spec in self.knobs.items()}

    def params(self) -> Dict[str, float]:
        return {"tighten_threshold": self.tighten_threshold,
                "relax_threshold": self.relax_threshold,
                "cooldown_ticks": self.cooldown_ticks,
                "relax_after": self.relax_after,
                "spec_accept_floor": self.spec_accept_floor,
                "kv_util_high": self.kv_util_high}

    def manifest(self) -> Dict[str, Any]:
        """The replay seed: ladders + thresholds, stamped into the first
        ``ctl.observe`` ledger entry. Knob order is preserved (insertion
        order is the relax scan order, so it is part of the decision
        function)."""
        return {"knobs": {n: list(s.ladder)
                          for n, s in self.knobs.items()},
                "params": self.params()}

    @classmethod
    def from_manifest(cls, manifest: Dict[str, Any]) -> "DecisionCore":
        knobs = [KnobSpec(n, tuple(ladder))
                 for n, ladder in manifest.get("knobs", {}).items()]
        return cls(knobs, **manifest.get("params", {}))

    def _try(self, name: str, direction: str, reason: str,
             tick: int) -> Optional[KnobAction]:
        st = self._state.get(name)
        if st is None:
            return None                         # knob absent or pinned
        spec = self.knobs[name]
        if direction == TIGHTEN:
            if st.idx >= len(spec.ladder) - 1:
                return None                     # already at the floor
            new_idx = st.idx + 1
        else:
            if st.idx == 0:
                return None                     # already at baseline
            new_idx = st.idx - 1
        if st.last_tick is not None and \
                tick - st.last_tick < self.cooldown_ticks:
            return None                         # inside the cooldown
        prev = spec.ladder[st.idx]
        st.idx = new_idx
        st.last_tick = tick
        return KnobAction(tick=tick, knob=name, direction=direction,
                          value=spec.ladder[new_idx], prev=prev,
                          reason=reason, at_baseline=(new_idx == 0))

    def decide(self, obs: Observation) -> List[KnobAction]:
        """One tick: fold pressures into knob movements."""
        thr = self.tighten_threshold
        kv_hot = obs.kv_util >= self.kv_util_high and obs.host_tier_ok
        wants: List[Tuple[str, str]] = []       # (knob, reason) tighten list
        if obs.ttft_burn >= thr:
            wants += [("prefill_chunk", REASON_TTFT),
                      ("max_queue", REASON_TTFT)]
        if obs.tpot_burn >= thr and obs.spec_acceptance < \
                self.spec_accept_floor:
            wants.append(("spec_k", REASON_TPOT))
        if obs.goodput_burn >= thr:
            wants += [("shed_depth", REASON_GOODPUT),
                      ("max_queue", REASON_GOODPUT),
                      ("min_free_blocks", REASON_GOODPUT)]
        if kv_hot:
            wants.append(("kv_spill", REASON_KV))

        actions: List[KnobAction] = []
        under_pressure = obs.max_burn >= thr or kv_hot
        if under_pressure:
            self._headroom_streak = 0
            moved = set()
            for name, reason in wants:
                if name in moved:
                    continue                    # first pressure wins
                act = self._try(name, TIGHTEN, reason, obs.tick)
                if act is not None:
                    moved.add(name)
                    actions.append(act)
        elif obs.max_burn <= self.relax_threshold:
            self._headroom_streak += 1
            if self._headroom_streak >= self.relax_after:
                for name in self.knobs:         # insertion order: stable
                    act = self._try(name, RELAX, REASON_HEADROOM, obs.tick)
                    if act is not None:
                        actions.append(act)
        else:
            # the hysteresis dead band: burning, but not past the tighten
            # threshold — hold posture, reset the headroom streak
            self._headroom_streak = 0
        return actions


# ---------------------------------------------------------------------- #
# the live wrapper (registry + ledger + application)
# ---------------------------------------------------------------------- #

def _gauge_value(gauges: Dict[str, float], name: str,
                 default: float = 0.0) -> float:
    """Read a gauge that may be plain or labeled (single-replica serving
    emits plain; a tagged recorder adds ``replica=``). Labeled: max
    across series — the controller reacts to the hottest replica."""
    if name in gauges:
        return float(gauges[name])
    prefix = name + "{"
    vals = [v for k, v in gauges.items() if k.startswith(prefix)]
    return float(max(vals)) if vals else default


def _counter_sum(counters: Dict[str, float], name: str) -> float:
    """Sum a counter family across all its label series."""
    prefix = name + "{"
    total = float(counters.get(name, 0.0))
    total += sum(v for k, v in counters.items() if k.startswith(prefix))
    return total


def _burn_by_class(gauges: Dict[str, float]) -> Dict[str, float]:
    """Fold ``slo/burn_rate{objective=,window=}`` gauges into the three
    controller pressure classes. Per objective: min across windows (a
    breach needs EVERY window burning); per class: max across
    objectives. Objectives classify by name substring — ``ttft`` /
    ``tpot`` / everything else is goodput."""
    from deepspeed_tpu_torch.monitor.health import multilabel_series
    per_obj: Dict[str, float] = {}
    for labels, v in multilabel_series(gauges, "slo/burn_rate"):
        obj = labels.get("objective")
        if obj is None:
            continue
        per_obj[obj] = v if obj not in per_obj else min(per_obj[obj], v)
    out = {"ttft": 0.0, "tpot": 0.0, "goodput": 0.0}
    for obj, burn in per_obj.items():
        cls = ("ttft" if "ttft" in obj else
               "tpot" if "tpot" in obj else "goodput")
        out[cls] = max(out[cls], burn)
    return out


class AdaptiveController:
    """The live loop: observe the registry, decide, ledger, apply.

    ``tick()`` is the sampler's hook (called after ``SloEngine.sample``
    refreshes the burn gauges); tests drive it directly for a fully
    deterministic tick sequence. ``apply_fn`` receives the tick's action
    list — the serving front-end queues them onto its intake so knob
    mutation happens between engine steps on the serving thread (donated
    pools stay single-threaded).
    """

    def __init__(self, knobs: Sequence[KnobSpec], *, registry=None,
                 events=None,
                 apply_fn: Optional[Callable[[List[KnobAction]], None]] = None,
                 **core_params):
        if registry is None:
            from deepspeed_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.events = events
        self.apply_fn = apply_fn
        self.core = DecisionCore(knobs, **core_params)
        self._tick = 0
        self._sent_manifest = False
        self._last_host_errors: Optional[float] = None
        self._last_wasted: Optional[float] = None
        self._ensure_series()

    # ---- registry families ---- #

    @property
    def _knob_gauge(self):
        return self.registry.gauge(
            "ctl/knob", "current adaptive-controller knob value",
            labelnames=("name",))

    @property
    def _baseline_gauge(self):
        return self.registry.gauge(
            "ctl/knob_baseline", "config-baseline knob value (ladder[0])",
            labelnames=("name",))

    @property
    def _actions(self):
        return self.registry.counter(
            "ctl/actions", "adaptive-controller knob movements",
            labelnames=("knob", "direction"))

    @property
    def _last_action(self):
        return self.registry.gauge(
            "ctl/last_action",
            "tick of the most recent movement per (knob, direction, "
            "reason) — the scrape-side 'why is it in this posture'",
            labelnames=("knob", "direction", "reason"))

    def _ensure_series(self) -> None:
        for name, value in self.core.values().items():
            self._knob_gauge.labels(name=name).set(value)
            self._baseline_gauge.labels(name=name).set(
                self.core.knobs[name].baseline)
            for d in (TIGHTEN, RELAX):
                self._actions.labels(knob=name, direction=d)

    # ---- one tick ---- #

    def observe(self) -> Observation:
        """Fold the live registry into one self-contained observation."""
        self._tick += 1
        snap = self.registry.snapshot()
        g = snap.get("gauges", {}) or {}
        c = snap.get("counters", {}) or {}
        burns = _burn_by_class(g)

        host_blocks = _gauge_value(g, "serving/kv_host_blocks", -1.0)
        host_errors = _counter_sum(c, "serving/kv_host_errors")
        host_ok = host_blocks >= 0.0 and (
            self._last_host_errors is None
            or host_errors <= self._last_host_errors)
        self._last_host_errors = host_errors

        wasted = _counter_sum(c, "serving/wasted_tokens")
        wasted_rate = (wasted - self._last_wasted
                       if self._last_wasted is not None else 0.0)
        self._last_wasted = wasted

        return Observation(
            tick=self._tick,
            ttft_burn=burns["ttft"],
            tpot_burn=burns["tpot"],
            goodput_burn=burns["goodput"],
            queue_depth=_gauge_value(g, "serving/queue_depth"),
            kv_util=_gauge_value(g, "serving/kv_block_utilization"),
            kv_free=_gauge_value(g, "serving/kv_blocks_free"),
            spec_acceptance=_gauge_value(
                g, "serving/spec_acceptance_rate", 1.0),
            host_tier_ok=host_ok,
            wasted_rate=wasted_rate)

    def tick(self) -> List[KnobAction]:
        """One controller tick: observe -> ledger -> decide -> apply."""
        obs = self.observe()
        if self.events is not None:
            payload = obs.to_payload()
            if not self._sent_manifest:
                payload["config"] = self.core.manifest()
                self._sent_manifest = True
            self.events.emit("ctl.observe", **payload)
        actions = self.core.decide(obs)
        for a in actions:
            if self.events is not None:
                self.events.emit("ctl.decide", **a.to_payload())
            self._actions.labels(knob=a.knob, direction=a.direction).inc()
            self._knob_gauge.labels(name=a.knob).set(a.value)
            self._last_action.labels(knob=a.knob, direction=a.direction,
                                     reason=a.reason).set(a.tick)
        if actions and self.apply_fn is not None:
            self.apply_fn(actions)
        return actions

    def values(self) -> Dict[str, int]:
        return self.core.values()


def controller_from_config(ctl_cfg, serving, policy=None, *, registry=None,
                           events=None, apply_fn=None
                           ) -> Optional[AdaptiveController]:
    """Build the controller a ``telemetry.ctl`` config block asks for
    (None when disabled or no knob is movable)."""
    if ctl_cfg is None or not ctl_cfg.enabled:
        return None
    pinned = [name for name, mode in (ctl_cfg.knobs or {}).items()
              if str(mode).lower() in ("off", "static", "pin")]
    knobs = knobs_from_serving(serving, policy=policy, pinned=pinned)
    if not knobs:
        return None
    return AdaptiveController(
        knobs, registry=registry, events=events, apply_fn=apply_fn,
        tighten_threshold=ctl_cfg.tighten_threshold,
        relax_threshold=ctl_cfg.relax_threshold,
        cooldown_ticks=ctl_cfg.cooldown_ticks,
        relax_after=ctl_cfg.relax_after,
        spec_accept_floor=ctl_cfg.spec_accept_floor,
        kv_util_high=ctl_cfg.kv_util_high)


# ---------------------------------------------------------------------- #
# replay / explain (the audit path)
# ---------------------------------------------------------------------- #

def _iter_events(events_or_path) -> Iterable[Dict[str, Any]]:
    if isinstance(events_or_path, (str, bytes)):
        with open(events_or_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)
    else:
        for e in events_or_path:
            yield e if isinstance(e, dict) else dict(e)


def _event_fields(e: Dict[str, Any]) -> Dict[str, Any]:
    """Ledger events may be flat dicts (events.jsonl rows carry data
    keys at top level) or ``{"kind": ..., "data": {...}}`` shaped."""
    d = e.get("data")
    if isinstance(d, dict):
        merged = dict(e)
        merged.pop("data", None)
        merged.update(d)
        return merged
    return e


def replay_decisions(events_or_path,
                     manifest: Optional[Dict[str, Any]] = None
                     ) -> List[Dict[str, Any]]:
    """Re-run the pure decision core over a recorded observation trace.

    Reads the ``ctl.observe`` entries of a decision ledger (an
    ``events.jsonl`` path, or an iterable of event dicts), seeds a fresh
    :class:`DecisionCore` from the manifest stamped into the first entry
    (or an explicit ``manifest=``), and returns the reproduced action
    payloads — byte-identical to the recorded ``ctl.decide`` sequence
    when the controller is healthy (the replay-identity test pins this).
    """
    core: Optional[DecisionCore] = None
    if manifest is not None:
        core = DecisionCore.from_manifest(manifest)
    out: List[Dict[str, Any]] = []
    for e in _iter_events(events_or_path):
        if e.get("kind") != "ctl.observe":
            continue
        f = _event_fields(e)
        if core is None:
            cfg = f.get("config")
            if not isinstance(cfg, dict):
                raise ValueError(
                    "replay_decisions: first ctl.observe entry carries no "
                    "config manifest; pass manifest= explicitly")
            core = DecisionCore.from_manifest(cfg)
        for a in core.decide(Observation.from_payload(f)):
            out.append(a.to_payload())
    return out


def recorded_decisions(events_or_path) -> List[Dict[str, Any]]:
    """The ``ctl.decide`` payloads actually recorded in a ledger, in
    order — the reference side of the replay-identity comparison."""
    keys = {f.name for f in dataclasses.fields(KnobAction)}
    out: List[Dict[str, Any]] = []
    for e in _iter_events(events_or_path):
        if e.get("kind") != "ctl.decide":
            continue
        f = _event_fields(e)
        out.append({k: f[k] for k in keys if k in f})
    return out


def explain_decisions(events_or_path) -> List[str]:
    """Human-readable audit: one line per decision, annotated with the
    observation that triggered it (``cli ctl explain``)."""
    last_obs: Dict[str, Any] = {}
    lines: List[str] = []
    for e in _iter_events(events_or_path):
        kind = e.get("kind")
        f = _event_fields(e)
        if kind == "ctl.observe":
            last_obs = f
        elif kind == "ctl.decide":
            burns = (f"ttft={last_obs.get('ttft_burn', 0):.2f} "
                     f"tpot={last_obs.get('tpot_burn', 0):.2f} "
                     f"goodput={last_obs.get('goodput_burn', 0):.2f} "
                     f"kv={last_obs.get('kv_util', 0):.2f}")
            lines.append(
                f"tick {f.get('tick')}: {f.get('direction')} "
                f"{f.get('knob')} {f.get('prev')} -> {f.get('value')} "
                f"[{f.get('reason')}] ({burns})")
        elif kind in ("ctl.apply", "ctl.revert"):
            extra = " after restart" if f.get("restart") else ""
            lines.append(
                f"tick {f.get('tick')}: {kind.split('.')[1]} "
                f"{f.get('knob')} = {f.get('value')}{extra}")
    return lines
