"""Telemetry and monitor config (counterpart of
``deepspeed_tpu/monitor/config.py``): the same sections, fields, defaults
and shorthands, on the port's dataclass configs instead of pydantic.

Every field parses. Each engine acts on what the JAX engine of its kind
acts on: the training engine on ``health``, ``sampler``, ``slo`` and
``metrics_port``. What the JAX package acts on only through its async
serving front-end (``inference/serve.py``: ``ctl``, and ``sampler`` /
``slo`` / ``metrics_port`` beside a server) is refused by
:func:`refuse_unported`, naming the ROADMAP.md item "async serving".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deepspeed_tpu_torch.config.config_utils import ConfigModel, sub
from deepspeed_tpu_torch.utils.not_ported import not_ported

config = dataclasses.dataclass(init=False)


def get_monitor_config(param_dict: dict) -> "DeepSpeedMonitorConfig":
    monitor_dict = {key: param_dict.get(key, {}) for key in ("tensorboard", "wandb", "csv_monitor")}
    return DeepSpeedMonitorConfig(**monitor_dict)


@config
class HealthConfig(ConfigModel):
    """"telemetry.health": the training health observatory
    (``monitor/health.py``): numerics sentinels in the update, the anomaly
    detectors and their debug bundles."""
    enabled: bool = False
    sentinels: bool = True
    action: str = "warn"
    window: int = 50
    loss_spike_zscore: float = 6.0
    loss_ewma_alpha: float = 0.02
    warmup_steps: int = 10
    grad_norm_factor: float = 10.0
    plateau_steps: int = 0
    plateau_rel_improvement: float = 1e-3
    overflow_window: int = 25
    ckpt_failure_consecutive: int = 2
    data_stall_fraction: float = 0.5
    data_stall_steps: int = 10
    dump_dir: str = "ds_health_dumps"
    dump_limit: int = 3
    keep_last_steps: int = 200
    max_norm_buckets: int = 8


@config
class EventsConfig(ConfigModel):
    """"telemetry.events": the flight recorder (``monitor/events.py``), a
    bounded ring of lifecycle events. Off by default; when off every emit
    site costs one None check and allocates nothing."""
    enabled: bool = False
    # ring size (events); the recorder keeps the NEWEST `capacity` events
    capacity: int = 16384


@config
class ProfileConfig(ConfigModel):
    """"telemetry.profile": an on-demand ``torch.profiler`` capture window.
    ``num_steps > 0`` arms it: the capture starts at the ``start_step``-th
    train_batch call of this process and stops ``num_steps`` later,
    writing a chrome trace under ``dir``. ``engine.profile(steps=N)`` arms
    the same window programmatically."""
    start_step: int = 0
    num_steps: int = 0
    dir: str = "ds_profile"


@config
class SamplerConfig(ConfigModel):
    """"telemetry.sampler": the background snapshot daemon
    (``monitor/sampler.py``), started beside a training engine."""
    enabled: bool = False
    interval_s: float = 1.0
    path: Optional[str] = None
    max_bytes: int = 16 << 20
    keep: int = 2
    ring: int = 512


@config
class SloConfig(ConfigModel):
    """"telemetry.slo": burn-rate service-level objectives
    (``monitor/slo.py``), evaluated once a sampler tick. Enabling SLOs
    implies the sampler."""
    enabled: bool = False
    objectives: List[Dict] = dataclasses.field(default_factory=list)
    windows: List[int] = dataclasses.field(default_factory=lambda: [60, 5])
    burn_rate_threshold: float = 1.0


@config
class CtlConfig(ConfigModel):
    """"telemetry.ctl": the SLO-burn-rate serving autopilot
    (``monitor/controller.py``; its wiring into a live server waits for
    async serving, so the engines refuse it). Enabling ctl implies the
    sampler."""
    enabled: bool = False
    tighten_threshold: float = 1.0
    relax_threshold: float = 0.25
    cooldown_ticks: int = 5
    relax_after: int = 10
    spec_accept_floor: float = 0.5
    kv_util_high: float = 0.9
    knobs: Dict[str, str] = dataclasses.field(default_factory=dict)


@config
class TelemetryConfig(ConfigModel):
    """"telemetry" section: the cross-layer metrics registry + tracing.

    Accepted as a dict, a bool, or the strings ``"on"``/``"off"`` (see
    :func:`get_telemetry_config`). When enabled, the training engine
    records per-step time, tokens/s and MFU, and the inference engine
    records serving stats (TTFT/TPOT, queue depth, KV-block utilization,
    preemptions). When disabled nothing is instrumented: the hot paths gate
    at one None check, with no host/device syncs."""
    enabled: bool = False
    # append a registry snapshot to this JSONL file every
    # ``steps_per_snapshot`` steps (0 = only on demand)
    jsonl_path: Optional[str] = None
    steps_per_snapshot: int = 0
    # also fan snapshots out through the MonitorMaster sinks at the same
    # cadence (TensorBoard / W&B / CSV, "Telemetry/*" series)
    publish_to_monitor: bool = True
    # chrome-trace span export path (written by engine.export_trace())
    chrome_trace_path: Optional[str] = None
    # the JAX compile watchdog's storm threshold (parsed; a kernel library
    # builds once per source, so the port's build watchdog has no storm)
    compile_storm_threshold: int = 8
    # hardware peak for the MFU gauge, per device; 0 = auto (DS_PEAK_TFLOPS
    # env, else the accelerator's device table, else MFU reads 0)
    peak_tflops_per_chip: float = 0.0
    health: HealthConfig = sub(HealthConfig)
    events: EventsConfig = sub(EventsConfig)
    profile: ProfileConfig = sub(ProfileConfig)
    metrics_port: Optional[int] = None
    sampler: SamplerConfig = sub(SamplerConfig)
    slo: SloConfig = sub(SloConfig)
    ctl: CtlConfig = sub(CtlConfig)


def get_telemetry_config(param_dict: dict) -> TelemetryConfig:
    """Parse the ``telemetry`` section: dict, bool/0/1, "on"/"off", or null
    (= defaults). The sub-blocks accept the same shorthands; enabling a
    sub-block implies telemetry itself unless the user explicitly disabled
    it, a ``metrics_port`` implies it too, and slo/ctl imply the sampler."""
    t = param_dict.get("telemetry", {})
    if t is None:
        t = {}
    elif isinstance(t, str):
        if t not in ("on", "off"):
            raise ValueError(f"telemetry={t!r} (expected 'on', 'off', "
                             "a bool, or a config dict)")
        t = {"enabled": t == "on"}
    elif isinstance(t, (bool, int)):
        t = {"enabled": bool(t)}
    elif isinstance(t, TelemetryConfig):
        return t
    elif not isinstance(t, dict):
        raise ValueError(f"telemetry section must be a dict, bool, or "
                         f"'on'/'off'; got {type(t).__name__}")
    t = dict(t)

    def _sub_shorthand(key):
        sub_ = t.get(key, {})
        if sub_ is None:
            sub_ = {}
        elif isinstance(sub_, str):
            if sub_ not in ("on", "off"):
                raise ValueError(f"telemetry.{key}={sub_!r} (expected 'on', "
                                 "'off', a bool, or a config dict)")
            sub_ = {"enabled": sub_ == "on"}
        elif isinstance(sub_, (bool, int)):
            sub_ = {"enabled": bool(sub_)}
        elif isinstance(sub_, dict):
            sub_ = dict(sub_)
        t[key] = sub_
        return sub_

    health = _sub_shorthand("health")
    events = _sub_shorthand("events")
    sampler = _sub_shorthand("sampler")
    slo = _sub_shorthand("slo")
    ctl = _sub_shorthand("ctl")
    if t.get("profile") is None and "profile" in t:
        t["profile"] = {}
    for s in (health, events, sampler, slo, ctl):
        if isinstance(s, dict) and s.get("enabled") and "enabled" not in t:
            t["enabled"] = True
    if t.get("metrics_port") is not None and "enabled" not in t:
        t["enabled"] = True
    if isinstance(sampler, dict) and "enabled" not in sampler and (
            (isinstance(slo, dict) and slo.get("enabled"))
            or (isinstance(ctl, dict) and ctl.get("enabled"))):
        sampler["enabled"] = True
    return TelemetryConfig(**t)


def refuse_unported(tcfg: TelemetryConfig, engine: str = "train") -> None:
    """Raise for a telemetry setting that the JAX package acts on only
    through its async serving front-end, for the port's ``engine``
    ("train" or "serve"; only when telemetry is on: off, the JAX engines act
    on none of them). The training engine acts on ``health``, ``sampler``,
    ``slo`` and ``metrics_port``; the serving engine, as the JAX one,
    ignores ``health``."""
    if engine not in ("train", "serve"):
        raise ValueError(f"engine={engine!r} (expected 'train' or 'serve')")
    if not tcfg.enabled:
        return
    item = "queue 1: async serving"
    if tcfg.ctl.enabled:
        not_ported("telemetry.ctl (the adaptive controller wired into a server)", item)
    if engine == "serve":
        for name in ("sampler", "slo"):
            if getattr(tcfg, name).enabled:
                not_ported(f"telemetry.{name} beside a serving engine", item)
        if tcfg.metrics_port is not None:
            not_ported("telemetry.metrics_port (/metrics) on a serving engine", item)


@config
class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@config
class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@config
class CSVConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@config
class DeepSpeedMonitorConfig(ConfigModel):
    tensorboard: TensorBoardConfig = sub(TensorBoardConfig)
    wandb: WandbConfig = sub(WandbConfig)
    csv_monitor: CSVConfig = sub(CSVConfig)
