"""The port's telemetry plane (counterpart of ``deepspeed_tpu/monitor``):
the metrics registry, the flight recorder, the step tracer with the profile
window and the build watchdog, the monitor sinks, the health observatory
(sentinels, detectors, memory gauges, the health screen), the ``/metrics``
exporter, the snapshot sampler, the SLO engine, the adaptive controller's
core, the request anatomy and the ``top`` dashboard. The controller's
wiring into a live server, ``/metrics`` on the serving front-end and the
SLO engine inside a server wait for async serving (ROADMAP.md queue 1)."""

from deepspeed_tpu_torch.monitor.anatomy import request_anatomy, trace_anatomy
from deepspeed_tpu_torch.monitor.config import (CtlConfig, DeepSpeedMonitorConfig, EventsConfig,
                                                HealthConfig, ProfileConfig, SamplerConfig,
                                                SloConfig, TelemetryConfig, get_monitor_config,
                                                get_telemetry_config)
from deepspeed_tpu_torch.monitor.controller import (AdaptiveController, DecisionCore, KnobSpec,
                                                    explain_decisions, knobs_from_serving,
                                                    recorded_decisions, replay_decisions)
from deepspeed_tpu_torch.monitor.events import (EVENT_KINDS, Event, FlightRecorder,
                                                TaggedRecorder, dump_events_jsonl,
                                                export_fleet_trace, export_recorder_metrics,
                                                export_serving_trace, get_flight_recorder,
                                                render_fleet_trace, render_serving_trace)
from deepspeed_tpu_torch.monitor.exporter import MetricsExporter, render_exposition
from deepspeed_tpu_torch.monitor.health import (HealthMonitor, StepHealth, compute_sentinels,
                                                health_summary, host_rss_bytes,
                                                make_bucket_assignment, render_health_table,
                                                render_summary_table, sample_memory_gauges,
                                                sentinel_to_dict)
from deepspeed_tpu_torch.monitor.metrics import (MetricsRegistry, get_registry,
                                                 parse_prometheus_text, validate_snapshot)
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster, csvMonitor
from deepspeed_tpu_torch.monitor.sampler import MetricsSampler, sampler_from_config
from deepspeed_tpu_torch.monitor.slo import (SloEngine, SloObjective, parse_objectives,
                                             serving_objectives, slo_from_config)
from deepspeed_tpu_torch.monitor.trace import (CompileWatchdog, ProfileWindow, StepTracer,
                                               get_compile_watchdog, get_tracer)

__all__ = [
    "request_anatomy", "trace_anatomy",
    "CtlConfig", "DeepSpeedMonitorConfig", "EventsConfig", "HealthConfig", "ProfileConfig",
    "SamplerConfig", "SloConfig", "TelemetryConfig", "get_monitor_config",
    "get_telemetry_config",
    "AdaptiveController", "DecisionCore", "KnobSpec", "explain_decisions", "knobs_from_serving",
    "recorded_decisions", "replay_decisions",
    "EVENT_KINDS", "Event", "FlightRecorder", "TaggedRecorder", "dump_events_jsonl",
    "export_fleet_trace", "export_recorder_metrics", "export_serving_trace",
    "get_flight_recorder", "render_fleet_trace", "render_serving_trace",
    "MetricsExporter", "render_exposition",
    "HealthMonitor", "StepHealth", "compute_sentinels", "health_summary", "host_rss_bytes",
    "make_bucket_assignment", "render_health_table", "render_summary_table",
    "sample_memory_gauges", "sentinel_to_dict",
    "MetricsRegistry", "get_registry", "parse_prometheus_text", "validate_snapshot",
    "MonitorMaster", "csvMonitor",
    "MetricsSampler", "sampler_from_config",
    "SloEngine", "SloObjective", "parse_objectives", "serving_objectives", "slo_from_config",
    "CompileWatchdog", "ProfileWindow", "StepTracer", "get_compile_watchdog", "get_tracer",
]
