"""The port's telemetry substrate (counterpart of ``deepspeed_tpu/monitor``):
the metrics registry, the flight recorder, the step tracer with the profile
window and the build watchdog, the monitor sinks and the memory gauges.
The sampler, SLO engine, controller, exporter, latency anatomy and health
observatory are not ported (ROADMAP.md queue 1, telemetry and control
plane)."""

from deepspeed_tpu_torch.monitor.config import (CtlConfig, DeepSpeedMonitorConfig, EventsConfig,
                                                HealthConfig, ProfileConfig, SamplerConfig,
                                                SloConfig, TelemetryConfig, get_monitor_config,
                                                get_telemetry_config)
from deepspeed_tpu_torch.monitor.events import (EVENT_KINDS, Event, FlightRecorder,
                                                TaggedRecorder, dump_events_jsonl,
                                                export_fleet_trace, export_recorder_metrics,
                                                export_serving_trace, get_flight_recorder,
                                                render_fleet_trace, render_serving_trace)
from deepspeed_tpu_torch.monitor.health import host_rss_bytes, sample_memory_gauges
from deepspeed_tpu_torch.monitor.metrics import (MetricsRegistry, get_registry,
                                                 parse_prometheus_text, validate_snapshot)
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster, csvMonitor
from deepspeed_tpu_torch.monitor.trace import (CompileWatchdog, ProfileWindow, StepTracer,
                                               get_compile_watchdog, get_tracer)

__all__ = [
    "CtlConfig", "DeepSpeedMonitorConfig", "EventsConfig", "HealthConfig", "ProfileConfig",
    "SamplerConfig", "SloConfig", "TelemetryConfig", "get_monitor_config",
    "get_telemetry_config",
    "EVENT_KINDS", "Event", "FlightRecorder", "TaggedRecorder", "dump_events_jsonl",
    "export_fleet_trace", "export_recorder_metrics", "export_serving_trace",
    "get_flight_recorder", "render_fleet_trace", "render_serving_trace",
    "host_rss_bytes", "sample_memory_gauges",
    "MetricsRegistry", "get_registry", "parse_prometheus_text", "validate_snapshot",
    "MonitorMaster", "csvMonitor",
    "CompileWatchdog", "ProfileWindow", "StepTracer", "get_compile_watchdog", "get_tracer",
]
