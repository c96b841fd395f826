"""The environment report (``deepspeed_tpu_torch/env_report.py``, ``cli
report``), the counterpart of the JAX package's ``env_report.py`` /
``dscli report``: one row per kernel library of ``ops/kernels/build.py``
and the host library, built or not as their files say; the torch, CUDA and
nvcc versions (nvcc reported missing here); the devices (none here), host
and device memory; the latest telemetry snapshot, rendered as the
``health`` screen renders it; the same sections as the JAX report."""

import json

import pytest
import torch

from deepspeed_tpu import env_report as jax_env_report
from deepspeed_tpu_torch import cli, env_report
from deepspeed_tpu_torch.monitor.health import read_last_snapshots, render_health_table
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.kernels import build

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    return tmp_path


def test_op_report_reads_the_build_directory(build_dir, capsys):
    rows = dict(env_report.op_report())
    assert set(rows) == set(build.SOURCES) | {"host"}
    assert not any(rows.values())
    build.library_path("spatial_bias_add").write_bytes(b"")
    native.library_path().write_bytes(b"")
    rows = dict(env_report.op_report())
    assert rows["spatial_bias_add"] and rows["host"]
    assert not rows["flash_attention"]
    out = capsys.readouterr().out
    assert "csrc/spatial_bias_add.cu" in out and "csrc/host/*.cpp" in out


def test_versions_name_torch_and_a_missing_nvcc(monkeypatch, capsys):
    def no_nvcc():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    path, why = env_report.nvcc_version()
    assert path is None and "nvcc not found" in why
    env_report.version_report()
    out = capsys.readouterr().out
    assert torch.__version__ in out and "nvcc not found" in out


def test_devices_and_memory_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the report's no-device branch; a card is present")
    assert env_report.device_report() == []
    env_report.memory_report()
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "host RSS" in out


def test_telemetry_snapshot_is_the_health_screen(tmp_path, capsys):
    path = tmp_path / "telemetry.jsonl"
    recs = [{"step": i, "ts": 100.0 + i, "metrics": {"train/loss": 2.0 - i / 10}} for i in (1, 2)]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    env_report.telemetry_report(str(path))
    out = capsys.readouterr().out
    last = read_last_snapshots(str(path), 2)
    assert render_health_table(last[-1], last[-2]) in out
    env_report.telemetry_report(str(tmp_path / "missing.jsonl"))
    assert "no parseable records" in capsys.readouterr().out


def test_cli_report_has_the_jax_sections(build_dir, capsys):
    assert cli.main(["report"]) == 0
    got = capsys.readouterr().out
    jax_env_report.main(hide_operator_status=True)
    want = capsys.readouterr().out
    for header in ("devices", "device memory"):
        assert f"\n{header}\n" in want and f"\n{header}\n" in got
    assert "kernel library report" in got and "framework / toolchain versions" in got


def test_main_hides_the_library_rows(build_dir, capsys):
    env_report.main(hide_operator_status=True)
    assert "kernel library report" not in capsys.readouterr().out
