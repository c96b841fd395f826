"""The kernel builder's library names (``ops/kernels/build.py``): each
hashes its source and every header in ``csrc/``, so an edited or a new
header can never leave a stale library loaded. Nothing is compiled here."""

import shutil

import torch

from deepspeed_tpu_torch.ops.kernels import build

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def test_library_name_hashes_every_header(tmp_path, monkeypatch):
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = {n: build.library_path(n).name for n in build.SOURCES}
    assert len(set(names.values())) == len(names)
    (tmp_path / "wgmma_gemm.cuh").write_text((tmp_path / "wgmma_gemm.cuh").read_text() + "\n")
    edited = {n: build.library_path(n).name for n in build.SOURCES}
    assert all(edited[n] != names[n] for n in names)
    (tmp_path / "new_header.cuh").write_text("#pragma once\n")
    added = {n: build.library_path(n).name for n in build.SOURCES}
    assert all(added[n] != edited[n] for n in names)


def test_attention_header_is_hashed_into_both_attention_libraries(tmp_path, monkeypatch):
    """wgmma_attention.cuh (kernels A and D) is part of the name of both
    flash-attention libraries: editing it rebuilds the forward and the
    backward."""
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    libs = ("flash_attention", "flash_attention_bwd")
    for name in libs:
        assert '#include "wgmma_attention.cuh"' in (tmp_path / build.SOURCES[name]).read_text()
    before = {n: build.library_path(n).name for n in libs}
    header = tmp_path / "wgmma_attention.cuh"
    header.write_text(header.read_text() + "\n")
    assert all(build.library_path(n).name != before[n] for n in libs)
