"""The kernel builder's library names (``ops/kernels/build.py``): each
hashes its source and every header in ``csrc/``, so an edited or a new
header can never leave a stale library loaded. Nothing is compiled here."""

import shutil

from deepspeed_tpu_torch.ops.kernels import build


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
