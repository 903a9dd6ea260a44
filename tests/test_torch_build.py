"""The port's kernel build (rmp_tpu_torch/_build.py) on a host without the
CUDA toolkit: the build logic runs against a stand-in nvcc script that
writes its -o target, and a missing nvcc raises."""
import os
import stat

import pytest
import torch

from rmp_tpu_torch import _build

torch.set_num_threads(1)

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: record the call, write the -o target
echo "$@" >> "$(dirname "$0")/calls.log"
prev=''
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
if [ -n "$FAIL_NVCC" ]; then echo "error: stand-in failure"; exit 1; fi
echo "ptxas info    : Used 42 registers"
echo built > "$out"
"""


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return bin_dir


def test_build_compiles_every_source_once_for_sm90a(toolkit):
    lib = _build.build()
    assert lib == _build.library_path()
    assert os.path.isfile(lib)
    assert "Used 42 registers" in _build.build_log()
    calls = (toolkit / "calls.log").read_text().splitlines()
    compiles = [c for c in calls if "-c" in c.split()]
    assert len(compiles) == len(_build.sources())
    assert sorted(os.path.basename(p) for p in _build.sources()) == [
        "fk_derivatives.cu", "fused_tick.cu", "gjk_hull.cu",
        "pullback_resolve.cu"]
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert all(f"-I {_build.CSRC_DIR}" in c for c in compiles)
    assert sum("-shared" in c.split() for c in calls) == 1
    # built once per source hash: a second call runs no compiler
    assert _build.build() == lib
    assert len((toolkit / "calls.log").read_text().splitlines()) == len(calls)
    assert sorted(os.listdir(os.path.dirname(lib))) == sorted(
        ["build.log", _build.LIB_NAME])


def test_failed_compile_raises_and_leaves_no_library(toolkit, monkeypatch):
    monkeypatch.setenv("FAIL_NVCC", "1")
    with pytest.raises(RuntimeError, match="stand-in failure"):
        _build.build()
    assert not os.path.exists(_build.library_path())
    assert os.listdir(os.path.dirname(_build.library_path())) == []


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path / "none"),))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    first = _build.source_hash()
    (src / "a.cu").write_text("// two\n")
    assert _build.source_hash() != first


def test_source_hash_follows_the_headers(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    assert _build.headers() == [str(src / "common.cuh")]
    first = _build.source_hash()
    (src / "common.cuh").write_text("// two\n")
    assert _build.source_hash() != first
