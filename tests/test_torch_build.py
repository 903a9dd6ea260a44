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


def test_build_compiles_every_source_once_for_sm90a(toolkit, monkeypatch):
    lib = _build.build()
    assert lib == _build.library_path()
    assert os.path.isfile(lib)
    assert "Used 42 registers" in _build.build_log()
    calls = (toolkit / "calls.log").read_text().splitlines()
    compiles = [c for c in calls if "-c" in c.split()]
    assert len(compiles) == len(_build.sources())
    assert sorted(os.path.basename(p) for p in _build.sources()) == [
        "fk_derivatives.cu", "fk_derivatives_wide.cu",
        "fk_derivatives_xl.cu", "fused_tick.cu", "fused_tick_10.cu",
        "fused_tick_14.cu", "fused_tick_wide.cu", "gjk_hull.cu",
        "pullback_resolve.cu", "pullback_resolve_cta.cu",
        "pullback_resolve_cta_64.cu", "pullback_resolve_wide.cu",
        "pullback_resolve_wide_14.cu", "pullback_resolve_wide_18.cu",
        "pullback_resolve_wide_22.cu", "pullback_resolve_wide_25.cu",
        "pullback_resolve_wide_28.cu", "pullback_resolve_wide_31.cu"]
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert all(f"-I {_build.CSRC_DIR}" in c for c in compiles)
    assert sum("-shared" in c.split() for c in calls) == 1
    # built once per source hash: a second call runs no compiler
    assert _build.build() == lib
    assert len((toolkit / "calls.log").read_text().splitlines()) == len(calls)
    assert sorted(os.listdir(os.path.dirname(lib))) == sorted(
        ["build.log", _build.LIB_NAME])
    times = _build.build_times()
    assert sorted(times["nvcc_s"]) == sorted(
        os.path.basename(p) for p in _build.sources())
    assert 0 <= times["link_s"] <= times["total_s"]
    # a process that finds the library built has no build to report
    monkeypatch.setattr(_build, "_built", {})
    assert _build.build() == lib
    assert _build.build_times() == {}


SLOW_NVCC = """#!/bin/sh
# stand-in for nvcc that notes how many run at once
dir="$(dirname "$0")"
prev=''
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
touch "$dir/running.$$"
ls "$dir" | grep -c '^running' >> "$dir/at_once.log"
sleep 0.2
rm "$dir/running.$$"
echo built > "$out"
"""


@pytest.mark.parametrize("cpus", [None, 2])
def test_compile_into_caps_the_processes_at_once(toolkit, tmp_path,
                                                 monkeypatch, cpus):
    """compile_into runs at most one nvcc a CPU at a time (one at a time
    where the host's CPU count is unknown); it reports the cap and the
    host's CPUs, and every source is built."""
    (toolkit / "nvcc").write_text(SLOW_NVCC)
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    work = tmp_path / "work"
    work.mkdir()
    built = _build.compile_into(str(work))
    # one line a compile, then the link's
    seen = [int(x) for x in (toolkit / "at_once.log").read_text().split()]
    assert len(seen) == len(_build.sources()) + 1
    assert max(seen[:-1]) <= (cpus or 1)
    assert built["jobs"] == (cpus or 1) and built["cpus"] == cpus
    assert sorted(built["nvcc_s"]) == sorted(
        os.path.basename(p) for p in _build.sources())


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


def test_compile_probe_cold_build_times_each_source(toolkit):
    """experiments/compile_probe's cold build: every source compiled into
    a temporary directory (never the package's build directory), each
    with its own seconds, then the link."""
    from rmp_tpu_torch.experiments import compile_probe

    built = compile_probe.cold_build()
    assert sorted(built["nvcc_s"]) == sorted(
        os.path.basename(p) for p in _build.sources())
    assert all(0 <= s <= built["total_s"] for s in built["nvcc_s"].values())
    assert not os.path.exists(_build.BUILD_DIR)
    calls = (toolkit / "calls.log").read_text().splitlines()
    assert sum("-c" in c.split() for c in calls) == len(_build.sources())
