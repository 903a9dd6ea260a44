"""What "compile" costs in the port, against a steady tick.

The port's `experiments/compile_probe.py` and `compile_probe_unroll.py` in
one script. PyTorch runs eagerly: the port's compile is the `nvcc` build
of its kernels, their load, the first tick's lazy set-up (the model's
device tables, cuBLAS) and, for a serving host, the export of the step.
Measured, each on the card:

- the build of every `csrc/*.cu` from nothing: each source's nvcc wall
  seconds (at most one nvcc a CPU at a time), the link, the total. Where
  this process has already built the package's library
  (`_build.build_times`: the same `_build.compile_into` into a fresh
  directory), that build is the measurement; else the probe builds into
  a temporary directory (never rmp_tpu_torch/_build/);
- the cached load: the library's path from its source hash, and dlopen;
- the flagship's first tick against its steady tick at --batch envs
  (`utils/profiling.time_jitted`, synchronised on the card);
- the export (experiments/aot_export.py): trace, torch.export, save, load,
  the loaded artifact's first call and its steady call.

JAX's variants (unrolled against scanned substeps, donated buffers,
tick_unroll 1/2/4) are XLA compile knobs with no counterpart here; the
script does not imitate them. With --cpu the nvcc build and load are not
measured (the CPU runs the plain versions).

    python -m rmp_tpu_torch.experiments.compile_probe [--batch 4096]
        [--env NAME] [--cpu] [--out FILE]

The report goes to chiprun_out/compile_probe.json or --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from rmp_tpu_torch import _build, envs
from rmp_tpu_torch.experiments import aot_export
from rmp_tpu_torch.experiments.common import (card_name, device_of,
                                              report_path, synchronize)
from rmp_tpu_torch.utils.profiling import time_jitted


def cold_build() -> dict:
    """The kernels built from nothing into a temporary directory:
    {'nvcc_s': {source: seconds}, 'link_s', 'total_s'}."""
    work = tempfile.mkdtemp(prefix="rmp_cold_build_")
    try:
        built = _build.compile_into(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del built["log"]
    return built


def cached_load_s() -> float:
    """Seconds to find the package's built library (its source hash) and
    load it (built first if missing)."""
    _build.build()
    t0 = time.perf_counter()
    ctypes.CDLL(_build.library_path())
    return time.perf_counter() - t0


def tick_times(env_name: str, batch: int, device) -> dict:
    """The first and the steady tick of `env_name` (resolve 'solve') at
    `batch` envs."""
    env = envs.make(env_name, device=device)
    env.resolve_method = "solve"
    states = envs.make_batched_reset(env, batch)()
    tick = envs.make_batched_rollout(env, 1, with_aux=False)
    first, steady = time_jitted(tick, states, env.gather_params())
    return dict(first_tick_s=first, steady_tick_s=steady)


def export_times(env_name: str, batch: int, device, path: str) -> dict:
    """The export's stages and the loaded artifact's calls."""
    t0 = time.perf_counter()
    artifact, manifest, flat = aot_export.export_step(env_name, batch, 1,
                                                      device=device)
    export_all = time.perf_counter() - t0
    t0 = time.perf_counter()
    size = aot_export.save(path, artifact, manifest, flat)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, _, leaves = aot_export.load(path, device)
    load_s = time.perf_counter() - t0
    draws = aot_export.make_draws(manifest["draws"], device,
                                  manifest["rng_state"])
    first, steady = time_jitted(step, *leaves, *draws)
    return dict(trace_s=manifest["trace_s"], export_s=manifest["export_s"],
                export_step_s=export_all, save_s=save_s, load_s=load_s,
                first_call_s=first, steady_call_s=steady, bytes=size,
                graph_nodes=len(artifact.graph.nodes), ops=manifest["ops"])


def probe(env_name: str, batch: int, device, artifact_path: str) -> dict:
    """The report; on the card its 'build' says whether the build was this
    process's own (`in_process`) or the probe's cold build."""
    report = dict(env=env_name, batch=batch, device=str(device),
                  card=card_name(device), torch=torch.__version__)
    if device.type == "cuda":
        built = _build.build_times()
        report["build"] = dict(built or cold_build(),
                               in_process=bool(built),
                               cached_load_s=cached_load_s())
    report["tick"] = tick_times(env_name, batch, device)
    report["export"] = export_times(env_name, batch, device, artifact_path)
    synchronize(device)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = device_of(args.cpu)
    path = report_path("compile_probe.json", args.out)
    report = probe(args.env, args.batch, device,
                   os.path.join(os.path.dirname(path),
                                "compile_probe_step.pt2"))
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
