"""The port's profiling and trace tools (rmp_tpu_torch/utils/profiling.py,
experiments/trace_report.py, profile_tick.py, gjk_warm_accuracy.py) on the
CPU. tests/test_subsystems.py's trace-parsing cases, translated to a
synthetic torch.profiler Chrome trace: only device events count (kernels,
memcpys, memsets; host ops and runtime calls never), sums per kernel and
per source (a kernel's correlation id to the runtime call that launched it
and the innermost repository frame of the host's Python stack, the repo
prefix stripped; sourceless kernels under their category), and the
fallback to every complete event of a device process when the trace has
no categories."""
import json

import numpy as np
import torch

from rmp_tpu_torch.experiments import gjk_warm_accuracy, profile_tick
from rmp_tpu_torch.experiments import trace_report as tr
from rmp_tpu_torch.utils import profiling

torch.set_num_threads(1)

HOST, DEV = 4242, 0


def synthetic_trace():
    """Metadata and complete events as torch.profiler exports them: a host
    thread with a Python stack, an op and two launches; two kernels, a
    memcpy and a memset on the card; a kernel whose launch has no
    repository frame."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": HOST,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": DEV,
         "args": {"name": "GPU 0"}},
    ]
    host = [
        # the Python stack: a repo frame around a torch frame around both
        # launches, and a second repo frame around the second only
        {"ph": "X", "cat": "python_function", "pid": HOST, "tid": 1,
         "ts": 0, "dur": 100,
         "name": tr.REPO_PREFIX + "rmp_tpu_torch/core.py(41): fn"},
        {"ph": "X", "cat": "python_function", "pid": HOST, "tid": 1,
         "ts": 5, "dur": 90,
         "name": "/usr/lib/python3/site-packages/torch/functional.py(9): "
                 "einsum"},
        {"ph": "X", "cat": "python_function", "pid": HOST, "tid": 1,
         "ts": 50, "dur": 40,
         "name": tr.REPO_PREFIX + "rmp_tpu_torch/ops/cuda_tick.py(425): "
                 "fused_qdd"},
        {"ph": "X", "cat": "cpu_op", "pid": HOST, "tid": 1, "ts": 10,
         "dur": 20, "name": "aten::einsum", "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "pid": HOST, "tid": 1, "ts": 12,
         "dur": 3, "name": "cudaLaunchKernel", "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "pid": HOST, "tid": 1, "ts": 60,
         "dur": 3, "name": "cudaLaunchKernel", "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "pid": HOST, "tid": 2, "ts": 70,
         "dur": 3, "name": "cudaLaunchKernel", "args": {"correlation": 3}},
    ]
    device = [
        {"ph": "X", "cat": "kernel", "pid": DEV, "tid": 7, "ts": 20,
         "dur": 10, "name": "gemv", "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "pid": DEV, "tid": 7, "ts": 70,
         "dur": 5, "name": "fused_qdd_kernel", "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "pid": DEV, "tid": 7, "ts": 80,
         "dur": 4, "name": "gemv", "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": DEV, "tid": 8, "ts": 90,
         "dur": 7, "name": "Memcpy HtoD", "args": {}},
        {"ph": "X", "cat": "gpu_memset", "pid": DEV, "tid": 8, "ts": 98,
         "dur": 1, "name": "Memset", "args": {}},
    ]
    return meta, host, device


def test_trace_report_device_events_and_sums():
    meta, host, device = synthetic_trace()
    events = meta + host + device
    dev = tr.device_events(events)
    assert sorted(e["name"] for e in dev) == sorted(e["name"]
                                                    for e in device)
    assert tr.device_op_durations(dev) == {"gemv": 14, "fused_qdd_kernel": 5,
                                           "Memcpy HtoD": 7, "Memset": 1}
    assert tr.device_op_counts(dev) == {"gemv": 2, "fused_qdd_kernel": 1,
                                        "Memcpy HtoD": 1, "Memset": 1}
    # gemv 1: the innermost repo frame around its launch is core.py:41
    # (the torch frame between is not the repository's); fused_qdd: the
    # inner repo frame; gemv 3: launched from a thread without a stack
    assert tr.device_source_durations(dev, events) == {
        "rmp_tpu_torch/core.py:41": 10,
        "rmp_tpu_torch/ops/cuda_tick.py:425": 5,
        "<kernel>": 4, "<gpu_memcpy>": 7, "<gpu_memset>": 1}


def test_trace_report_falls_back_to_device_processes():
    """Without categories, every complete event of a process named a
    device counts, and none of the host's."""
    meta, host, device = synthetic_trace()
    bare = meta + [{k: v for k, v in e.items() if k != "cat"}
                   for e in host + device]
    names = sorted(e["name"] for e in tr.device_events(bare))
    assert names == sorted(e["name"] for e in device)


def test_trace_report_reads_a_real_cpu_trace(tmp_path):
    """profiling.trace writes a Chrome trace that load_trace_events reads;
    a CPU run's trace holds host ops and Python frames, no device event;
    the report of a CPU rollout says so (0 device us)."""
    path = str(tmp_path / "t.json")
    with profiling.trace(path):
        x = torch.ones(8, 8)
        (x @ x).sum()
    events = tr.load_trace_events(path)
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert tr.device_events(events) == []
    rep = tr.report("two_joint/01_target_rmp_only", 2, 2, "capsule", "cpu")
    assert rep["device_us"] == 0 and rep["ticks"] == 2
    assert rep["counts"] == {} and rep["source_totals"] == {}
    json.dumps(rep)


def test_time_first_and_steady_and_block():
    calls = []

    def fn(x):
        calls.append(1)
        return dict(y=x * 2)
    first, steady = profiling.time_first_and_steady(fn, torch.ones(3),
                                                    iters=3, warmup=2)
    assert first >= 0 and steady >= 0 and len(calls) == 1 + 1 + 3
    tree = dict(a=torch.ones(2), b=[torch.zeros(1)])
    assert profiling.block(tree) is tree


def test_profile_tick_stages_on_the_cpu():
    """Every stage of the flagship tick runs at B = 4 and times."""
    rep = profile_tick.profile(4, torch.device("cpu"), iters=1)
    assert list(rep["stages"]) == [name for name, _, _ in
                                   profile_tick.stages(4, "cpu")]
    assert all(r["ms"] > 0 for r in rep["stages"].values())
    assert rep["control_steps_per_s"] > 0


def test_gjk_warm_accuracy_tick_stats_and_a_short_run():
    """tick_stats' bands on a synthetic case, and two hull ticks of the
    flagship at 128 envs: every band's error finite and small at the
    reset's converged carry, q̈ finite."""
    d_cold = torch.tensor([0.05, 0.2, 0.3, 0.9])
    d_warm = d_cold + torch.tensor([1e-3, 2e-3, 0.0, 5e-3])
    st = gjk_warm_accuracy.tick_stats(d_warm, d_cold)
    assert st["frac@0-0.1"] == 0.25 and st["frac@0.1-0.5"] == 0.5
    assert np.isclose(st["max@0.1-0.5"], 2e-3)
    assert np.isclose(st["mean@0.1-0.5"], 1e-3)
    rep = gjk_warm_accuracy.run_one("franka/06_cluttered_environment", 4,
                                    128, 2, 0, torch.device("cpu"))
    assert rep["abs_err_max_m@0-0.1"] < 1e-2
    assert np.isfinite(rep["qdd_abs_err_max"])
    assert rep["qdd_rms_cold"] > 0
