"""Timing and trace capture.

The port's `rmp_tpu/utils/profiling.py`: `block` waits for the device,
`time_first_and_steady` (and JAX's name for it, `time_jitted`) separates a
callable's first call (the kernels' build and load, PyTorch's lazy
initialisation) from its steady per-call time, and `trace` captures a
torch.profiler trace as a Chrome trace file, which
experiments/trace_report.py reads.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def block(tree):
    """`tree` once the work that made its tensors is done: a device
    synchronize for every card that holds one of them."""
    for index in sorted({t.device.index or 0 for t in _tensors(tree)
                         if t.device.type == "cuda"}):
        torch.cuda.synchronize(index)
    return tree


def time_first_and_steady(fn, *args, iters: int = 10, warmup: int = 2):
    """(first_call_s, per_call_s) of fn(*args): the first call alone on
    the host clock, then `iters` calls after `warmup - 1` more, each run
    ending in `block`. On a card the steady time is taken by CUDA events
    around the calls; on the CPU by the host clock."""
    t0 = time.perf_counter()
    out = block(fn(*args))
    first_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        out = block(fn(*args))
    on_card = any(t.device.type == "cuda" for t in _tensors(out))
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return first_s, start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block(out)
    return first_s, (time.perf_counter() - t0) / iters


# JAX's name: PyTorch runs eagerly, so the first call holds no XLA compile
# but the kernels' build or load and PyTorch's lazy initialisation; JAX's
# compile knobs (unrolled or scanned substeps, donated buffers,
# tick_unroll) have no counterpart here
time_jitted = time_first_and_steady


@contextlib.contextmanager
def trace(path: str, with_stack: bool = True):
    """A torch.profiler capture of the block (host ops, and the card's
    kernels, copies and sets where CUDA is available), written to `path`
    as a Chrome trace when the block ends; yields the path. with_stack
    records each host op's Python stack, which trace_report follows to the
    line that launched a kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
