"""Device time of a rollout by kernel and by the line that launched it.

The port's `experiments/trace_report.py`. profile_tick.py times stages
standalone, as upper bounds; this tool attributes the device time of a real
batched rollout: it runs a short rollout under torch.profiler
(utils/profiling.trace, Python stacks on), reads the Chrome trace, and sums
the device events -- kernels, memcpys and memsets, never host ops -- by
kernel name or by source. A kernel's source follows its correlation id to
the runtime call that launched it, and from there to the innermost frame
of the host's Python stack that lies in this repository (the prefix
stripped); a kernel with none is bucketed under its category.

    python -m rmp_tpu_torch.experiments.trace_report [--env NAME]
        [--batch 4096] [--ticks 20] [--top 25] [--by-source]
        [--geometry capsule|hull] [--cpu] [--json]

On the CPU the trace holds no device events, and the tool says so.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import os
import tempfile

# Chrome-trace categories of torch.profiler's device events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that launch device work and carry its correlation id
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
STACK_CATEGORY = "python_function"

REPO_PREFIX = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))) + os.sep


def load_trace_events(path: str) -> list:
    """The traceEvents of a Chrome trace file (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _device_pids(events) -> set:
    """Processes whose name metadata names a device (GPU, CUDA), not the
    host."""
    names = {e.get("pid"): str(e.get("args", {}).get("name", "")).lower()
             for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    return {pid for pid, name in names.items()
            if any(k in name for k in ("gpu", "cuda", "device"))
            and "host" not in name and "cpu" not in name}


def device_events(events) -> list:
    """The complete events of the device: kernels, memcpys and memsets by
    their category. A trace without categories (no 'cat' on any complete
    event) falls back to every complete event of a device process."""
    complete = [e for e in events if e.get("ph") == "X"]
    if any("cat" in e for e in complete):
        return [e for e in complete
                if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    pids = _device_pids(events)
    return [e for e in complete if e.get("pid") in pids]


def device_op_durations(events) -> collections.Counter:
    """{kernel name: total us} of device events."""
    totals = collections.Counter()
    for e in events:
        totals[e.get("name", "?")] += e.get("dur", 0)
    return totals


def device_op_counts(events) -> collections.Counter:
    """{kernel name: device events recorded}: a caller that knows how
    often a kernel was launched can tell a trace that dropped records."""
    return collections.Counter(e.get("name", "?") for e in events)


def _frame_source(name: str) -> str | None:
    """'path:line' of a Python frame event named 'path(line): function',
    relative to the repository, or None for a frame outside it."""
    head, sep, _ = name.partition("): ")
    path, _, line = head.rpartition("(")
    if not sep or not path:
        return None
    if path.startswith(REPO_PREFIX):
        path = path[len(REPO_PREFIX):]
    elif os.path.isabs(path) or path.startswith("<"):
        return None
    return f"{path}:{line}"


def _launch_sources(events) -> dict:
    """{correlation id: 'path:line'}: for each launching runtime call, the
    innermost enclosing Python frame (same process and thread) that lies
    in the repository."""
    frames = collections.defaultdict(list)
    launches = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        key = (e.get("pid"), e.get("tid"))
        if cat == STACK_CATEGORY:
            src = _frame_source(e.get("name", ""))
            if src is not None:
                frames[key].append((e["ts"], e["ts"] + e.get("dur", 0),
                                    src))
        elif cat in RUNTIME_CATEGORIES and "correlation" in e.get("args", {}):
            launches[key].append((e["ts"], e["args"]["correlation"]))
    out = {}
    for key, calls in launches.items():
        spans = sorted(frames.get(key, ()))
        starts = [s for s, _, _ in spans]
        for ts, corr in calls:
            # the innermost enclosing frame starts last among those open
            i = bisect.bisect_right(starts, ts) - 1
            while i >= 0:
                s, t_end, src = spans[i]
                if t_end >= ts:
                    out[corr] = src
                    break
                i -= 1
    return out


def device_source_durations(dev_events, events) -> collections.Counter:
    """{'path:line': total us} of device events by the repository line
    that launched each (events: the whole trace, for the launches and
    stacks); a device event with none under '<category>'."""
    sources = _launch_sources(events)
    totals = collections.Counter()
    for e in dev_events:
        src = sources.get(e.get("args", {}).get("correlation"))
        totals[src or f"<{e.get('cat', 'device')}>"] += e.get("dur", 0)
    return totals


def report(env_name: str, batch: int, ticks: int, geometry: str, device,
           by_source: bool = False) -> dict:
    """A rollout of `ticks` batched ticks ('solve') after one warm-up
    tick, under utils/profiling.trace: device us in all and per tick, the
    totals by kernel (or by source), the totals by source in any case
    (the same trace), and the device events recorded by kernel."""
    from rmp_tpu_torch import envs
    from rmp_tpu_torch.utils import profiling

    env = envs.make(env_name, device=device)
    env.resolve_method = "solve"
    env.collision_geometry = geometry
    params = env.gather_params()
    states = envs.make_batched_reset(env, batch)()
    warm = envs.make_batched_rollout(env, 1, with_aux=False)
    rollout = envs.make_batched_rollout(env, ticks, with_aux=False)
    states, _ = warm(states, params)
    profiling.block(states.sim.q)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profiling.trace(path):
            final, _ = rollout(states, params)
            profiling.block(final.sim.q)
        events = load_trace_events(path)
    dev = device_events(events)
    sources = device_source_durations(dev, events)
    totals = sources if by_source else device_op_durations(dev)
    total = sum(totals.values())
    return dict(env=env_name, batch=batch, ticks=ticks, geometry=geometry,
                device=str(device), device_us=total,
                device_us_per_tick=total / ticks,
                by="source" if by_source else "kernel",
                totals=dict(totals.most_common()),
                source_totals=dict(sources.most_common()),
                counts=dict(device_op_counts(dev)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--by-source", action="store_true",
                    help="sum by the repository line that launched each "
                         "kernel instead of by kernel name")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--json", action="store_true",
                    help="print the whole report as one JSON object")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import card_name, device_of

    device = device_of(args.cpu)
    rep = report(args.env, args.batch, args.ticks, args.geometry, device,
                 args.by_source)
    rep["card"] = card_name(device)
    if args.json:
        print(json.dumps(rep))
        return
    total = rep["device_us"]
    if total == 0:
        print("no device events in the trace (a CPU run records none): run "
              "this tool on the card")
        return
    steps = args.batch * args.ticks
    print(f"device time {total / 1e3:.3f} ms for {args.ticks} ticks x "
          f"{args.batch} envs ({rep['device_us_per_tick']:.1f} us a tick; "
          f"{steps / (total / 1e6):,.0f} steps/s if device-bound) "
          f"[{rep['card']}]")
    label = "source" if args.by_source else "device kernel"
    print(f"{label:70s} {'us':>10s}  share")
    for name, us in list(rep["totals"].items())[:args.top]:
        print(f"{name[:70]:70s} {us:10.1f}  {us / total:6.1%}")


if __name__ == "__main__":
    main()
