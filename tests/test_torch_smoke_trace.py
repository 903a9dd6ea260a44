"""chip_smoke.py's reading of a torch.profiler trace (device_kernels), on
stand-in events: a device record of work that ran before the trace's first
host event is not the trace's, whatever kernel it names."""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
PAD_US = cs.TRACE_PAD_S * 1e6


def event(name, device_type, start_us, annotation=False):
    return SimpleNamespace(name=name, device_type=device_type,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us))


def kept_span(calls, first_us):
    """`calls` launch calls from first_us on, each with its kernel 5 us
    after it, behind the profiler's step span at 0."""
    out = [event("ProfilerStep#1", CPU, 0.0, annotation=True)]
    for k in range(calls):
        t = first_us + 50.0 * k
        out += [event("cudaLaunchKernel", CPU, t),
                event("pullback_resolve_kernel<2>", CUDA, t + 5.0)]
    return out


@pytest.mark.parametrize("late_us", [-1.0, -PAD_US / 2 - 1.0, -5 * PAD_US])
def test_records_of_earlier_work_are_dropped(late_us):
    """Two kernels of the warm-up step, delivered into the kept trace, start
    before its pad; the kept span's ten stay."""
    first = PAD_US
    events = kept_span(10, first) + [
        event("pullback_resolve_kernel<2>", CUDA, late_us),
        event("pullback_resolve_kernel<2>", CUDA, late_us - 3.0)]
    assert len(cs.device_records(events)) == 12
    kept = cs.device_kernels(events)
    assert len(kept) == 10
    assert min(e.time_range.start for e in kept) == first + 5.0


def test_every_record_of_the_span_is_kept():
    """A kernel whose record starts a little before its launch call (the
    two clocks disagree by microseconds) and the step span aside."""
    events = kept_span(3, PAD_US)
    events.append(event("other_kernel", CUDA, PAD_US - 2.0))
    events.append(event("ProfilerStep#1", CUDA, 0.0))
    names = [e.name for e in cs.device_kernels(events)]
    assert names.count("pullback_resolve_kernel<2>") == 3
    assert "other_kernel" in names and "ProfilerStep#1" not in names


def test_a_trace_with_no_host_event_keeps_every_record():
    events = [event("k", CUDA, -1e9), event("k", CUDA, 0.0)]
    assert len(cs.device_kernels(events)) == 2
