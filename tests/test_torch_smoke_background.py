"""chip_smoke.py's untimed processes, which phase 19 runs together once its
timed work is done and phases 20 and 21 read (run_together, ran), and its
serving process's records (run_artifacts), run here on the CPU with
stand-in commands: nothing of them needs the card."""
import os
import sys
import time

import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)


def test_a_background_process_is_read_once_and_started_once(monkeypatch):
    """What phase 19 ran is read once by the phase that checks it; a second
    read runs the command anew."""
    monkeypatch.setattr(cs, "_RAN", {})
    marks = []
    cmd = [sys.executable, "-c", "print('ahead')"]
    cs._RAN.update(cs.run_together({"probe": cmd}))
    monkeypatch.setattr(cs, "run_together",
                        lambda cmds: marks.append(cmds) or {
                            k: ("again\n", 0.0) for k in cmds})
    out, seconds = cs.ran("probe", cmd)
    assert out.strip() == "ahead" and seconds >= 0.0
    assert not marks and "probe" not in cs._RAN
    assert cs.ran("probe", cmd)[0].strip() == "again"
    assert marks == [{"probe": cmd}]


def test_a_process_no_phase_started_starts_when_read(monkeypatch):
    monkeypatch.setattr(cs, "_RAN", {})
    out, _ = cs.ran("late", [sys.executable, "-c", "print('now')"])
    assert out.strip() == "now"


def test_a_failed_background_process_raises():
    with pytest.raises(AssertionError, match="broken failed: .*boom"):
        cs.run_together({
            "fine": [sys.executable, "-c", "print('fine')"],
            "broken": [sys.executable, "-c", "import sys; sys.exit('boom')"]})


def test_processes_run_together_and_each_keeps_its_own_end():
    """The processes start at once (two 1 s sleeps take about 1 s, not 2);
    each one's seconds end at its own end, and a long output (past a pipe's
    buffer) is read whole."""
    sleep = "import time; time.sleep({}); print('x' * 200000)"
    t0 = time.perf_counter()
    out = cs.run_together({
        "a": [sys.executable, "-c", sleep.format(1.0)],
        "b": [sys.executable, "-c", sleep.format(1.0)],
        "c": [sys.executable, "-c", "print('quick')"]})
    assert time.perf_counter() - t0 < 1.9
    assert out["c"][0].strip() == "quick"
    assert out["c"][1] < out["a"][1]
    assert len(out["a"][0].strip()) == 200000


def test_a_process_past_the_limit_is_ended(monkeypatch, tmp_path):
    """A process still running at TOGETHER_S raises, and is ended with the
    others before run_together returns."""
    monkeypatch.setattr(cs, "TOGETHER_S", 0.5)
    pid_file = tmp_path / "pid"
    hang = ("import os, time; open({!r}, 'w').write(str(os.getpid())); "
            "time.sleep(60)").format(str(pid_file))
    with pytest.raises(AssertionError, match="still running"):
        cs.run_together({"hang": [sys.executable, "-c", hang]})
    pid = int(pid_file.read_text())
    with pytest.raises(OSError):
        os.kill(pid, 0)             # ended and reaped


def test_the_serving_process_records_are_read(monkeypatch):
    """run_artifacts: one record a line, then the modules the serving
    process imported."""
    child = ("import json\nprint(json.dumps({'path': 'a'}))\n"
             "print(json.dumps({'path': 'b'}))\n"
             "print(json.dumps(['rmp_tpu_torch.ops.library']))\n")
    monkeypatch.setattr(cs, "ARTIFACT_CHILD", child)
    runs, modules = cs.run_artifacts([("a", 1), ("b", 2)])
    assert [r["path"] for r in runs] == ["a", "b"]
    assert modules == ["rmp_tpu_torch.ops.library"]
