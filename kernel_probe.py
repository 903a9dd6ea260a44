"""Where the time of the port's K1 and K3 calls goes, on one NVIDIA GPU.

    python3 kernel_probe.py

1. Phase split of K3 (csrc/fk_derivatives.cu) at B = 4096: the kernel is
   rebuilt from edited copies of csrc/ that return after the table loads,
   after the prologue, before the stores or before J's stores, or skip
   the recursion; each copy runs in its own process (the library loads
   once per process) and is timed with the stream kept busy ahead
   (chip_smoke.time_ms with lead), three medians of 30 calls each.
2. Host cost of the K1 and K3 wrappers' parts (validation and descriptor
   table, allocation, stream handle) and of whole wrapper calls at
   B = 16, in microseconds per call over 2,000 calls.
The results also go to chiprun_out/kernel_probe.json. Needs CUDA and nvcc.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K3 = "fk_derivatives.cu"
STOP = "  if (F > 0) return;\n"
RECURSION = ("  // ---- the recursion (fk_common.cuh's fk_step): env e, entry "
             "(i, j) ----\n  {")
# variant -> (old, new) edits of fk_derivatives.cu
K3_VARIANTS = {
    "full": [],
    "tables_only": [("  // ---- per frame, once:",
                     STOP + "  // ---- per frame, once:")],
    "tables_and_prologue": [(RECURSION, STOP + "  {")],
    "no_stores": [("  __syncthreads();\n\n  // ---- the stores",
                   "  __syncthreads();\n" + STOP + "  // ---- the stores")],
    "no_J_stores": [("  // J: a row's 16 n floats",
                     STOP + "  // J: a row's 16 n floats")],
    "no_recursion": [(RECURSION, "  if (F < 0) {")],
}

CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
from rmp_tpu_torch import _build
_build.CSRC_DIR, _build.BUILD_DIR = {csrc!r}, {build!r}
import chip_smoke as cs
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk
_build.build()
model = robots.franka_panda()
q, qd = cs.k3_inputs(model, cs.BATCH, torch.device("cuda"))
call = lambda: cuda_fk.fk_derivatives_batched(model, q, qd)
print("RESULT", json.dumps(dict(
    build=cs.ptxas_counts({src!r}),
    device_ms=[cs.time_ms(call, lead=True) for _ in range(3)])))
"""


def k3_split() -> dict:
    out = {}
    for name, edits in K3_VARIANTS.items():
        work = tempfile.mkdtemp()
        try:
            csrc = os.path.join(work, "csrc")
            shutil.copytree(os.path.join(ROOT, "rmp_tpu_torch", "csrc"), csrc)
            path = os.path.join(csrc, K3)
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: edit anchor not found once")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            code = CHILD.format(root=ROOT, csrc=csrc,
                                build=os.path.join(work, "build"), src=K3)
            run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode != 0 or not lines:
            raise RuntimeError(f"K3 variant {name} failed:\n{run.stderr}")
        out[name] = json.loads(lines[0][len("RESULT "):])
        print(f"K3 {name}: {json.dumps(out[name])}", flush=True)
    return out


def host_costs() -> dict:
    import torch

    import chip_smoke as cs
    from rmp_tpu_torch import _build, envs
    from rmp_tpu_torch.models import robots
    from rmp_tpu_torch.ops import cuda_fk, cuda_resolve

    _build.build()
    dev = torch.device("cuda")
    env = envs.make(cs.SCENE)
    tags, blocks = cs.real_tick_blocks(env, 16, 1)
    model = robots.franka_panda()
    q, qd = cs.k3_inputs(model, 16, dev)

    def per_call_us(fn, n: int = 2000) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    out = dict(
        k1_check_and_table=per_call_us(
            lambda: cuda_resolve.block_table(tags, blocks)),
        torch_empty=per_call_us(lambda: torch.empty(16, 9, device=dev)),
        current_stream_object=per_call_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        raw_stream=per_call_us(lambda: _build.raw_stream(dev)),
        k1_wrapper_b16=per_call_us(
            lambda: cuda_resolve.pullback_resolve_structured(tags, blocks)),
        k3_wrapper_b16=per_call_us(
            lambda: cuda_fk.fk_derivatives_batched(model, q, qd)))
    for k, v in out.items():
        print(f"host {k}: {v:.2f} us per call", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_lines()[0]
    print(f"card: {card}", flush=True)
    record = dict(card=card, k3_split=k3_split(), host_us=host_costs())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_probe.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
