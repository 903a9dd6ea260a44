"""Where the time of the port's K1, K3, K4 and K5 calls goes, on one NVIDIA
GPU.

    python3 kernel_probe.py [part ...]

Parts (all when none is named): sass, k3, k3tile, k4, k5, host,
traces.

1. Phase splits by edited copies of csrc/: each variant is rebuilt from a
   copy of csrc/ with an edit and runs in its own process (the library loads
   once per process); its kernel is timed with the stream kept busy ahead
   (chip_smoke.time_ms with lead), three medians of 30 calls each, and its
   ptxas counts are kept.
   - K3 (csrc/fk_derivatives.cu) at B = 4096 on the Panda, the dual-arm
     Panda and the 24- and 32-link planar arms: return after the table
     loads, after the prologue, before the stores or before J's stores, or
     skip the recursion. Part k3tile builds the kernel as it is and with
     the wide instantiation's tile at 8 envs per CTA in place of 4.
   - K4 (csrc/gjk_hull.cu) on the hull main path's own warm operands
     (chip_smoke.k4_main_path_operands): the kernel as it is at iters = 0,
     1, 2 and 4 (fixed cost and cost per iteration), with the tie pass
     forced on every support, and built with a cap of 64 registers
     (__launch_bounds__(128, 8) in place of (128): one wave at the
     flagship, and spills).
   - K5 (csrc/fused_tick.cu) at scene 06, B = 4096, near the ready pose:
     return after the FK recursion, after the frame slots, after the work
     items (before the butterfly), or the whole kernel.
   - A diagnostic variant of K4 loads no table row in its first scan (its
     results are wrong; it times the scan's arithmetic alone).
2. Instructions per kernel and their opcodes, from cuobjdump -sass of the
   built library (the listing goes to chiprun_out/kernel_probe_sass.txt).
3. Host cost of the K1 and K3 wrappers' parts (validation and descriptor
   table, allocation, stream handle) and of whole wrapper calls at
   B = 16, in microseconds per call over 2,000 calls.
4. Device records the profiler keeps (traces): a child process runs
   chip_smoke.py's phases, then traces 10 K5 calls at scenes 06 and 05,
   30 times each way per scene, alternating in rounds of 10: started and
   stopped around the calls alone (how chip_smoke.py traced before), and
   through chip_smoke.traced (a warm-up step first, a pause on each side).
   It counts the device kernels each trace recorded and the host's launch
   calls.
The results also go to chiprun_out/kernel_probe.json. Needs CUDA and nvcc.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STOP = "  if (F > 0) return;\n"
K3_RECURSION = "  // ---- the recursion (fk_common.cuh): env e, entry (i, j) ----\n  {"
K5_SLOTS = "  // ---- the point frames' slots"
K5_ITEMS = "  // ---- work items:"
K5_BUTTERFLY = "  // ---- butterfly over the env's 16 lanes ----"

# source -> variant -> (old, new) edits of that source
VARIANTS = {
    "fk_derivatives.cu": {
        "full": [],
        "tables_only": [("  // ---- per frame, once:",
                         STOP + "  // ---- per frame, once:")],
        "tables_and_prologue": [(K3_RECURSION, STOP + "  {")],
        "no_stores": [("  __syncthreads();\n\n  // ---- the stores",
                       "  __syncthreads();\n" + STOP
                       + "  // ---- the stores")],
        "no_J_stores": [("  // J: a row's 16 n floats",
                         STOP + "  // J: a row's 16 n floats")],
        "no_recursion": [(K3_RECURSION, "  if (F < 0) {")],
    },
    "gjk_hull.cu": {
        "full": [],
        "tie_pass_forced": [("  if (r == m || (pad > 0 && first == 0.0f)) {",
                             "  if (true) {")],
        "register_cap_64": [("__launch_bounds__(kThreads) gjk_hull_kernel",
                             "__launch_bounds__(kThreads, 8) gjk_hull_kernel")],
        # diagnostic, wrong results: the first scan's rows from registers
        "scan_without_table_loads": [(
            "    const float4 p = sv[i];\n    const float s = row_dot(",
            "    const float4 p = make_float4(0.01f * i, 0.02f * i, "
            "-0.01f * i, i);\n    const float s = row_dot(")],
    },
    "fused_tick.cu": {
        "full": [],
        "fk_only": [(K5_SLOTS, STOP + K5_SLOTS)],
        "fk_and_slots": [(K5_ITEMS, STOP + K5_ITEMS)],
        "no_reduction_or_solve": [(K5_BUTTERFLY, STOP + K5_BUTTERFLY)],
    },
}
# the wide K3 instantiation's tile at 8 envs per CTA (the kernel has 4)
K3_TILES = {
    "fk_derivatives.cu": {
        "full": [],
        "wide_tile_8": [("{{32, 18, 8}, {40, 32, 4}};",
                         "{{32, 18, 8}, {40, 32, 8}};")],
    },
}
K4_ITERS = (0, 1, 2, 4)

CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
from rmp_tpu_torch import _build, envs
_build.CSRC_DIR, _build.BUILD_DIR = {csrc!r}, {build!r}
import chip_smoke as cs
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_tick
_build.build()
src = {src!r}
if src == "fk_derivatives.cu":
    from rmp_tpu_torch.models.specs import build_model, make_planar_arm_spec
    calls = {{}}
    for name, model in (("call", robots.franka_panda()),
                        ("dual_panda", robots.dual_panda()),
                        ("planar_24", build_model(make_planar_arm_spec(24))),
                        ("planar_32", build_model(make_planar_arm_spec(32)))):
        q, qd = cs.k3_inputs(model, cs.BATCH, torch.device("cuda"))
        calls[name] = (lambda m=model, q=q, qd=qd:
                       cuda_fk.fk_derivatives_batched(m, q, qd))
elif src == "gjk_hull.cu":
    ops, _ = cs.k4_main_path_operands()
    calls = {{f"iters{{i}}": (lambda i=i: cuda_gjk.gjk_hull_obstacles(
        **ops, iters=i)) for i in {iters!r}}}
else:
    env = envs.make(cs.SCENE)
    fn = cuda_tick.make_fused_qdd(env)
    near = cs.k5_inputs(env, cs.BATCH, 11, wide=False)
    calls = dict(call=lambda: fn(*near))
extra = (dict(build_wide=cs.ptxas_counts(
    src, "fk_derivatives_kernelILi40ELi32E")) if src == "fk_derivatives.cu"
    else {{}})
print("RESULT", json.dumps(dict(
    build=cs.ptxas_counts(src), **extra,
    device_ms={{k: [cs.time_ms(c, lead=True) for _ in range(3)]
               for k, c in calls.items()}})))
"""


def split(source: str, variants: dict = VARIANTS) -> dict:
    """Every variant of `source` built and timed in its own process."""
    out = {}
    for name, edits in variants[source].items():
        work = tempfile.mkdtemp()
        try:
            csrc = os.path.join(work, "csrc")
            shutil.copytree(os.path.join(ROOT, "rmp_tpu_torch", "csrc"), csrc)
            path = os.path.join(csrc, source)
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{source} {name}: edit anchor not "
                                       f"found once")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            code = CHILD.format(root=ROOT, csrc=csrc,
                                build=os.path.join(work, "build"), src=source,
                                iters=K4_ITERS)
            run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode != 0 or not lines:
            raise RuntimeError(f"{source} variant {name} failed:\n"
                               f"{run.stderr}")
        out[name] = json.loads(lines[0][len("RESULT "):])
        print(f"{source} {name}: {json.dumps(out[name])}", flush=True)
    return out


def sass_counts() -> dict:
    """Instructions per kernel of the built library (cuobjdump -sass), with
    each kernel's opcode histogram; the listing goes to
    chiprun_out/kernel_probe_sass.txt."""
    from rmp_tpu_torch import _build

    lib = _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_probe_sass.txt"),
              "w") as f:
        f.write(text)
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         chunk)
        hist: dict[str, int] = {}
        for op in ops:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        out[name] = dict(instructions=len(ops), opcodes=dict(
            sorted(hist.items(), key=lambda kv: -kv[1])))
        print(f"sass {name[:70]}: {len(ops)} instructions", flush=True)
    return out


TRACE_CHILD = r"""
import contextlib, io, json, sys
sys.path.insert(0, {root!r})
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from rmp_tpu_torch import envs
from rmp_tpu_torch.ops import cuda_tick
with contextlib.redirect_stdout(io.StringIO()):
    assert cs.main() == 0


def counts(events):
    launches = sum(1 for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return [len(cs.device_kernels(events)), launches]


def around_calls(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


out = {{}}
for scene, tag in ((cs.SCENE, "06"), (cs.SCENE05, "05")):
    env = envs.make(scene)
    k5 = cuda_tick.make_fused_qdd(env)
    near = cs.k5_inputs(env, cs.BATCH, 11, wide=False)
    ten = lambda: [k5(*near) for _ in range(10)]
    ten()
    torch.cuda.synchronize()
    rec = out[tag] = dict(around_calls=[], warm_up_step=[])
    for _ in range(3):
        rec["around_calls"] += [counts(around_calls(ten)) for _ in range(10)]
        rec["warm_up_step"] += [counts(cs.traced(ten)) for _ in range(10)]
print("RESULT", json.dumps(out))
"""


def trace_loss() -> dict:
    """K5 device kernels recorded per 10-call trace, each way (TRACE_CHILD)."""
    run = subprocess.run([sys.executable, "-c", TRACE_CHILD.format(root=ROOT)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
    if run.returncode != 0 or not lines:
        raise RuntimeError(f"trace child failed:\n{run.stderr}")
    out = json.loads(lines[0][len("RESULT "):])
    for tag, rec in out.items():
        for way, pairs in rec.items():
            short = sum(1 for kept, launched in pairs if kept < launched)
            print(f"traces K5 {tag} {way}: {short} of {len(pairs)} traces "
                  f"kept fewer device kernels than launch calls; kept "
                  f"{sorted(kept for kept, _ in pairs)}", flush=True)
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

    parts = dict(sass=sass_counts,
                 k3=lambda: split("fk_derivatives.cu"),
                 k3tile=lambda: split("fk_derivatives.cu", K3_TILES),
                 k4=lambda: split("gjk_hull.cu"),
                 k5=lambda: split("fused_tick.cu"), host=host_costs,
                 traces=trace_loss)
    chosen = sys.argv[1:] or list(parts)
    unknown = sorted(set(chosen) - set(parts))
    if unknown:
        print(f"kernel_probe: unknown parts {unknown}; parts: {list(parts)}",
              file=sys.stderr)
        return 2
    card = cs.card_lines()[0]
    print(f"card: {card}", flush=True)
    record = dict(card=card)
    record.update((name, parts[name]()) for name in chosen)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_probe.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
