"""Smoke run of the PyTorch/CUDA port (rmp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero without
printing the result line:
  1. card: name and power limit (nvidia-smi), torch version; needs CUDA.
  2. build: every kernel of the main path, built by nvcc from
     rmp_tpu_torch/csrc/ (seconds printed).
  3. K1 (pullback + pivoted-LU resolve) against its plain PyTorch version at
     the flagship layout and B = 4096, on seeded random blocks and on the
     blocks of a real tick; a rank-1 Gram case must stay finite. Timed with
     CUDA events beside its bound and an einsum + torch.linalg.solve
     yardstick.
  4. K3 (FK derivatives) against its plain version at B = 4096.
  5. main path: franka/06_cluttered_environment, 4096 envs, resolve
     'solve': 2 warm-up ticks, then a timed 150-tick rollout; every launch
     counter is zeroed just before it and must equal the tick count after.
     Then 10 ticks under torch.profiler: device busy time and idle share
     per tick, device launches per tick, the kernels with most device time.
  6. parity: 128 envs x 5 ticks on the GPU against the same states on the
     CPU (plain versions), near the ready pose (every env) and from wider
     moves (every env whose CPU run a one-ulp move of the start leaves
     within 1e-5); and the committed golden trajectory of the flagship
     scene reproduced on the GPU.
Then one JSON line of per-kernel numbers ({"kernels": [...]}) and, last,
{"ok": true, "device": {...}}. The full record also goes to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from rmp_tpu_torch import _build, envs
from rmp_tpu_torch.core import policy_row_blocks_structured
from rmp_tpu_torch.envs.base import _policy_inputs, make_batched_control_step
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models.urdf import FIXED
from rmp_tpu_torch.ops import cuda_fk, cuda_resolve

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = "franka/06_cluttered_environment"
BATCH = 4096
TICKS = 150
WARMUP_TICKS = 2
REPS = 30
# published H100 SXM peaks: HBM3 bandwidth and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
K1_TOL = 2e-4          # max |kernel - plain| <= K1_TOL * max(1, max |q̈|)
K3_ATOL = 2e-4
PARITY_ATOL = 1e-3     # GPU vs CPU q after 5 ticks
STABLE = 1e-5          # a one-ulp move of the start moves the CPU run less
PROFILE_TICKS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- K1 ------

def k1_layout(tags, blocks):
    """(B, n, dense rows, scalar rows) of a structured block list."""
    B = blocks[0][0].shape[0]
    n = blocks[0][0].shape[-1]
    Rd = sum(b[0].shape[1] for t, b in zip(tags, blocks) if t == "dense")
    Rs = sum(b[0].shape[1] for t, b in zip(tags, blocks) if t == "scalar")
    return B, n, Rd, Rs


def k1_bound(tags, blocks):
    """Bound of the kernel call: it reads the identity seed (n² + n), the
    dense rows (2n + 1 each) and the scalar rows (n + 2 each) once and
    writes q̈ (n), per env; flops of the accumulation and the LU."""
    B, n, Rd, Rs = k1_layout(tags, blocks)
    floats = n * n + n + Rd * (2 * n + 1) + Rs * (n + 2) + n
    flops = (Rd * (2 * n + 2 * n * n)                    # J^T W, J^T v
             + Rs * (3 * n + n * (n + 1))                # m J, upper J^T m J
             + sum((n - k - 1) * (2 * (n - k) + 3) for k in range(n))  # LU
             + n * n + n)                                # back substitution
    return bound_ms(4.0 * floats * B, float(flops) * B)


def k1_library(tags, blocks):
    """Yardstick: einsum accumulation + torch.linalg.solve."""
    A, f = cuda_resolve.assemble_structured(tags, blocks)
    return torch.linalg.solve(A, f)


def k1_random_blocks(seed: int, B: int, device):
    """Seeded blocks in the flagship layout: a dense EE block (3 rows),
    three identity blocks with SPD metrics, the scalar obstacle block (70
    rows)."""
    rng = np.random.default_rng(seed)
    n, Rd, Rs = 9, 3, 70

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    Jd = rng.normal(size=(B, Rd, n))
    blocks = [(t(Jd), t(spd(Rd) @ Jd), t(rng.normal(size=(B, Rd))))]
    for _ in range(3):
        blocks.append((t(spd(n)), t(rng.normal(size=(B, n)))))
    blocks.append((t(rng.normal(size=(B, Rs, n)) * 0.3),
                   t(rng.uniform(0.0, 2.0, (B, Rs))),
                   t(rng.normal(size=(B, Rs)))))
    return ("dense", "identity", "identity", "identity", "scalar"), blocks


def k1_compare(tags, blocks, what: str) -> float:
    got = cuda_resolve.pullback_resolve_structured(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    log(f"K1 {what}: max|kernel - plain| {err:.3e} (limit "
        f"{K1_TOL * scale:.3e}, max|q̈| {scale:.3e})")
    check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite output")
    check(err <= K1_TOL * scale, f"K1 {what}: disagrees with plain version")
    return err


def real_tick_blocks(env, B: int, seed: int):
    """Structured blocks of one real tick of the flagship scene, from
    mildly perturbed reset states (so the envs differ)."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev = states.sim.q.device
    dq = torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)), dtype=torch.float32,
                      device=dev)
    dqd = torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)), dtype=torch.float32,
                       device=dev)
    sim = dataclasses.replace(states.sim, q=states.sim.q + dq, qd=dqd)
    states = dataclasses.replace(states, sim=sim)
    q, qd, params, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    return policy_row_blocks_structured(env.policies, q, qd, params, ctxs,
                                        fk=fk)


def phase_k1(env, device) -> dict:
    tags, blocks = k1_random_blocks(0, BATCH, device)
    err = k1_compare(tags, blocks, "random flagship layout, B=4096")
    rtags, rblocks = real_tick_blocks(env, BATCH, 1)
    check(rtags == tags, f"unexpected flagship tags {rtags}")
    err = max(err, k1_compare(rtags, rblocks, "real tick, B=4096"))

    # rank-1 Gram: env 0's scalar rows are all one vector
    rng = np.random.default_rng(2)
    n, R = 9, 9
    J = rng.normal(size=(BATCH, R, n))
    J[0] = np.outer(np.ones(R), rng.normal(size=n)) / np.sqrt(R)
    sing = ("scalar",), [tuple(torch.tensor(np.asarray(x, np.float32),
                                            device=device) for x in
                               (J, np.ones((BATCH, R)),
                                rng.normal(size=(BATCH, R))))]
    out = cuda_resolve.pullback_resolve_structured(*sing)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K1 rank-1 Gram: non-finite output")
    log("K1 rank-1 Gram: finite")

    ms = time_ms(lambda: cuda_resolve.pullback_resolve_structured(rtags, rblocks))
    prep_ms = time_ms(lambda: cuda_resolve.kernel_inputs(rtags, rblocks))
    plain_ms = time_ms(
        lambda: cuda_resolve.pullback_resolve_structured_plain(rtags, rblocks))
    library_ms = time_ms(lambda: k1_library(rtags, rblocks))
    b_ms, b_by = k1_bound(rtags, rblocks)
    log(f"K1 times at B=4096: kernel {ms:.4f} ms (of which operand "
        f"preparation {prep_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"einsum+linalg.solve {library_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    return dict(name="pullback_resolve_structured", route="cuda",
                source="rmp_tpu_torch/csrc/pullback_resolve.cu",
                replaces="rmp_tpu/ops/pallas_resolve.py:226",
                max_abs_err=err, ms=ms, kernel_ms=ms, prep_ms=prep_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


# ---------------------------------------------------------------- K3 ------

def k3_bound(model, B: int):
    """Bound of the kernel: reads q, qd and writes T, Td, c (16 floats
    each) and J (16 n) per frame, once; flops of its 4x4 products
    (112 flops each) and element-wise updates."""
    n, F = model.n_q, model.n_frames
    floats = 2 * n + F * 16 * (3 + n)
    mm = 112
    flops = 0
    for f in range(F):
        flops += 2 * mm + mm + (2 * mm + 16)       # A, T; Td; c
        if model.joint_type[f] != FIXED:
            flops += 2 * mm + 18 + 32 + 2 * mm + 48  # G, inverse, W, Wd
        flops += mm * sum(1 for j in model.chain(f)
                          if model.joint_type[j] != FIXED)
    return bound_ms(4.0 * floats * B, float(flops) * B)


def phase_k3(device) -> dict:
    model = robots.franka_panda()
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.uniform(-1.2, 1.2, (BATCH, model.n_q)),
                     dtype=torch.float32, device=device)
    qd = torch.tensor(rng.uniform(-1.0, 1.0, (BATCH, model.n_q)),
                      dtype=torch.float32, device=device)
    got = cuda_fk.fk_derivatives_batched(model, q, qd)
    want = fk_derivatives(model, q, qd)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        check(g.shape == w.shape, f"K3 {name}: shape {g.shape} vs {w.shape}")
        e = float((g - w).abs().max())
        log(f"K3 {name}: max|kernel - plain| {e:.3e} (atol {K3_ATOL})")
        check(e <= K3_ATOL, f"K3 {name}: disagrees with plain version")
        err = max(err, e)
    ms = time_ms(lambda: cuda_fk.fk_derivatives_batched(model, q, qd))
    plain_ms = time_ms(lambda: fk_derivatives(model, q, qd))
    b_ms, b_by = k3_bound(model, BATCH)
    log(f"K3 times at B=4096: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(name="fk_derivatives_batched", route="cuda",
                source="rmp_tpu_torch/csrc/fk_derivatives.cu",
                replaces="rmp_tpu/ops/pallas_fk.py:218",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ---------------------------------------------------------- main path -----

COUNTERS = {
    "pullback_resolve_structured": cuda_resolve.pullback_resolve_structured,
    "fk_derivatives_batched": cuda_fk.fk_derivatives_batched,
}


def phase_main_path(card: str) -> tuple[dict, dict]:
    env = envs.make(SCENE)                   # the GPU by default
    env.resolve_method = "solve"
    params = env.gather_params()
    states = envs.make_batched_reset(env, BATCH)()
    states, _ = envs.make_batched_rollout(env, WARMUP_TICKS,
                                          with_aux=False)(states, params)
    rollout = envs.make_batched_rollout(env, TICKS, with_aux=False)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, _ = rollout(states, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    steps_per_s = BATCH * TICKS / seconds
    log(f"main path: {SCENE}, {BATCH} envs x {TICKS} ticks in "
        f"{seconds:.3f} s = {steps_per_s:.1f} control steps/s [{card}]")
    log(f"main path launches: {launches}")
    check(bool(torch.isfinite(final.sim.q).all()), "main path: non-finite q")
    check(tuple(final.sim.q.shape) == (BATCH, 9), "main path: q shape")
    for name, count in launches.items():
        check(count == TICKS, f"main path: {name} launched {count} times in "
              f"{TICKS} ticks")
    solved = int(final.solved_count.sum())
    log(f"main path: goals reached over the batch {solved}, "
        f"mean phase {float(final.phase.float().mean()):.3f}")
    trace = profile_ticks(env, final, params, seconds * 1e3 / TICKS)
    log(f"main path trace: {json.dumps(trace)}")
    return launches, dict(envs=BATCH, ticks=TICKS, seconds=seconds,
                          control_steps_per_s=steps_per_s,
                          goals_reached=solved, trace=trace)


def _busy_us(events) -> float:
    """Length of the union of the device kernel intervals, in us."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def profile_ticks(env, states, params, tick_ms: float) -> dict:
    """PROFILE_TICKS ticks under torch.profiler: device busy ms per tick
    (union of kernel intervals), the idle share of the unprofiled tick
    (tick_ms) and of the traced span (which the profiler stretches), device
    launches per tick, the port's own kernels' device time, and the
    kernels with the most device time."""
    step = envs.make_batched_control_step(env)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_TICKS):
            states, _ = step(states, params)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "main path trace: no device activity recorded")
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(((sum(v), len(v), k) for k, v in by_name.items()),
                 reverse=True)[:10]
    busy_ms = _busy_us(kernels) / 1e3 / PROFILE_TICKS
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3 / PROFILE_TICKS
    return dict(
        ticks=PROFILE_TICKS, tick_ms=tick_ms,
        device_launches_per_tick=len(kernels) / PROFILE_TICKS,
        device_busy_ms_per_tick=busy_ms,
        device_idle_share=1.0 - busy_ms / tick_ms,
        device_idle_share_traced=1.0 - busy_ms / span_ms,
        port_kernels_us_per_tick={
            k[:60]: sum(v) / PROFILE_TICKS for k, v in by_name.items()
            if "pullback_resolve_kernel" in k or "fk_derivatives_kernel" in k},
        top_kernels=[dict(name=k[:80], us_per_tick=t / PROFILE_TICKS,
                          launches_per_tick=c / PROFILE_TICKS)
                     for t, c, k in top])


def perturbed_states(env, B: int, seed: int, dq: float, dqd: float,
                     ulp: bool = False):
    """Reset states moved by q ± dq, q̇ ± dqd (seeded); with ulp, q and q̇
    then move up by one ulp."""
    rng = np.random.default_rng(seed)
    states = envs.make_batched_reset(env, B)()
    dev = states.sim.q.device
    q = states.sim.q + torch.tensor(rng.uniform(-dq, dq, (B, 9)),
                                    dtype=torch.float32, device=dev)
    qd = torch.tensor(rng.uniform(-dqd, dqd, (B, 9)), dtype=torch.float32,
                      device=dev)
    if ulp:
        up = torch.tensor(float("inf"), device=dev)
        q, qd = torch.nextafter(q, up), torch.nextafter(qd, up)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=q, qd=qd))


def parity_q(dev: str, dq: float, dqd: float, ulp: bool = False):
    env = envs.make(SCENE, device=dev)
    env.resolve_method = "solve"
    final, _ = envs.make_batched_rollout(env, 5, with_aux=False)(
        perturbed_states(env, 128, 4, dq, dqd, ulp), env.gather_params())
    return final.sim.q.cpu()


def phase_parity() -> dict:
    # near the ready pose every env is well conditioned
    err = float((parity_q("cuda", 0.1, 0.05)
                 - parity_q("cpu", 0.1, 0.05)).abs().max())
    log(f"parity: 128 envs x 5 ticks from q ± 0.1, q̇ ± 0.05, "
        f"max|q_gpu - q_cpu| {err:.3e} (atol {PARITY_ATOL})")
    check(err <= PARITY_ATOL, "GPU/CPU parity")

    # from q ± 0.3, q̇ ± 0.5 envs that reach the velocity cap's clip amplify
    # rounding (tests/test_torch_conditioning.py): held where the CPU run
    # itself is insensitive to a one-ulp move of its start
    cpu = parity_q("cpu", 0.3, 0.5)
    sens = (parity_q("cpu", 0.3, 0.5, ulp=True) - cpu).abs().amax(dim=1)
    gap = (parity_q("cuda", 0.3, 0.5) - cpu).abs().amax(dim=1)
    stable = sens <= STABLE
    wide = dict(stable_envs=int(stable.sum()),
                max_gap_stable=float(gap[stable].max()),
                max_gap_unstable=float(gap[~stable].max()) if
                bool((~stable).any()) else None,
                max_sensitivity=float(sens.max()))
    log(f"parity: 128 envs x 5 ticks from q ± 0.3, q̇ ± 0.5: {json.dumps(wide)}"
        f" (atol {PARITY_ATOL} on the stable envs)")
    check(wide["stable_envs"] >= 64, "wide parity: too few stable envs")
    check(wide["max_gap_stable"] <= PARITY_ATOL, "wide GPU/CPU parity")

    # committed golden trajectory of the flagship scene (B = 1, no resample)
    data = np.load(os.path.join(ROOT, "tests", "golden",
                                "franka06_cluttered_trajectory.npz"))
    env = envs.make(SCENE)
    env.resolve_method = "solve"
    env.on_solved = None
    step = make_batched_control_step(env)
    params = env.gather_params()
    state = envs.make_batched_reset(env, 1)()
    traj, qdd0 = [state.sim.q[0].cpu().numpy()], None
    for _ in range(data["qdd"].shape[0]):
        state, aux = step(state, params)
        if qdd0 is None:
            qdd0 = aux["qdd"][0].cpu().numpy()
        traj.append(state.sim.q[0].cpu().numpy())
    traj = np.stack(traj)
    T = data["qdd"].shape[0]
    g = dict(qdd0=float(np.abs(qdd0 - data["qdd"][0]).max()),
             half=float(np.abs(traj[:T // 2] - data["q"][:T // 2]).max()),
             all=float(np.abs(traj - data["q"]).max()))
    log(f"golden on the GPU: first q̈ {g['qdd0']:.3e} (< 2e-3), first half "
        f"{g['half']:.3e} (< 5e-3), all {g['all']:.3e} (< 2e-2)")
    check(g["qdd0"] < 2e-3 and g["half"] < 5e-3 and g["all"] < 2e-2,
          "golden trajectory on the GPU")
    return dict(parity_max_abs_q=err, wide=wide, golden=g)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() == 1,
          f"needs one card, sees {torch.cuda.device_count()}")
    device = torch.device("cuda")
    cards = card_lines()
    card = cards[0]
    log(f"card: {'; '.join(cards)}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {lib} in {build_s:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    env = envs.make(SCENE)
    k1 = phase_k1(env, device)
    k3 = phase_k3(device)
    launches, main_path = phase_main_path(card)
    parity = phase_parity()

    kernels = []
    for rec in (k1, k3):
        rec["launches"] = launches[rec["name"]]
        kernels.append(rec)
    record = dict(card=card, torch=torch.__version__, build_s=build_s,
                  kernels=kernels, main_path=main_path, parity=parity)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
