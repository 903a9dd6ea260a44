"""Ahead-of-time export of the control step: the serving artifact.

The port's `experiments/aot_export.py`. A deployed controller should not
pay the package's Python at robot boot, nor need the scene registry: the
batched rollout of `ticks` ticks is traced once into a graph of aten ops
and the kernels' opaque ops (ops/library.py: K1, K3 and, in the hull tier,
K4), saved with `torch.export.save`. A serving host loads it with torch
and the ops module alone and calls it with plain tensors.

The exported callable is flat: f(*leaves) -> state leaves. Its inputs are
the state's tensor leaves, then the parameter leaves (a Python-number gain
becomes a 0-d float32 tensor, so a consumer can change it without
re-exporting), then, for a scene whose tick draws random numbers, that
call's draws; its outputs are the advanced state leaves in input order,
to be fed back in. Leaves follow utils/checkpoint's flattening. A JSON
manifest beside the artifact (`<path>.json`) records every input's and
output's shape and dtype, the counts, the draws and the resampling
stream's state, the `rmp_tpu_torch::` ops in the graph and the torch that
exported it; `<path>.npz` holds the example state and parameter inputs as
arr_i in input order. A serving loop:

    import torch, rmp_tpu_torch.ops.library
    step = torch.export.load(path).module()
    while True:
        draws = [torch.rand(*shape, generator=g, device=dev), ...]  # manifest
        leaves[:n_state] = step(*leaves, *draws)

Draws: the port's stream is a torch.Generator, which a graph cannot take
as an input (JAX's artifact carries its PRNG key as a leaf). So a tick's
draws are traced as inputs (sim.randomizer.Draws) and the caller draws
them, in the manifest's order, from a generator on the run device: set to
the manifest's `rng_state`, it makes the artifact reproduce the eager
rollout's draws bit for bit. The trace runs under fake tensors, so any
host read of a tensor's value raises instead of baking the value into the
artifact.

Platforms: an artifact is traced on one device (the card unless --cpu).
`--platforms cpu,cuda` traces on the CPU and lets a host on the card move
it there at load (`torch.export.passes.move_to_device_pass`).

    python -m rmp_tpu_torch.experiments.aot_export --save PATH [--env NAME]
        [--batch 128] [--ticks 1] [--platforms cpu,cuda] [--cpu]
    python -m rmp_tpu_torch.experiments.aot_export --load PATH [--cpu]

The artifact goes where --save says (chiprun_out/ in the smoke run).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

# the kernels' ops, registered: torch.export.load needs them
from rmp_tpu_torch.ops import library  # noqa: F401
from rmp_tpu_torch.utils.checkpoint import _leaves, _rebuild

PLATFORMS = ("cpu", "cuda")


def _tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of a tree, in checkpoint order (generators are
    left out: they cannot be a graph's inputs)."""
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _with_tensors(like, tensors):
    """`like` with its tensor leaves replaced, in order; other leaves (the
    generator) kept."""
    it = iter(tensors)
    return _rebuild(like, iter([next(it) if isinstance(x, torch.Tensor)
                                else x for x in _leaves(like)]))


def numbers_as_tensors(tree, device, static=()):
    """The tree with every Python int or float (not bool) a 0-d float32
    tensor on `device`, but under the dict keys in `static`: the gains
    become inputs of the artifact."""
    if isinstance(tree, dict):
        return {k: v if k in static else numbers_as_tensors(v, device)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(numbers_as_tensors(v, device) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return torch.tensor(float(tree), dtype=torch.float32, device=device)
    return tree


def gains_as_tensors(env) -> tuple:
    """The env's params with each policy's Python-number gains 0-d float32
    tensors, but its static_params (the velocity cap's, which it rounds as
    the reference does) kept as constants."""
    return tuple(numbers_as_tensors(prm, env.device, policy.static_params)
                 for policy, prm in zip(env.policies, env.gather_params()))


def _spec(x: torch.Tensor) -> dict:
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1]}


def graph_ops(gm: torch.fx.GraphModule) -> dict[str, int]:
    """{qualified name: calls} of the rmp_tpu_torch:: ops in a graph."""
    calls: dict[str, int] = {}
    for node in gm.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name):
            qual = name().split(".")[0]
            if qual.startswith("rmp_tpu_torch::"):
                calls[qual] = calls.get(qual, 0) + 1
    return calls


def trace_step(env, states, params, ticks: int):
    """(graph module, draw specs) of `ticks` batched ticks of `env` as a
    flat function of the state's and the parameters' tensor leaves (and
    the draws, where the tick draws), traced under fake tensors. A first
    trace records the tick's draws (sim.randomizer.Draws); only a scene
    that draws is traced again with them as inputs."""
    import torch._dynamo
    from torch.fx.experimental.proxy_tensor import make_fx

    from rmp_tpu_torch import envs
    from rmp_tpu_torch.sim.randomizer import Draws

    rollout = envs.make_batched_rollout(env, ticks, with_aux=False)
    flat = _tensors(states) + _tensors(params)
    n_state = len(_tensors(states))

    def run(stream, leaves):
        s = _with_tensors(states, leaves[:n_state])
        if s.rng is not None:
            s = dataclasses.replace(s, rng=stream)
        out, _ = rollout(s, _with_tensors(params, leaves[n_state:]))
        if stream.given is not None and len(stream.specs) != len(
                stream.given):
            raise ValueError(f"{env.name}: the traced tick drew "
                             f"{len(stream.specs)} times, "
                             f"{len(stream.given)} draws given")
        return tuple(_tensors(out))

    def trace(fn, inputs):
        # without FakeTensorMode's dispatch cache: an entry from an earlier
        # trace in the process trips forward-mode AD's view check in the
        # post maps' nested jvp (torch 2.11 and 2.13)
        with torch.no_grad(), torch._dynamo.config.patch(
                fake_tensor_cache_enabled=False):
            return make_fx(fn, tracing_mode="fake",
                           _allow_non_fake_inputs=True)(*inputs)

    # one eager tick first, from a copy of the stream: the package caches
    # each model's device tables at first use, and a table first made under
    # the trace's fake tensors would stay cached as a fake one
    warm = states
    if states.rng is not None:
        rng = torch.Generator(device=states.rng.device)
        rng.set_state(states.rng.get_state())
        warm = dataclasses.replace(states, rng=rng)
    with torch.no_grad():
        envs.make_batched_rollout(env, 1, with_aux=False)(warm, params)
    record = Draws(env.device)
    gm = trace(lambda *leaves: run(record, leaves), flat)
    if not record.specs:
        return gm, []
    draws = [torch.zeros(shape, dtype=dtype, device=env.device)
             for _, shape, dtype in record.specs]
    gm = trace(lambda *leaves: run(Draws(env.device, leaves[len(flat):]),
                                   leaves[:len(flat)]), flat + draws)
    return gm, record.specs


def export_step(env_name: str, batch: int, ticks: int = 1,
                platforms: list[str] | None = None, device=None,
                geometry: str | None = None):
    """(artifact, manifest, flat): the torch.export.ExportedProgram of
    make_batched_rollout(env, ticks, with_aux=False) on `batch` envs of
    `env_name` (resolve 'solve'; `geometry` sets the collision tier) as a
    flat function, its manifest, and the example inputs (reset state and
    parameters) followed by the first call's draws. Traced on `device`
    (default: the card); `platforms` (default: that device's type) lists
    where the artifact may run."""
    from rmp_tpu_torch import default_device, envs

    device = default_device(device)
    platforms = list(platforms or [device.type])
    if device.type not in platforms or not set(platforms) <= set(PLATFORMS):
        raise ValueError(f"platforms {platforms} must be among {PLATFORMS} "
                         f"and hold the tracing device {device.type}")
    env = envs.make(env_name, device=device)
    env.resolve_method = "solve"
    if geometry is not None:
        env.collision_geometry = geometry
    states = envs.make_batched_reset(env, batch)()
    params = gains_as_tensors(env)
    t0 = time.perf_counter()
    gm, specs = trace_step(env, states, params, ticks)
    trace_s = time.perf_counter() - t0
    flat = _tensors(states) + _tensors(params)
    rng_state = None if states.rng is None else states.rng.get_state()
    draws = make_draws(specs, device, rng_state)
    if rng_state is not None:
        rng_state = rng_state.numpy().tobytes().hex()
    t0 = time.perf_counter()
    artifact = torch.export.export(gm, tuple(flat + draws), strict=False)
    export_s = time.perf_counter() - t0
    n_state = len(_tensors(states))
    outputs = [node.meta["val"] for node in
               artifact.graph.output_node().args[0]]
    if len(outputs) != n_state:
        raise RuntimeError(f"{env_name}: {len(outputs)} outputs for "
                           f"{n_state} state leaves")
    manifest = {
        "env": env_name,
        "batch": batch,
        "ticks_per_call": ticks,
        "platforms": platforms,
        "traced_on": device.type,
        "geometry": env.collision_geometry,
        "inputs": [_spec(x) for x in flat + draws],
        # the first n_state inputs are the state leaves; the call returns
        # the advanced state leaves in the same order (feed them back in)
        "n_state_leaves": n_state,
        "n_param_leaves": len(flat) - n_state,
        # the last len(draws) inputs are the call's draws, made in this
        # order from the stream ("uniform": torch.rand, "normal":
        # torch.randn)
        "draws": [{"kind": kind, "shape": list(shape),
                   "dtype": str(dtype).split(".")[-1]}
                  for kind, shape, dtype in specs],
        # the stream's state at reset (torch.Generator.get_state() of the
        # tracing device's type, as hex): the draws of the eager rollout
        "rng_state": rng_state,
        "outputs": [_spec(x) for x in outputs],
        "ops": graph_ops(gm),
        "torch": torch.__version__,
        "trace_s": trace_s,
        "export_s": export_s,
    }
    return artifact, manifest, flat + draws


def make_draws(specs, device, rng_state, generator=None) -> list:
    """One call's draws in manifest order, from `generator`, or from a new
    generator on `device` set to `rng_state` (a stream's get_state(), or
    the manifest's hex of one: what an eager rollout's stream would draw
    next). Specs are (kind, shape, dtype) tuples or the manifest's
    dicts."""
    if not specs:
        return []
    if generator is None:
        generator = torch.Generator(device=device)
        if isinstance(rng_state, str):
            rng_state = torch.frombuffer(bytearray.fromhex(rng_state),
                                         dtype=torch.uint8)
        generator.set_state(rng_state)
    out = []
    for spec in specs:
        kind, shape, dtype = ((spec["kind"], spec["shape"],
                               getattr(torch, spec["dtype"]))
                              if isinstance(spec, dict) else spec)
        fn = torch.randn if kind == "normal" else torch.rand
        out.append(fn(*shape, generator=generator, device=device,
                      dtype=dtype))
    return out


def save(path: str, artifact, manifest: dict, flat: list) -> int:
    """Write the artifact, `<path>.json` and `<path>.npz` (the state and
    parameter inputs as arr_i); returns the artifact's bytes."""
    import os

    torch.export.save(artifact, path)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    n = manifest["n_state_leaves"] + manifest["n_param_leaves"]
    np.savez(path + ".npz", *[x.detach().cpu().numpy() for x in flat[:n]])
    return os.path.getsize(path)


def load(path: str, device=None):
    """(callable, manifest, example state and parameter inputs) of an
    artifact, on `device` (default: the device it was traced
    on); an artifact traced on the CPU whose platforms name cuda is moved
    to the card. Needs torch and ops/library.py only."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    device = torch.device(device or manifest["traced_on"])
    if device.type not in manifest["platforms"]:
        raise ValueError(f"{path} serves {manifest['platforms']}, not "
                         f"{device.type}")
    artifact = torch.export.load(path)
    if device.type != manifest["traced_on"]:
        from torch.export.passes import move_to_device_pass
        artifact = move_to_device_pass(artifact, device)
    example = np.load(path + ".npz")
    n = manifest["n_state_leaves"] + manifest["n_param_leaves"]
    leaves = [torch.from_numpy(example[f"arr_{i}"]).to(device)
              for i in range(n)]
    return artifact.module(), manifest, leaves


def stream(manifest: dict, device):
    """The generator a serving loop draws from: the saved stream where the
    artifact runs on the device it was traced on, else a new one seeded
    by 0, as the reset seeds it (a stream's state is tied to its device
    type)."""
    if not manifest["draws"]:
        return None
    gen = torch.Generator(device=device)
    if device.type == manifest["traced_on"]:
        gen.set_state(torch.frombuffer(
            bytearray.fromhex(manifest["rng_state"]), dtype=torch.uint8))
        return gen
    return gen.manual_seed(0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smoke_run(path: str, device=None) -> dict:
    """Load an artifact and run two closed-loop calls from its manifest
    and example inputs alone, as a serving host without the scenes would:
    the outputs' shapes, their finiteness where the input leaf was finite
    (goal_best starts at inf), and that the second call moves the state."""
    step, manifest, leaves = load(path, device)
    device = leaves[0].device
    gen = stream(manifest, device)
    n_state = manifest["n_state_leaves"]

    def call(state_leaves):
        draws = make_draws(manifest["draws"], device, None, gen)
        out = step(*state_leaves, *leaves[n_state:], *draws)
        _sync(device)
        return list(out)

    t0 = time.perf_counter()
    out = call(leaves[:n_state])
    first_call_s = time.perf_counter() - t0
    if len(out) != n_state:
        raise AssertionError(f"{len(out)} outputs for {n_state} state leaves")
    for o, spec in zip(out, manifest["outputs"]):
        if list(o.shape) != spec["shape"]:
            raise AssertionError(f"output {tuple(o.shape)} against {spec}")
    finite = all(bool(torch.isfinite(o).all())
                 for o, i in zip(out, leaves) if o.is_floating_point()
                 and bool(torch.isfinite(i).all()))
    t0 = time.perf_counter()
    out2 = call(out)
    warm_call_s = time.perf_counter() - t0
    moved = any(not torch.equal(a, b) for a, b in zip(out, out2))
    return {"path": path, "env": manifest["env"],
            "platforms": manifest["platforms"], "device": str(device),
            "first_call_s": first_call_s, "warm_call_s": warm_call_s,
            "outputs_finite": finite, "state_advances": moved}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", default=None, help="write the artifact here")
    ap.add_argument("--load", default=None, help="smoke-run an artifact")
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=1,
                    help="control ticks per exported call")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated devices the artifact serves "
                         "('cpu,cuda': traced on the CPU, moved to the card "
                         "at load); default: the tracing device only")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import device_of

    if args.load:
        device = "cpu" if args.cpu else None
        if not args.cpu and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
        print(json.dumps(smoke_run(args.load, device or "cuda"), indent=2))
        return 0
    if not args.save:
        sys.exit("need --save PATH or --load PATH")
    platforms = args.platforms.split(",") if args.platforms else None
    device = device_of(args.cpu or platforms is not None
                       and "cpu" in platforms)
    artifact, manifest, flat = export_step(args.env, args.batch, args.ticks,
                                           platforms, device)
    size = save(args.save, artifact, manifest, flat)
    print(f"exported {args.env} ({manifest['platforms']}, traced on "
          f"{manifest['traced_on']}, {args.batch} envs, {args.ticks} "
          f"tick(s)/call, ops {manifest['ops']}) -> {args.save} "
          f"({size / 1e6:.2f} MB + manifest + example inputs) in "
          f"{manifest['trace_s']:.1f} s trace + {manifest['export_s']:.1f} s "
          f"export")
    return 0


if __name__ == "__main__":
    sys.exit(main())
