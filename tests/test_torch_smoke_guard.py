"""What chip_smoke.py, the port's one run on the card, must keep, read from
its source with `ast` (nothing here runs it): every `phase_*` function is
reached from main(), the phases are numbered 1, 2, ... with no gap, no
`except` swallows a failure wholesale (bare, Exception, BaseException),
nothing of JAX or the JAX package is imported, and no parity or
statistical horizon is smaller than the depths the smoke was last cut to."""
import ast
import os

import pytest

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")

# the least depths: (envs, ticks) or ticks, as the smoke was last cut
LEAST = {
    "PARITY_TICKS": 8,
    "RANDOMIZED_TICKS": 300,
    "DUAL_PARITY": {"capsule": (32, 8), "hull": (16, 4)},
    "HANDOVER_HULL_PARITY": (32, 4),
    "CONTACT_PARITY": (128, 3),
    "HULL_MODEL_PARITY": (128, 3),
    "NEURAL_PARITY": {"two_joint/neural_reach": (128, 3),
                      "franka/neural_reach": (128, 3),
                      "franka/neural_clutter": (128, 4)},
    # phase 20's wide K5 layouts: the arms, the odd n, the obstacles an env
    "K5_WIDE_LINKS": (17, 24, 32),
    "K5_WIDE_ODD": (19, 31),
    "K5_WIDE_CYLINDERS": 4,
    # phase 23's K1 n, the slice's arm, its timed ticks and its parity
    "PAST32_K1_N": (33, 36, 47, 48, 63, 64),
    "PAST32_LINKS": 64,
    "PAST32_TICKS": 10,
    "PAST32_PARITY": (32, 3),
}


@pytest.fixture(scope="module")
def tree():
    with open(SMOKE) as f:
        return ast.parse(f.read())


def functions(tree) -> dict:
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}


def names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def test_every_phase_is_reached_from_main(tree):
    defs = functions(tree)
    reached, todo = set(), ["main"]
    while todo:
        name = todo.pop()
        if name in reached or name not in defs:
            continue
        reached.add(name)
        todo.extend(names_in(defs[name]))
    phases = {name for name in defs if name.startswith("phase_")}
    assert phases, "no phase_* function"
    assert not phases - reached, sorted(phases - reached)


def test_main_numbers_its_phases_without_a_gap(tree):
    numbers = [call.args[0].value for call in ast.walk(tree)
               if isinstance(call, ast.Call)
               and isinstance(call.func, ast.Name)
               and call.func.id in ("run_phase", "phase")
               and call.args and isinstance(call.args[0], ast.Constant)
               and isinstance(call.args[0].value, int)]
    assert sorted(numbers) == list(range(1, len(numbers) + 1)), numbers
    assert len(numbers) >= 21


def test_no_wholesale_except(tree):
    caught = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        kinds = (node.type.elts if isinstance(node.type, ast.Tuple)
                 else [node.type])
        for kind in kinds:
            if kind is None or (isinstance(kind, ast.Name) and kind.id in
                                ("Exception", "BaseException")):
                caught.append(node.lineno)
    assert not caught, f"wholesale except at lines {caught}"


def test_imports_nothing_of_jax(tree):
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        found += [m for m in mods
                  if m.split(".")[0] in ("jax", "jaxlib", "rmp_tpu")]
    assert not found, found


def constants(tree) -> dict:
    """Module-level NAME = literal assignments (dict keys that are names
    read as the name's own literal)."""
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if isinstance(value, ast.Dict):
            value = ast.Dict(keys=[ast.Constant(out[k.id]) if isinstance(
                k, ast.Name) and k.id in out else k for k in value.keys],
                values=value.values)
        try:
            out[node.targets[0].id] = ast.literal_eval(value)
        except ValueError:
            pass
    return out


def no_smaller(got, least) -> bool:
    if isinstance(least, dict):
        return set(got) >= set(least) and all(no_smaller(got[k], v)
                                              for k, v in least.items())
    if isinstance(least, tuple):
        return len(got) == len(least) and all(g >= v for g, v in
                                              zip(got, least))
    return got >= least


@pytest.mark.parametrize("name", sorted(LEAST))
def test_parity_and_statistics_depths_are_kept(tree, name):
    got = constants(tree)
    assert name in got, f"{name} is no longer a literal constant"
    assert no_smaller(got[name], LEAST[name]), (name, got[name])


@pytest.mark.parametrize("function, needs", [
    ("phase_k5_wide", {"k5_wide_layouts", "k5_wide_check", "RAGGED",
                       "K5_WIDE_TAIL"}),
    ("k5_wide_layouts", {"K5_WIDE_LINKS", "K5_WIDE_ODD", "K5_WIDE_TAIL",
                         "k5_tail_env", "branched_model", "k5_cylinders",
                         "K5_WIDE_CYLINDERS"})])
def test_phase_20_holds_every_wide_k5_layout(tree, function, needs):
    """Phase 20 holds the wide K5 on every layout of k5_wide_layouts (the
    arms, the odd n, the 40-frame tail, the branched tree, K = 4) behind
    k5_wide_check, with the ragged batches."""
    assert needs <= names_in(functions(tree)[function])


@pytest.mark.parametrize("function, needs", [
    ("phase_slice21", {"phase_k1_past32", "past32_models", "k3_check",
                       "k3_raises", "k3_real_tick", "k1_compare_conditioned",
                       "rollout_path", "gpu_cpu_parity", "PAST32_LINKS",
                       "PAST32_TICKS", "PAST32_PARITY", "PAST32_RAGGED"}),
    ("phase_k1_past32", {"PAST32_K1_N", "PAST32_RAGGED", "BATCH", "k1_held",
                         "PAST32_TRANSPOSED_N", "k1_raises"}),
    ("past32_models", {"planar_model", "four_pandas", "fixed_tail_model",
                       "branched_model", "PAST32_LINKS"})])
def test_phase_23_holds_every_model_past_32(tree, function, needs):
    """Phase 23 holds K1 at the n of PAST32_K1_N (ragged batches, float32
    and bfloat16, its backward, n = 65 raising), K3 on the five models of
    past32_models (65 motors and 73 frames raising) and the 64-link arm's
    rollout with its GPU/CPU parity."""
    assert needs <= names_in(functions(tree)[function])


def test_phase_23_is_run_by_main(tree):
    calls = [call for call in ast.walk(functions(tree)["run_phases"])
             if isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
             and call.func.id == "phase" and len(call.args) >= 2]
    assert any(isinstance(c.args[0], ast.Constant) and c.args[0].value == 23
               and isinstance(c.args[1], ast.Name)
               and c.args[1].id == "phase_slice21" for c in calls)


def test_phase_18_sweeps_k1_at_1_to_32_by_name(tree):
    """Phase 18's K1 sweep runs over K1_EVERY_N = range(1, 33), named, not
    over cuda_resolve.KERNEL_N (which now reaches 64: the CTA kernel's n
    are phase 23's), so its cost stays as it was."""
    value = next(node.value for node in tree.body
                 if isinstance(node, ast.Assign)
                 and isinstance(node.targets[0], ast.Name)
                 and node.targets[0].id == "K1_EVERY_N")
    assert ast.unparse(value) == "range(1, 33)"
    sweep = functions(tree)["phase_k1_every_n"]
    assert "K1_EVERY_N" in names_in(sweep)
    assert "KERNEL_N" not in {n.attr for n in ast.walk(sweep)
                              if isinstance(n, ast.Attribute)}
