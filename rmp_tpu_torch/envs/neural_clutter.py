"""Learned obstacle avoidance in the domain-randomized cluttered scene.

The port's `rmp_tpu/envs/neural_clutter.py`, serving only:
franka/randomized_cluttered with its grouped obstacle leaf swapped for
policies/neural.neural_obstacle (same distance taskmap, same ctx key),
everything else unchanged. The registered scene runs the committed weights
(assets/neural_clutter_franka.npz, the barrier variant).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from rmp_tpu_torch.envs import franka
from rmp_tpu_torch.envs.base import Env
from rmp_tpu_torch.envs.neural_reach import load_trained_net
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.policies import neural
from rmp_tpu_torch.sim.collision import robot_obstacle_distances

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     os.pardir, "assets", "neural_clutter_franka.npz")


def clearance_aux(model, sim) -> dict:
    """aux_fn: the per-pair obstacle distances (B, L, K) after the tick."""
    T_all = K.fk_all(model, sim.q)
    return {"obst_d": robot_obstacle_distances(model, T_all,
                                               sim.obstacles)[3]}


def make_neural_clutter_env(device, net: dict | None = None,
                            gen: torch.Generator | None = None,
                            hidden=(32, 32), train: bool = False,
                            barrier: bool = False) -> Env:
    """franka/randomized_cluttered with the learned obstacle leaf.

    net: weights on `device`; None draws fresh ones from `gen` (default
    seeded 0). barrier=True: the near-contact authority variant
    (repulsion_boost 40, a 1/x metric exploder of std 0.02), the one the
    committed asset was trained as. train=True: no resampling or stuck
    hooks, and the tick's aux carries the per-pair distances
    (clearance_aux)."""
    device = torch.device(device)
    base = franka.env_randomized_cluttered(device)
    hand = base.policies[-1]            # the grouped hand-designed leaf
    if hand.name != "collision_avoidance":
        raise ValueError(f"expected the grouped obstacle leaf last, got "
                         f"{hand.name!r}")
    if net is None:
        gen = gen if gen is not None else torch.Generator(
            device=device).manual_seed(0)
        net = neural.mlp_init(gen, (neural.OBSTACLE_FEATURES, *hidden, 2),
                              device=device)
    kw = (dict(repulsion_boost=40.0, metric_exploder_std_dev=0.02)
          if barrier else {})
    pol = neural.neural_obstacle(taskmap=hand.taskmap, net=net,
                                 name="neural_obstacle", **kw)
    pol.ctx_key = hand.ctx_key
    env = dataclasses.replace(base, name="franka/neural_clutter",
                              policies=base.policies[:-1] + (pol,))
    if train:
        env = dataclasses.replace(env, on_solved=None, stuck_fn=None,
                                  aux_fn=clearance_aux)
    return env


def env_neural_clutter(device) -> Env:
    """Registered scene: the trained obstacle leaf (barrier variant) in the
    production randomized configuration. RMP_NEURAL_CLUTTER_ASSET names
    another weights file and RMP_NEURAL_CLUTTER_BARRIER=0 the variant
    without the barrier, as in the JAX package."""
    path = os.environ.get("RMP_NEURAL_CLUTTER_ASSET", ASSET)
    barrier = os.environ.get("RMP_NEURAL_CLUTTER_BARRIER", "1") == "1"
    return make_neural_clutter_env(device,
                                   net=load_trained_net(path, device),
                                   barrier=barrier)
