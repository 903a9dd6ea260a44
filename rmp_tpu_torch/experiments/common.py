"""What the port's tools share: the device choice, where a report goes,
the card's name; and for the trainers value-and-grad of a loss over a dict
of leaf tensors and the JAX trainers' optimizer (optax's hold-then-cosine
schedule, clip_by_global_norm, then Adam)."""
from __future__ import annotations

import math
import os
import subprocess

import torch

from rmp_tpu_torch import default_device

# the checkout that holds the package: reports go to its chiprun_out/, and
# its reports/ (the JAX package's tools' reports) is never written
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPORT_DIR = os.path.join(ROOT, "chiprun_out")


def device_of(cpu: bool) -> torch.device:
    """The CPU with --cpu, else the card (raises without one)."""
    return torch.device("cpu") if cpu else default_device()


def _under(path: str, directory: str) -> bool:
    return os.path.commonpath([path, directory]) == directory


def report_path(name: str, out: str | None = None) -> str:
    """Where a tool writes its report: `out`, else chiprun_out/<name> of
    the checkout (made if missing). Raises on a path under the checkout's
    reports/ and on an existing file of the checkout outside chiprun_out/:
    a tool never overwrites a file the repository holds."""
    path = os.path.abspath(out or os.path.join(REPORT_DIR, name))
    if _under(path, os.path.join(ROOT, "reports")) or (
            os.path.exists(path) and _under(path, ROOT)
            and not _under(path, REPORT_DIR)):
        raise ValueError(f"{path}: a report may not overwrite a file of the "
                         f"repository; write to chiprun_out/ or elsewhere")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device: torch.device) -> str:
    """'name, power limit' of the card as nvidia-smi reports them (the
    name alone where nvidia-smi does not answer), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def leaves(tree: dict) -> dict:
    """Fresh leaf tensors that require grad, from a dict of tensors."""
    return {k: v.detach().clone().requires_grad_() for k, v in tree.items()}


def value_and_grad(loss, theta: dict):
    """(loss(theta) detached, {key: d loss / d theta[key]})."""
    val = loss(theta)
    grads = torch.autograd.grad(val, list(theta.values()))
    return val.detach(), dict(zip(theta, grads))


def schedule(lr: float, steps: int):
    """optax.join_schedules([constant(lr), cosine_decay(lr, max(steps -
    hold, 1), alpha=0.05)], [hold]) with hold = int(0.6 steps), as a
    function of the update count."""
    hold = int(steps * 0.6)
    decay = max(steps - hold, 1)

    def lr_at(count: int) -> float:
        if count < hold:
            return lr
        k = min(count - hold, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * k / decay))
        return lr * ((1.0 - 0.05) * cosine + 0.05)
    return lr_at


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm's rule: the gradients as they are while
    their global norm is below max_norm, else (g / norm) * max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm)
            for k, g in grads.items()}


class Trainer:
    """torch.optim.Adam on the leaves of a net, with the JAX trainers'
    update: optional global-norm clipping (clip <= 0 disables it), then
    Adam at the schedule's rate for the update count."""

    def __init__(self, net: dict, lr: float, steps: int, clip: float):
        self.net = net
        self.clip = clip
        self.lr_at = schedule(lr, steps)
        self.opt = torch.optim.Adam(list(net.values()), lr=lr)

    def update(self, grads: dict, count: int) -> None:
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(count)
        for k, p in self.net.items():
            p.grad = grads[k].detach().clone()
        self.opt.step()
