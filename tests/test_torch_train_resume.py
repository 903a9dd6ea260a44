"""`train_neural_clutter --resume` and the criterion that scored the best
iterate: a checkpoint records --select and --resample-every; a resume under
another criterion drops the checkpoint's best (its score is not comparable)
and starts again from the restored net, and a resume under the same one
keeps it, so that the resumed run ends where the unbroken run ends. Tiny
runs on the CPU (2 envs x 3 ticks, a hidden layer of 6)."""
import math

import pytest
import torch

from rmp_tpu_torch.experiments import train_neural_clutter as clutter
from rmp_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

TINY = ["--cpu", "--batch", "2", "--ticks", "3", "--hidden", "6",
        "--steps", "3", "--ckpt-every", "1"]


def train(ckpt, *extra):
    assert clutter.main(TINY + ["--ckpt", str(ckpt), *extra]) is None
    net = {k: torch.zeros_like(v) for k, v in torch.load(
        ckpt, weights_only=True)["net"].items()}
    step, live, _, best_val, best_net = checkpoint.restore_train_checkpoint(
        ckpt, net)
    return step, live, best_val, best_net, checkpoint.train_checkpoint_meta(
        ckpt)


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    """One step under --select loss, its checkpoint's bytes and contents."""
    path = tmp_path_factory.mktemp("resume") / "first.ckpt"
    out = train(path, "--stop-after", "1")
    return path.read_bytes(), out


def resumed(tmp_path, first, *extra):
    path = tmp_path / "resumed.ckpt"
    path.write_bytes(first[0])
    return train(path, "--resume", "--stop-after", "1", *extra)


def test_checkpoint_records_the_criterion(first):
    step, _, best_val, _, meta = first[1]
    assert step == 1 and math.isfinite(best_val)
    assert meta == dict(criterion=dict(select="loss", resample_every=0))


@pytest.mark.parametrize("extra", [("--select", "task"),
                                   ("--resample-every", "2")])
def test_resume_under_another_criterion_drops_the_stale_best(tmp_path, first,
                                                             extra):
    # step 1 of 3 neither scores on the eval batch (every 10th and the last
    # step do) nor, under these criteria, by its training loss: the best
    # stays where the resume put it
    _, live0, _, _, _ = first[1]
    step, _, best_val, best_net, meta = resumed(tmp_path, first, *extra)
    assert step == 2
    assert best_val == float("inf")
    for k, v in live0.items():
        assert torch.equal(best_net[k], v), k
    assert meta["criterion"] != first[1][4]["criterion"]


def test_resume_under_the_same_criterion_keeps_the_best(tmp_path, first):
    got = resumed(tmp_path, first)
    whole = train(tmp_path / "whole.ckpt", "--stop-after", "2")
    assert got[0] == whole[0] == 2
    assert got[2] == whole[2] and got[2] <= first[1][2]
    for mine, theirs in ((got[1], whole[1]), (got[3], whole[3])):
        for k, v in theirs.items():
            assert torch.equal(mine[k], v), k
    assert got[4] == whole[4]
