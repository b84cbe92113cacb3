"""Checkpoint and resume across real process boundaries on the port's
``train_cnn.py`` (``--device cpu``), case for case with
``tests/test_checkpoint_resume.py``: the per-epoch zip and snapshot
checkpoints resume where they stopped (in process, bit for bit with the
uninterrupted run), and the resilient mode's chaos drills, each in
processes of their own, resume after a SIGKILL with every step's loss
(``--log-steps``, printed with ``%r``) bit for bit with the
uninterrupted run's: killed at a step (zip), killed inside the second
checkpoint write after the staged file (snapshot; the manifest still
names save 1), and ZeRO-1 over two gloo ranks (shard records in the
manifest).  Against the JAX package: its ``train_cnn.py`` killed at step
5 leaves a checkpoint directory the port's ``--resume`` continues from,
the port's steps 3-4 within 1e-5 of the JAX run's own steps 3-4 (the
same state and batches; float32, the local compute's order only: the
bound ``tests/test_torch_cnn.py`` holds the MNIST CNN's steps to)."""

import os
import re
import subprocess
import sys

import numpy as np
import torch

from singa_tpu_torch.examples.cnn import train_cnn

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_TRAIN = os.path.join(_REPO, "examples", "cnn", "train_cnn.py")
_BASE = ["cnn", "-d", "mnist", "-n", "128", "-b", "32", "-l", "0.05",
         "--device", "cpu", "-s", "7"]
_RESILIENT = ["-m", "2", "--ckpt-every", "3", "--log-steps"]
TIMEOUT = 300


def _legacy(extra):
    return train_cnn.main(_BASE + extra)["epoch_losses"]


def test_resume_continues_loss_trajectory(tmp_path):
    ckpt = str(tmp_path / "ck.zip")
    truth = _legacy(["-m", "4"])
    first = _legacy(["-m", "2", "--ckpt", ckpt])
    assert os.path.exists(ckpt)
    second = _legacy(["-m", "4", "--ckpt", ckpt, "--resume"])
    assert first == truth[:2] and second == truth[2:]
    assert second[-1] < first[0]


def test_resume_snapshot_format(tmp_path):
    ckpt = str(tmp_path / "ck")
    fmt = ["--ckpt-format", "snapshot"]
    first = _legacy(["-m", "1", "--ckpt", ckpt] + fmt)
    assert os.path.exists(ckpt + ".bin")
    second = _legacy(["-m", "2", "--ckpt", ckpt, "--resume"] + fmt)
    assert second == _legacy(["-m", "2"])[1:] and second[0] < first[0]


# ---------------------------------------------------------------------------
# chaos: SIGKILL the trainer, resume, every step's loss bit for bit
# ---------------------------------------------------------------------------

def _start(argv):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=_REPO,
                            env=dict(os.environ, JAX_PLATFORMS="cpu",
                                     PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
                                     XLA_FLAGS="--xla_force_host_platform"
                                               "_device_count=2"))


def _port(extra):
    return [sys.executable, "-m", "singa_tpu_torch.examples.cnn.train_cnn"
            ] + _BASE + _RESILIENT + extra


def _finish(runs):
    """``(process, killed?)`` each: its ``step N: loss=...`` strings, the
    exit code checked; every process ends."""
    out = []
    try:
        for proc, killed in runs:
            _, err = proc.communicate(timeout=TIMEOUT)
            if killed:
                assert proc.returncode != 0, \
                    f"chaos kill never fired:\n{err[-2000:]}"
            else:
                assert proc.returncode == 0, err[-2000:]
            out.append({int(m.group(1)): m.group(2) for m in
                        re.finditer(r"step (\d+): loss=(\S+)", err)})
    finally:
        for proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _assert_bitmatch(truth, killed, resumed):
    assert sorted(truth) == list(range(8))
    assert min(resumed) == 3, f"expected resume at step 3: {resumed}"
    covered = dict(killed)
    covered.update(resumed)
    assert sorted(covered) == sorted(truth)
    for s in sorted(truth):
        assert covered[s] == truth[s], \
            f"step {s} diverged: {covered[s]} != {truth[s]} (truth)"


def _drill(tmp_path, kill, fmt=()):
    ckdir = str(tmp_path / "ck")
    truth, killed = _finish([
        (_start(_port(["--ckpt", str(tmp_path / "truth")] + list(fmt))),
         False),
        (_start(_port(["--ckpt", ckdir] + kill + list(fmt))), True)])
    leftover = sorted(os.listdir(ckdir))
    resumed, = _finish([(_start(_port(["--ckpt", ckdir, "--resume"]
                                      + list(fmt))), False)])
    _assert_bitmatch(truth, killed, resumed)
    return killed, leftover


# a kill at a step follows the save at step 3 by two steps; written on
# the training thread (--ckpt-sync) the save is published before the
# kill whatever the host's load (an async write may still be in flight)
_KILL_STEP = ["--ckpt-sync", "--chaos-kill-step", "5"]


def test_chaos_kill_and_resume_bitmatch_zip(tmp_path):
    killed, _ = _drill(tmp_path, _KILL_STEP)
    assert sorted(killed) == [0, 1, 2, 3, 4]


def test_chaos_kill_mid_checkpoint_write_snapshot(tmp_path):
    """The SIGKILL lands inside the 2nd write (async: a save waits for
    the one before it), the file staged but not published: the manifest
    still names save 1 (step 3)."""
    _, leftover = _drill(tmp_path, ["--chaos-kill-save", "2",
                                    "--chaos-kill-phase", "staged"],
                         ["--ckpt-format", "snapshot"])
    assert "ckpt-00000003.bin" in leftover, leftover
    assert "ckpt-00000006.bin" not in leftover, leftover


def test_chaos_kill_and_resume_zero1(tmp_path):
    """ZeRO-1 over two gloo ranks: every rank SIGKILLs itself at step 5;
    the manifest's shard records stitch back on resume."""
    import json
    _drill(tmp_path, _KILL_STEP + ["--zero1", "2"], ["--zero1", "2"])
    with open(tmp_path / "ck" / "manifest.json") as f:
        entry = json.load(f)["checkpoints"][-1]
    assert entry["meta"]["shards"] and all(
        len(info["parts"]) == 2 for info in entry["meta"]["shards"].values())


def test_jax_killed_run_resumes_in_the_port(tmp_path):
    ckdir = str(tmp_path / "ck")
    killed, = _finish([(_start(
        [sys.executable, _JAX_TRAIN] + _BASE + _RESILIENT
        + ["--ckpt", ckdir] + _KILL_STEP), True)])
    assert sorted(killed) == [0, 1, 2, 3, 4]
    out = train_cnn.main(_BASE + _RESILIENT + ["--ckpt", ckdir,
                                               "--resume"])
    steps = dict(out["steps"])
    assert sorted(steps) == list(range(3, 8))
    np.testing.assert_allclose([steps[3], steps[4]],
                               [float(killed[3]), float(killed[4])],
                               rtol=0, atol=1e-5)
    assert np.isfinite(list(steps.values())).all()
