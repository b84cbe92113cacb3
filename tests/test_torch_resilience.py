"""The port's resilience subsystem (singa_tpu_torch.resilience) on the
CPU, case for case with ``tests/test_resilience.py`` where a case has a
meaning in the port (the lint case has none: the port has no analysis
passes), and against the JAX package's:

* CheckpointManager: atomic publication, keep-last-K, CRC fallback,
  manifest recovery, async error surfacing, the kill-mid-write seam,
  files that plain ``Model.load_states`` reads, the span and counter
  names;
* directories cross both ways: one the JAX package's manager wrote
  (zip and snapshot, loader cursor and aux in its manifest) restores in
  the port through ``restore_latest``, and the port's in JAX, every
  state exact and the next two steps within 1e-5 of the other side's
  (float32, the local compute's order only); under ZeRO-1 at world 2
  (gloo ranks through ``tests/_torch_dist_cases.py`` against JAX's
  two-device mesh) the ``name@shard{i}`` records and manifest ``shards``
  entries equal JAX's, and the shards stitch back on either side;
* the RNG record: the port writes ``torch_rng``, never ``rng``; each
  package leaves its generator alone on the other's checkpoint;
* ResilientTrainer: skip (an exact no-op, bit-identical numerics when
  armed), raise, give-up, rollback (in place; the reseed draws other
  dropout masks on the replay, the same in every run), spike, stall,
  crash, grad norm, the run loop; the fault plan: ``random`` equal to
  JAX's for a seed, the poison keeping type, shape, dtype and device.
"""

import json
import os

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.data import ArrayDataset as JArrayDataset
from singa_tpu.data import DataLoader as JDataLoader
from singa_tpu.model import Model as JModel
from singa_tpu.resilience import CheckpointManager as JCheckpointManager
from singa_tpu.resilience import TrainFaultPlan as JTrainFaultPlan
from singa_tpu_torch import autograd, layer, opt
from singa_tpu_torch.data import ArrayDataset, DataLoader
from singa_tpu_torch.device import get_device
from singa_tpu_torch.model import Model
from singa_tpu_torch.parallel import launch
from singa_tpu_torch.resilience import (CheckpointManager,
                                        CorruptCheckpointError,
                                        CrashAtStep, KillMidCheckpointWrite,
                                        NaNGrads, NonFiniteLossError,
                                        ResilientTrainer, SlowStep,
                                        SpikeGrads, TrainFaultPlan,
                                        TrainingStalledError)
from singa_tpu_torch.tensor import Tensor
from singa_tpu_torch.telemetry import registry as tregistry
from singa_tpu_torch.telemetry import tracer as ttracer

import _torch_dist_cases as dist_cases

torch.set_num_threads(1)

ATOL = 1e-5


class _MLP(Model):
    def __init__(self, hidden=16, classes=4, dropout=0.0):
        super().__init__()
        self.fc1 = layer.Linear(hidden)
        self.relu = layer.ReLU()
        self.drop = layer.Dropout(dropout) if dropout else None
        self.fc2 = layer.Linear(classes)

    def forward(self, x):
        h = self.relu(self.fc1(x))
        return self.fc2(self.drop(h) if self.drop is not None else h)

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


class _JMLP(JModel):
    def __init__(self):
        super().__init__()
        self.fc1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = jautograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def _data(seed=3, n=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def _model(seed=3, lr=0.05, dropout=0.0):
    """The MLP on the CPU, its weights and draws from the seeded
    generator of the CPU device."""
    x, y = _data(seed)
    get_device("cpu").set_rand_seed(seed)
    m = _MLP(dropout=dropout)
    m.set_optimizer(opt.SGD(lr=lr, momentum=0.9))
    m.compile([Tensor(data=x, device="cpu")], is_train=True,
              use_graph=True)
    m.device.set_rand_seed(seed)
    return m, x, y


def _params(m):
    return {k: t.numpy() for k, t in m.get_states().items()}


def _states(m):
    out = _params(m)
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["zip", "snapshot"])
def test_save_restore_roundtrip(tmp_path, fmt):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), fmt=fmt, async_save=False)
    for _ in range(3):
        m.train_one_batch(x, y)
    want = _states(m)
    ck.save(3, aux={"note": 7})
    for _ in range(4):  # drift away from the checkpoint
        m.train_one_batch(x, y)
    drifted = _params(m)
    assert any(not np.array_equal(want[k], drifted[k]) for k in drifted)
    meta = ck.restore_latest()
    assert meta["step"] == 3 and meta["aux"]["note"] == 7
    got = _states(m)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_keep_last_k_retention(tmp_path):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.train_one_batch(x, y)
        ck.save(s)
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt"))
    assert files == ["ckpt-00000003.zip", "ckpt-00000004.zip"]
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert [e["step"] for e in manifest["checkpoints"]] == [3, 4]


def test_corrupt_newest_falls_back_to_older(tmp_path):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), async_save=False)
    m.train_one_batch(x, y)
    ck.save(1)
    want = _params(m)
    m.train_one_batch(x, y)
    ck.save(2)
    newest = tmp_path / "ckpt-00000002.zip"  # flip bytes: CRC catches it
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0xFF
    newest.write_bytes(bytes(data))
    before = tregistry.default_registry().counter(
        "train_checkpoint_corrupt_total").value
    meta = ck.restore_latest()
    assert meta["step"] == 1
    assert tregistry.default_registry().counter(
        "train_checkpoint_corrupt_total").value == before + 1
    got = _params(m)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_truncated_snapshot_without_crc_falls_back(tmp_path):
    """A snapshot truncated behind a manifest that has no CRC (one
    recovered from the directory) fails to decode and restore falls
    back past it."""
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), fmt="snapshot",
                           async_save=False)
    m.train_one_batch(x, y)
    ck.save(1)
    m.train_one_batch(x, y)
    ck.save(2)
    newest = tmp_path / "ckpt-00000002.bin"
    newest.write_bytes(newest.read_bytes()[:-7])
    (tmp_path / "manifest.json").write_text("garbage")
    assert CheckpointManager(m, str(tmp_path), fmt="snapshot",
                             async_save=False).restore_latest()["step"] == 1
    with pytest.raises(CorruptCheckpointError):
        m.load_states(str(newest))


def test_corrupt_manifest_recovers_from_directory(tmp_path):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), async_save=False)
    m.train_one_batch(x, y)
    ck.save(1, aux={"step": 1})
    (tmp_path / "manifest.json").write_text("{ not json !")
    ck2 = CheckpointManager(m, str(tmp_path), async_save=False)
    meta = ck2.restore_latest()
    assert meta["step"] == 1 and meta["aux"]["step"] == 1


def test_restore_latest_none_when_empty(tmp_path):
    m, _, _ = _model()
    assert CheckpointManager(m, str(tmp_path)).restore_latest() is None
    with pytest.raises(ValueError, match="format"):
        CheckpointManager(m, str(tmp_path), fmt="orbax")


def test_async_write_error_surfaces_on_next_save(tmp_path, monkeypatch):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), async_save=True)
    monkeypatch.setattr(ck, "_write",
                        lambda *a: (_ for _ in ()).throw(OSError("disk")))
    m.train_one_batch(x, y)
    ck.save(1)  # backgrounded; failure is stored
    with pytest.raises(OSError, match="disk"):
        ck.wait()


def test_async_save_snapshots_before_the_next_step(tmp_path, monkeypatch):
    """The payload an async save hands its writer is the state at the
    save, whatever the steps after it do in place while the writer
    runs."""
    import threading
    m, x, y = _model()
    m.train_one_batch(x, y)
    want = _states(m)
    gate = threading.Event()
    ck = CheckpointManager(m, str(tmp_path), async_save=True)
    write = ck._write

    def held(*a):
        gate.wait(30)
        write(*a)
    monkeypatch.setattr(ck, "_write", held)
    ck.save(1)
    for _ in range(3):                 # in place, while the writer waits
        m.train_one_batch(x, y)
    assert ck.in_flight
    gate.set()
    ck.wait()
    fresh, _, _ = _model(seed=9)
    fresh.load_states(str(tmp_path / "ckpt-00000001.zip"))
    got = _states(fresh)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kill_staged_leaves_previous_published(tmp_path):
    class _Die(BaseException):
        pass

    def die():
        raise _Die()

    m, x, y = _model()
    faults = TrainFaultPlan(KillMidCheckpointWrite(at_save=2,
                                                   phase="staged"),
                            kill=die)
    ck = CheckpointManager(m, str(tmp_path), async_save=False,
                           faults=faults)
    m.train_one_batch(x, y)
    ck.save(1)
    m.train_one_batch(x, y)
    with pytest.raises(_Die):
        ck.save(2)
    assert faults.events == ["kill_mid_ckpt:save2:staged"]
    assert os.path.exists(tmp_path / "ckpt-00000002.zip.tmp")
    assert not os.path.exists(tmp_path / "ckpt-00000002.zip")
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert [e["step"] for e in manifest["checkpoints"]] == [1]
    assert ck.restore_latest()["step"] == 1


@pytest.mark.parametrize("fmt", ["zip", "snapshot"])
def test_checkpoint_files_load_via_model_load_states(tmp_path, fmt):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), fmt=fmt, async_save=False)
    m.train_one_batch(x, y)
    want = _states(m)
    path = ck.save(1, aux={"step": 1})
    m2, _, _ = _model(seed=9)
    aux = m2.load_states(path)
    assert int(aux["step"]) == 1
    got = _states(m2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# directories across the two packages
# ---------------------------------------------------------------------------

def _jax_mlp(x, seed=3):
    np.random.seed(seed)
    m = _JMLP()
    m.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    m.compile([jtensor.from_numpy(x)], is_train=True, use_graph=True)
    return m


def _jstates(m):
    out = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    out.update({f"opt.{k}": np.asarray(v)
                for k, v in m.optimizer.get_states().items()})
    return out


def _batches(loader, n):
    """The loader's next ``n`` batches, across epochs (its cursor moves
    as a training loop's would)."""
    out = []
    while len(out) < n:
        it = iter(loader)
        for batch in it:
            out.append(batch)
            if len(out) == n:
                break
        it.close()
    return out


def _jsteps(m, loader, n):
    return [float(m.train_one_batch(jtensor.from_numpy(xb),
                                    jtensor.from_numpy(yb))[1].data)
            for xb, yb in _batches(loader, n)]


def _tsteps(m, loader, n):
    return [m.train_one_batch(xb, yb)[1].item()
            for xb, yb in _batches(loader, n)]


@pytest.mark.parametrize("fmt", ["zip", "snapshot"])
def test_jax_directory_restores_in_the_port_and_back(tmp_path, fmt):
    """JAX trains 3 steps through a loader and its manager saves
    (cursor and aux in the manifest); the port's ``restore_latest``
    gives every state exactly, the cursor and the aux, and its next two
    steps equal JAX's within ATOL.  Then the port saves after two more
    steps and JAX restores that directory the same way."""
    x, y = _data(n=64)
    jm = _jax_mlp(x[:16])
    jdl = JDataLoader(JArrayDataset(x, y), 16, seed=4)
    jck = JCheckpointManager(jm, str(tmp_path / "jax"), fmt=fmt,
                             async_save=False)
    _jsteps(jm, jdl, 3)
    jck.save(3, aux={"note": 5}, loader=jdl)
    want = _jstates(jm)
    jnext = _jsteps(jm, jdl, 2)

    tm, _, _ = _model(seed=11)
    tdl = DataLoader(ArrayDataset(x, y), 16, seed=4)
    meta = CheckpointManager(tm, str(tmp_path / "jax"), fmt=fmt
                             ).restore_latest()
    assert meta["step"] == 3 and meta["aux"]["note"] == 5
    assert "torch_rng" not in meta and "rng" in meta
    tdl.load_state_dict(meta["loader"])
    got = _states(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(_tsteps(tm, tdl, 2), jnext, rtol=0,
                               atol=ATOL)

    tck = CheckpointManager(tm, str(tmp_path / "port"), fmt=fmt,
                            async_save=True)
    tck.save(5, aux={"note": 6}, loader=tdl)
    tck.wait()
    want = _states(tm)
    tnext = _tsteps(tm, tdl, 2)
    jm2 = _jax_mlp(x[:16], seed=8)
    jdl2 = JDataLoader(JArrayDataset(x, y), 16, seed=4)
    meta = JCheckpointManager(jm2, str(tmp_path / "port"), fmt=fmt
                              ).restore_latest()
    assert meta["step"] == 5 and meta["aux"]["note"] == 6
    assert "rng" not in meta and "torch_rng" in meta
    jdl2.load_state_dict(meta["loader"])
    got = _jstates(jm2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(_jsteps(jm2, jdl2, 2), tnext, rtol=0,
                               atol=ATOL)


def test_rng_record_is_the_ports_own(tmp_path, caplog):
    """The port's generator state is restored from ``torch_rng``; a
    JAX-written checkpoint leaves the generator as it is, and says so."""
    import logging
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path / "port"), async_save=False)
    m.train_one_batch(x, y)
    saved = m.device.get_rng_state().clone()
    ck.save(1)
    m.device.set_rand_seed(123)
    ck.restore_latest()
    assert torch.equal(m.device.get_rng_state(), saved)
    jm = _jax_mlp(x)
    JCheckpointManager(jm, str(tmp_path / "jax"), async_save=False).save(1)
    m.device.set_rand_seed(77)
    before = m.device.get_rng_state().clone()
    with caplog.at_level(logging.INFO):
        CheckpointManager(m, str(tmp_path / "jax")).restore_latest()
    assert torch.equal(m.device.get_rng_state(), before)
    assert "RNG key only" in caplog.text


def test_zero1_shard_aware_directories_cross_at_world_2(tmp_path):
    """World 2, ZeRO-1 (``sharded``), 3 steps: the port's and JAX's
    shard-aware managers write the same ``shards`` manifest entries and
    records; each side restores the other's directory and its next
    step equals the other's (rtol 1e-5, atol 1e-6, test_torch_dist.py's
    bounds); ``DistOpt.publish_metrics`` sets its gauges to its
    counts."""
    from test_torch_dist import (ATOL as DATOL, RTOL as DRTOL, jax_build,
                                 jax_states, jax_train, make_data)
    case = {"variant": "sharded"}
    x, y = make_data()
    init = {k: np.asarray(v.data)
            for k, v in jax_build(case, x, {}).get_states().items()}
    jm = jax_build(case, x, init)
    jck = JCheckpointManager(jm, str(tmp_path / "jax_mgr"),
                             shard_aware=True, async_save=False)
    jax_train(jm, [(x, y)] * 3)
    jck.save(3, aux={"step": 3})
    jnext = jax_train(jm, [(x, y)])[0]
    jnext_states = jax_states(jm)
    port = launch(dist_cases.resilience_zero1, 2,
                  args=(x, y, init, str(tmp_path), 3), device="cpu",
                  timeout=300)

    manifests = {side: json.load(open(tmp_path / side / "manifest.json"))
                 for side in ("jax_mgr", "port_mgr")}
    shards = {side: m["checkpoints"][-1]["meta"]["shards"]
              for side, m in manifests.items()}
    assert shards["port_mgr"] == shards["jax_mgr"] and shards["jax_mgr"]
    assert port["jax_meta_step"] == 3
    np.testing.assert_allclose(port["jax_loaded_loss"], jnext, rtol=DRTOL,
                               atol=DATOL)
    for k in jnext_states:
        np.testing.assert_allclose(port["jax_loaded"][k], jnext_states[k],
                                   rtol=DRTOL, atol=DATOL, err_msg=k)
    jm2 = jax_build(case, x, init)
    meta = JCheckpointManager(jm2, str(tmp_path / "port_mgr"),
                              shard_aware=True).restore_latest()
    assert meta["step"] == 3
    np.testing.assert_allclose(jax_train(jm2, [(x, y)])[0],
                               port["port_next_loss"], rtol=DRTOL,
                               atol=DATOL)
    text = port["prometheus"]
    calls = port["distopt_stats"]["allreduce_calls"]
    assert f'distopt_allreduce_calls{{run="zero1"}} {calls}' in text
    for (op, axis), n in port["comm_stats"]["calls"].items():
        assert f'comm_calls{{axis="{axis}",op="{op}",run="zero1"}} {n}' \
            in text


# ---------------------------------------------------------------------------
# ResilientTrainer watchdogs
# ---------------------------------------------------------------------------

def test_skip_policy_is_exact_noop():
    m, x, y = _model()
    faults = TrainFaultPlan(NaNGrads(at_step=3))
    tr = ResilientTrainer(m, nonfinite_policy="skip", faults=faults)
    for i in range(6):
        if i == 3:
            before = _states(m)
        tr.step(x, y)
        if i == 3:
            assert tr.last.nonfinite and tr.last.skipped
            after = _states(m)
            for k in before:   # the guard reverted the update exactly;
                if k in ("opt.opt_step", "opt.loss_scale_good_steps"):
                    continue   # the counters move, as the reference's
                np.testing.assert_array_equal(after[k], before[k],
                                              err_msg=k)
    assert np.isfinite(tr.last.loss)


def test_skip_guard_does_not_change_numerics():
    m1, x, y = _model()
    plain = [m1.train_one_batch(x, y)[1].item() for _ in range(5)]
    m2, _, _ = _model()
    tr = ResilientTrainer(m2, nonfinite_policy="skip")
    guarded = []
    for _ in range(5):
        tr.step(x, y)
        guarded.append(tr.last.loss)
    assert guarded == plain


def test_raise_policy():
    m, x, y = _model()
    tr = ResilientTrainer(m, nonfinite_policy="raise",
                          faults=TrainFaultPlan(NaNGrads(at_step=1)))
    tr.step(x, y)
    with pytest.raises(NonFiniteLossError):
        tr.step(x, y)


def test_skip_gives_up_after_max_consecutive():
    m, x, y = _model()
    tr = ResilientTrainer(m, nonfinite_policy="skip",
                          max_consecutive_nonfinite=2,
                          faults=TrainFaultPlan(NaNGrads(at_step=0,
                                                         count=10)))
    tr.step(x, y)
    tr.step(x, y)
    with pytest.raises(NonFiniteLossError, match="consecutive"):
        tr.step(x, y)


def test_rollback_policy_recovers(tmp_path):
    """The poisoned step rolls back to step 4 in place; the replayed
    steps (no draw on this net) equal an unpoisoned run's bit for
    bit."""
    m0, x, y = _model()
    clean = [m0.train_one_batch(x, y)[1].item() for _ in range(8)]
    m, _, _ = _model()
    ck = CheckpointManager(m, str(tmp_path), async_save=False)
    tr = ResilientTrainer(m, checkpoint=ck, save_every=2,
                          nonfinite_policy="rollback",
                          faults=TrainFaultPlan(NaNGrads(at_step=5)))
    losses = {}
    guard = 0
    while tr.step_index < 8 and guard < 30:
        tr.step(x, y)
        if not tr.last.rolled_back:
            losses[tr.last.index] = tr.last.loss
        guard += 1
    assert tr.rollbacks == 1 and tr.step_index == 8
    assert [losses[i] for i in range(8)] == clean
    reg = tregistry.default_registry()
    assert reg.get("train_watchdog_rollback_total").value >= 1


def test_rollback_reseed_draws_other_masks_the_same_in_every_run(tmp_path):
    """With dropout: the replay of step 2 after the rollback draws
    another mask than its first run (the rollback count folded into the
    generator), and two runs of the same seed give the same losses."""
    runs = []
    for r in range(2):
        m, x, y = _model(dropout=0.5)
        ck = CheckpointManager(m, str(tmp_path / f"r{r}"),
                               async_save=False)
        tr = ResilientTrainer(m, checkpoint=ck, save_every=2,
                              nonfinite_policy="rollback",
                              faults=TrainFaultPlan(NaNGrads(at_step=3)))
        seen = []
        while tr.step_index < 5 and len(seen) < 20:
            tr.step(x, y)
            seen.append((tr.last.index, tr.last.loss))
        runs.append(seen)
    assert repr(runs[0]) == repr(runs[1])      # NaN at the poisoned step
    first = dict(runs[0][:3])
    replay = [loss for i, loss in runs[0][4:] if i == 2]
    assert [i for i, _ in runs[0]] == [0, 1, 2, 3, 2, 3, 4]
    assert replay and replay[0] != first[2]


def test_rollback_without_checkpoint_rejected():
    m, _, _ = _model()
    with pytest.raises(ValueError, match="rollback"):
        ResilientTrainer(m, nonfinite_policy="rollback")
    with pytest.raises(ValueError, match="policy"):
        ResilientTrainer(m, nonfinite_policy="ignore")


def test_spike_detector_fires_on_scaled_batch():
    m, x, y = _model()
    faults = TrainFaultPlan(SpikeGrads(at_step=10, factor=1e5))
    tr = ResilientTrainer(m, track_grad_norm=True, spike_factor=50.0,
                          faults=faults)
    spikes = []
    for _ in range(12):
        tr.step(x, y)
        if tr.last.spike:
            spikes.append(tr.last.index)
        assert not tr.last.nonfinite
    assert spikes and spikes[0] == 10
    assert faults.events == ["spike_grads:step10"]


def test_stall_watchdog_raises_after_budget():
    fake = {"t": 0.0}
    faults = TrainFaultPlan(SlowStep(at_step=2, ms=50.0, count=10),
                            sleep=lambda s: fake.__setitem__(
                                "t", fake["t"] + s))
    m, x, y = _model()
    tr = ResilientTrainer(m, step_budget_ms=10.0, max_slow_steps=2,
                          faults=faults, clock=lambda: fake["t"])
    tr.step(x, y)
    tr.step(x, y)
    for _ in range(2):
        tr.step(x, y)
        assert tr.last.slow
    with pytest.raises(TrainingStalledError):
        tr.step(x, y)


def test_crash_at_step_fires_injected_kill():
    class _Die(BaseException):
        pass

    def die():
        raise _Die()

    m, x, y = _model()
    tr = ResilientTrainer(m, faults=TrainFaultPlan(CrashAtStep(at_step=2),
                                                   kill=die))
    tr.step(x, y)
    tr.step(x, y)
    with pytest.raises(_Die):
        tr.step(x, y)


def test_grad_norm_is_plausible():
    m, x, y = _model()
    tr = ResilientTrainer(m, track_grad_norm=True)
    tr.step(x, y)
    gn = tr.last.grad_norm
    g2 = 0.0
    m2, _, _ = _model()
    out = m2.forward(Tensor(data=x, device="cpu"))
    loss = autograd.softmax_cross_entropy(out, Tensor(data=y, device="cpu"))
    for _, g in autograd.backward(loss):
        g2 += float((g.data.double() ** 2).sum())
    np.testing.assert_allclose(gn, np.sqrt(g2), rtol=1e-5)
    m3, _, _ = _model()
    tr3 = ResilientTrainer(m3)
    tr3.step(x, y)
    assert tr3.last.grad_norm is None


def test_run_loop_trains_through_loader(tmp_path):
    x, y = _data(seed=0, n=64)
    m, _, _ = _model()
    dl = DataLoader(ArrayDataset(x, y), 16, seed=1)
    ck = CheckpointManager(m, str(tmp_path), async_save=False)
    tr = ResilientTrainer(m, checkpoint=ck, loader=dl, save_every=3)
    epochs_seen = []
    tr.run(dl, 2, on_epoch=lambda e, losses: epochs_seen.append(
        (e, len(losses))))
    assert tr.step_index == 8
    assert epochs_seen == [(0, 4), (1, 4)]
    assert ck.saved >= 2
    meta = ck.restore_latest()
    assert meta["step"] == 6
    assert meta["loader"] == {"epoch": 1, "pos": 2, "seed": 1}


# ---------------------------------------------------------------------------
# fault plan semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 3])
def test_random_plan_reproducible_and_equal_to_jax(seed):
    a = TrainFaultPlan.random(seed=seed, n_steps=50)
    b = TrainFaultPlan.random(seed=seed, n_steps=50)
    j = JTrainFaultPlan.random(seed=seed, n_steps=50)
    assert a.faults == b.faults and len(a.faults) == 3
    assert [(type(f).__name__, vars(f)) for f in a.faults] == \
        [(type(f).__name__, vars(f)) for f in j.faults]
    crashy = [f for f in a.faults
              if isinstance(f, (CrashAtStep, KillMidCheckpointWrite))]
    assert len(crashy) <= 1


def test_poison_preserves_type_shape_dtype_and_device():
    x = np.ones((4, 3), np.float32)
    y = np.zeros(4, np.int32)
    for make in (lambda a: a, torch.from_numpy,
                 lambda a: Tensor(data=a, device="cpu")):
        plan = TrainFaultPlan(NaNGrads(at_step=0))
        px, py = plan.poison_batch(0, (make(x), make(y)))
        assert type(px) is type(make(x))
        raw = px.data if isinstance(px, Tensor) else px
        assert tuple(raw.shape) == x.shape and np.isnan(
            np.asarray(raw.numpy() if isinstance(px, Tensor)
                       else raw)).all()
        assert str(raw.dtype).endswith("float32")
        np.testing.assert_array_equal(
            py.numpy() if isinstance(py, Tensor) else np.asarray(py), y)
        qx, _ = plan.poison_batch(0, (make(x), make(y)))   # transient
        raw = qx.data if isinstance(qx, Tensor) else qx
        assert not np.isnan(np.asarray(raw)).any()
    spiked, _ = TrainFaultPlan(SpikeGrads(0, factor=10.0)).poison_batch(
        0, (torch.ones(2), torch.zeros(2)))
    assert torch.equal(spiked, torch.full((2,), 10.0))


# ---------------------------------------------------------------------------
# telemetry integration
# ---------------------------------------------------------------------------

def test_checkpoint_telemetry(tmp_path):
    m, x, y = _model()
    tr = ttracer.install(ttracer.SpanTracer())
    try:
        ck = CheckpointManager(m, str(tmp_path), async_save=False)
        m.train_one_batch(x, y)
        ck.save(1)
        ck.restore_latest()
    finally:
        ttracer.uninstall()
    names = {e["name"] for e in tr.to_chrome()["traceEvents"]}
    assert {"checkpoint_snapshot", "checkpoint_write",
            "checkpoint_restore"} <= names
    reg = tregistry.default_registry()
    assert reg.get("train_checkpoint_saved_total").value >= 1
    assert reg.get("train_checkpoint_restore_total").value >= 1
    assert reg.get("train_checkpoint_bytes_total").value > 0
    assert reg.get("train_checkpoint_save_ms").count >= 1


def test_async_saved_counter_bumped_under_lock(tmp_path):
    m, x, y = _model()
    ck = CheckpointManager(m, str(tmp_path), keep=8, async_save=True)
    for step in range(1, 5):
        m.train_one_batch(x, y)
        ck.save(step)
        ck.wait()
    assert ck.saved == 4
    assert [e["step"] for e in ck._load_manifest()["checkpoints"]] == \
        [1, 2, 3, 4]
