"""The port's input pipeline (singa_tpu_torch.data) against the JAX
package's (singa_tpu.data) on the CPU, case for case with
``tests/test_data.py``: the same seed gives the same batches in the same
order in both packages, epoch after epoch, and a cursor saved by either
resumes the other's batch order exactly; worker transforms, worker
errors, BinFile-backed datasets (files either package wrote),
``to_device`` (torch tensors on the device, 64-bit types narrowed as
``jax.device_put`` narrows them) and training through the loader."""

import numpy as np
import pytest
import torch

from singa_tpu import data as jdata
from singa_tpu import snapshot as jsnap
from singa_tpu_torch.data import ArrayDataset, BinFileDataset, DataLoader

torch.set_num_threads(1)


def _xy(n=100):
    rng = np.random.RandomState(0)
    return rng.randn(n, 4).astype(np.float32), np.arange(n, dtype=np.int32)


def _labels(loader, epochs=1):
    out = []
    for _ in range(epochs):
        out.extend(yb.copy() for _, yb in loader)
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_batches_cover_dataset_exactly_once_as_jax():
    x, y = _xy(96)
    dl = DataLoader(ArrayDataset(x, y), 16, seed=1)
    seen = []
    for xb, yb in dl:
        assert xb.shape == (16, 4) and yb.shape == (16,)
        np.testing.assert_array_equal(xb, x[yb])  # rows stay paired
        seen.extend(yb.tolist())
    assert sorted(seen) == list(range(96))
    _same_batches(_labels(DataLoader(ArrayDataset(x, y), 16, seed=1), 2),
                  _labels(jdata.DataLoader(jdata.ArrayDataset(x, y), 16,
                                           seed=1), 2))


def test_epochs_reshuffle_deterministically():
    x, y = _xy(32)
    dl = DataLoader(ArrayDataset(x, y), 8, seed=3)
    first, second = _labels(dl), _labels(dl)
    assert not all(np.array_equal(a, b) for a, b in zip(first, second))
    _same_batches(first + second,
                  _labels(DataLoader(ArrayDataset(x, y), 8, seed=3), 2))
    _same_batches(first + second,
                  _labels(jdata.DataLoader(jdata.ArrayDataset(x, y), 8,
                                           seed=3), 2))


@pytest.mark.parametrize("drop_last", [False, True])
def test_drop_last_and_no_shuffle(drop_last):
    x, y = _xy(20)
    dl = DataLoader(ArrayDataset(x, y), 8, shuffle=False, drop_last=drop_last)
    sizes = [len(yb) for _, yb in dl]
    assert sizes == ([8, 8] if drop_last else [8, 8, 4])
    assert len(dl) == len(sizes)
    _same_batches(_labels(dl), _labels(jdata.DataLoader(
        jdata.ArrayDataset(x, y), 8, shuffle=False, drop_last=drop_last)))


def test_transform_runs_on_worker():
    x, y = _xy(16)

    def tf(xb, yb):
        return xb * 2.0, yb
    xb, _ = next(iter(DataLoader(ArrayDataset(x, y), 8, shuffle=False,
                                 transform=tf)))
    np.testing.assert_allclose(xb, x[:8] * 2.0)


def test_worker_errors_propagate():
    x, y = _xy(16)

    def bad(xb, yb):
        raise RuntimeError("augmentation exploded")
    with pytest.raises(RuntimeError, match="augmentation exploded"):
        list(DataLoader(ArrayDataset(x, y), 8, transform=bad))


def test_dataset_rejects_mismatched_arrays():
    with pytest.raises(ValueError, match="equal length"):
        ArrayDataset(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError, match="at least one"):
        ArrayDataset()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binfile_dataset_roundtrip(tmp_path, writer):
    from singa_tpu_torch.snapshot import Snapshot
    x, y = _xy(24)
    sn = (Snapshot if writer == "port" else jsnap.Snapshot)(
        str(tmp_path / "train"), True)
    sn.write("x", x)
    sn.write("y", y)
    sn.done()
    ds = BinFileDataset(str(tmp_path / "train"))
    assert len(ds) == 24
    xb, yb = next(iter(DataLoader(ds, 12, shuffle=False)))
    np.testing.assert_array_equal(xb, x[:12])
    np.testing.assert_array_equal(yb, y[:12])


def test_training_through_loader():
    from singa_tpu_torch import autograd, layer, opt
    from singa_tpu_torch.model import Model
    from singa_tpu_torch.tensor import Tensor

    class Net(Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(2)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    rng = np.random.RandomState(1)
    x = rng.randn(128, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    torch.manual_seed(0)
    m = Net()
    m.set_optimizer(opt.SGD(lr=0.2, momentum=0.9))
    m.compile([Tensor(data=x[:32], device="cpu")], is_train=True,
              use_graph=True)
    first = None
    for _ in range(4):
        for xb, yb in DataLoader(ArrayDataset(x, y), 32, seed=2):
            _, loss = m.train_one_batch(xb, yb)
            first = first if first is not None else loss.item()
    assert loss.item() < first * 0.5, (first, loss.item())


def test_dataloader_device_prefetch():
    """``to_device``: the worker puts each batch on the device as torch
    tensors, 64-bit host types narrowed to 32 bits (``jax.device_put``
    with x64 off), the values the host batches hold."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4)                                 # float64
    y = rng.randint(0, 3, 16).astype(np.int64)
    ds = ArrayDataset(x, y)
    host = list(DataLoader(ds, 8, seed=0))
    for (hx, hy), (xb, yb) in zip(host, DataLoader(ds, 8, seed=0,
                                                   to_device="cpu")):
        assert isinstance(xb, torch.Tensor) and xb.device.type == "cpu"
        assert xb.dtype == torch.float32 and yb.dtype == torch.int32
        np.testing.assert_array_equal(xb.numpy(), hx.astype(np.float32))
        np.testing.assert_array_equal(yb.numpy(), hy)


# ---------------------------------------------------------------------------
# resumable cursor (state_dict / load_state_dict)
# ---------------------------------------------------------------------------

def _drain(dl, n):
    """Consume n batches, return their label columns."""
    out = []
    it = iter(dl)
    for _ in range(n):
        _, yb = next(it)
        out.append(yb.copy())
    it.close()  # early exit: cursor stays mid-epoch
    return out


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_cursor_resume_replays_exact_batch_order(saver):
    """One uninterrupted loader against one interrupted after 7 batches
    whose cursor (saved by ``saver``'s loader) a fresh port loader
    resumes; the same batches as the JAX loader's uninterrupted run."""
    x, y = _xy(96)
    truth = DataLoader(ArrayDataset(x, y), 16, seed=5)
    want = _labels(truth, 2) + _drain(truth, 3)
    jtruth = jdata.DataLoader(jdata.ArrayDataset(x, y), 16, seed=5)
    _same_batches(want, _labels(jtruth, 2) + _drain(jtruth, 3))

    mod = (DataLoader, ArrayDataset) if saver == "port" else \
        (jdata.DataLoader, jdata.ArrayDataset)
    a = mod[0](mod[1](x, y), 16, seed=5)
    got = _labels(a) + _drain(a, 1)
    state = a.state_dict()
    assert state == {"epoch": 1, "pos": 1, "seed": 5}

    b = DataLoader(ArrayDataset(x, y), 16, seed=5)
    b.load_state_dict(state)
    got.extend(_labels(b))
    got.extend(_drain(b, 3))
    _same_batches(got, want)


def test_cursor_seed_mismatch_rejected():
    x, y = _xy(32)
    a = DataLoader(ArrayDataset(x, y), 8, seed=1)
    b = DataLoader(ArrayDataset(x, y), 8, seed=2)
    with pytest.raises(ValueError, match="seed"):
        b.load_state_dict(a.state_dict())


def test_cursor_epoch_advances_only_on_completion():
    x, y = _xy(32)
    dl = DataLoader(ArrayDataset(x, y), 8, seed=0)
    assert dl.epoch == 0
    _drain(dl, 2)
    assert dl.state_dict() == {"epoch": 0, "pos": 2, "seed": 0}
    for _ in dl:          # completes the epoch (resumes at pos 2)
        pass
    assert dl.state_dict() == {"epoch": 1, "pos": 0, "seed": 0}
