"""The port's device surface (singa_tpu_torch.device) against the JAX
package's (singa_tpu.device) on the CPU: every name of the reference's
``__all__`` and every method of its ``Device`` (``CudaGPU``,
``create_cuda_gpu_on``, ``create_cuda_gpus`` and
``Platform.CreateCudaGPUs`` standing for ``TpuDevice``,
``create_tpu_device``, ``create_tpu_devices`` and ``CreateTpuDevices``),
the default-device rule and its deliberate divergences (the card, not
the CPU; no fallback to the CPU), ``DeviceMemPool`` and ``Platform`` on
the CPU reporting what the JAX package's CPU client reports, the RNG
state round trip, the graph flags, ``Sync``/``Reset``, and the profiling
knob (``SetVerbosity``, its ``torch.profiler`` trace,
``PrintTimeProfiling``'s table).  CUDA is made absent with a monkeypatch,
so the raising tests hold on any machine."""

import json
import os

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import logging as jlogging
from singa_tpu import tensor as jt
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import logging as tlogging
from singa_tpu_torch import tensor as tt

torch.set_num_threads(1)

# the port's names for the reference's TPU ones
RENAMED = {"TpuDevice": "CudaGPU", "create_tpu_device": "create_cuda_gpu_on",
           "create_tpu_devices": "create_cuda_gpus"}


@pytest.fixture(autouse=True)
def _default_restored():
    """Every test leaves both packages' default devices as it found
    them."""
    jprev = jdevice.get_default_device()
    yield
    tdevice.set_default_device(None)
    jdevice.set_default_device(jprev)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_every_reference_name_and_method_is_ported():
    for name in jdevice.__all__:
        assert hasattr(tdevice, RENAMED.get(name, name)), name
        assert RENAMED.get(name, name) in tdevice.__all__, name
    assert tdevice.CnMemPool is tdevice.DeviceMemPool
    for name in ("accelerator_devices", "GetNumGPUs", "GetGPUMemSize",
                 "CreateCudaGPUs"):
        assert callable(getattr(tdevice.Platform, name)), name
    # every public method of the reference's Device, but the JAX key
    # threading (rand_key) and its Sync bookkeeping (record_out)
    methods = {n for n in vars(jdevice.Device) if not n.startswith("_")}
    methods -= {"rand_key", "record_out"}
    missing = [n for n in methods if not callable(getattr(tdevice.Device, n,
                                                          None))]
    assert not missing
    dev = tdevice.create_cpu_device(seed=0)
    jdev = jdevice.create_cpu_device(seed=0)
    for attr in ("lang", "id", "graph_enabled", "verbosity"):
        assert getattr(dev, attr) == getattr(jdev, attr), attr


def test_get_default_device_is_the_card_and_raises_without_cuda(no_cuda):
    """The deliberate divergence: the reference's default is the host
    CPU; the port's is the card, so without CUDA every implicit
    placement raises."""
    assert jdevice.get_default_device().lang == "cpp"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.get_default_device()
    for make in (lambda: tdevice.get_device(None),
                 lambda: tt.Tensor(shape=(2,)), lambda: tt.zeros((2,)),
                 lambda: tt.from_numpy(np.ones(2)),
                 lambda: tt.as_array([1.0]),
                 lambda: tdevice.DeviceMemPool().stats()):
        with pytest.raises(RuntimeError):
            make()


def test_set_default_device_names_the_cpu(no_cuda):
    cpu = tdevice.create_cpu_device(seed=0)
    jcpu = jdevice.create_cpu_device(seed=0)
    tdevice.set_default_device(cpu)
    jdevice.set_default_device(jcpu)
    assert tdevice.get_default_device() is cpu
    assert tdevice.get_device(None) is cpu
    made = (tt.Tensor(shape=(2,)), tt.zeros((2,)), tt.ones((2,)),
            tt.full((2,), 3.0), tt.arange(3), tt.eye(2),
            tt.from_numpy(np.ones(2)), tt.from_raw_tensor([1, 2]))
    jmade = (jt.Tensor(shape=(2,)), jt.zeros((2,)), jt.ones((2,)),
             jt.full((2,), 3.0), jt.arange(3), jt.eye(2),
             jt.from_numpy(np.ones(2)), jt.from_raw_tensor(np.array([1, 2])))
    for t, j in zip(made, jmade):
        assert t.device is cpu and j.device is jcpu
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    assert tt.as_array([1.0, 2.0]).device.type == "cpu"
    assert tdevice.DeviceMemPool().stats() == {}
    # the engines' rule does not follow the default device
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    tdevice.set_default_device(None)
    with pytest.raises(RuntimeError):
        tdevice.get_default_device()


def test_no_fallback_to_the_cpu(no_cuda):
    """The reference's Platform falls back to the CPU without a TPU; the
    port raises wherever a card is asked for."""
    assert tdevice.Platform.GetNumGPUs() == 0 == jdevice.Platform.GetNumGPUs()
    assert tdevice.Platform.accelerator_devices() == []
    for make in (lambda: tdevice.Platform.CreateCudaGPUs(1),
                 lambda: tdevice.create_cuda_gpus(1),
                 lambda: tdevice.create_cuda_gpu_on(0),
                 lambda: tdevice.create_cuda_gpu(seed=0),
                 lambda: tdevice.CudaGPU(0),
                 lambda: tdevice.Platform.GetGPUMemSize(0)):
        with pytest.raises(RuntimeError):
            make()
    assert tdevice.Platform.CreateCudaGPUs(0) == []


def test_mem_pool_on_the_cpu_reports_what_jax_does():
    """The JAX CPU client's ``memory_stats()`` is None, so its pool
    reports nothing; the port's CPU pool the same."""
    jpool = jdevice.DeviceMemPool(jdevice.create_cpu_device(), 128, 1)
    tpool = tdevice.CnMemPool(tdevice.create_cpu_device(), 128, 1)
    assert tpool.stats() == jpool.stats() == {}
    assert tpool.GetMemUsage() == tuple(jpool.GetMemUsage()) == (0, 0)
    assert tpool.used_bytes() == jpool.used_bytes() == 0
    assert tpool.peak_bytes() == jpool.peak_bytes() == 0
    assert (tpool.init_size_mb, tpool.flags) == (jpool.init_size_mb,
                                                 jpool.flags)
    assert tdevice.DeviceMemPool("cpu").GetMemUsage() == (0, 0)


def test_rng_state_round_trip_and_reseeding_match_jax():
    """The same protocol in both: a state taken, draws, the state put
    back, the same draws again; a reseed restarts the sequence."""
    for mod, dev in ((tt, tdevice.create_cpu_device(seed=7)),
                     (jt, jdevice.create_cpu_device(seed=7))):
        t = mod.Tensor(shape=(32,), device=dev)
        state = dev.get_rng_state()
        a = t.uniform().numpy().copy()
        b = t.gaussian().numpy().copy()
        assert not np.array_equal(a, t.uniform().numpy())
        dev.set_rng_state(state)
        np.testing.assert_array_equal(t.uniform().numpy(), a)
        np.testing.assert_array_equal(t.gaussian().numpy(), b)
        dev.set_rand_seed(7)
        np.testing.assert_array_equal(t.uniform().numpy(), a)


def test_put_takes_host_data_with_the_32_bit_default():
    dev, jdev = tdevice.create_cpu_device(), jdevice.create_cpu_device()
    for arr in (np.arange(3.0), np.arange(3), 2.5, [True, False]):
        got, want = dev.put(arr), np.asarray(jdev.put(arr))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    x = torch.ones(2)
    assert dev.put(x) is x


def test_graph_flags_sync_and_reset_match_jax():
    for dev in (tdevice.create_cpu_device(), jdevice.create_cpu_device()):
        assert dev.graph_enabled is False
        dev.EnableGraph(True)
        assert dev.graph_enabled is True
        dev.EnableGraph(False)
        assert dev.graph_enabled is False
        assert dev.RunGraph(sequential=True) is None
        assert dev.Sync() is None
        dev.record_step_time(2.0)
        dev.Reset()
        assert dev._step_times_ms == []
    # the port's Reset also forgets the banked flop tables
    dev = tdevice.create_cpu_device()
    dev.record_cost_analysis("step", {"flops": 1})
    dev.Reset()
    assert dev._cost_tables == {}


def _table_body(table):
    """The table's lines after the first (which names the device)."""
    return table.splitlines()[1:]


def test_print_time_profiling_prints_the_reference_table(capsys):
    dev, jdev = tdevice.create_cpu_device(), jdevice.create_cpu_device()
    empty = dev.PrintTimeProfiling()
    assert _table_body(empty) == _table_body(jdev.PrintTimeProfiling())
    for d in (dev, jdev):
        for ms in (3.0, 1.0, 2.0, 4.5):
            d.record_step_time(ms)
        d.record_cost_analysis("Net.train_one_batch", {"flops": 1234.0,
                                                       "zero": 0.0})
    table = dev.PrintTimeProfiling()
    jtable = jdev.PrintTimeProfiling()
    assert capsys.readouterr().out.count("Time Profiling") == 4
    body, jbody = _table_body(table), _table_body(jtable)
    assert body[0] == jbody[0] == ("  compiled steps timed: 4  mean 2.625 ms"
                                   "  p50 3.000 ms  max 4.500 ms")
    # the cost line: the reference's XLA cost analysis, the port's flops
    assert "flop count" in body[1] and "XLA cost analysis" in jbody[1]
    assert body[2:] == jbody[2:] == ["    flops                        1234"]


def test_set_verbosity_sets_logging_and_traces_at_2(tmp_path):
    dev = tdevice.create_cpu_device()
    jdev = jdevice.create_cpu_device()
    try:
        dev.SetVerbosity(1)
        jdev.SetVerbosity(1)
        assert dev.verbosity == jdev.verbosity == 1
        assert tlogging._verbosity == jlogging._verbosity == 1
        assert dev._profiler is None and dev.trace_files == []
        trace_dir = str(tmp_path / "traces")
        dev.SetVerbosity(2, trace_dir=trace_dir)
        assert dev._profiler is not None and tlogging._verbosity == 2
        x = torch.ones(64, 64)
        (x @ x).sum()
        assert f"torch.profiler trace capturing -> {trace_dir}" in \
            dev.PrintTimeProfiling()
        dev.SetVerbosity(2)                         # one trace, still on
        assert len(dev.trace_files) == 0
        dev.SetVerbosity(0)
        assert dev._profiler is None and tlogging._verbosity == 0
        assert len(dev.trace_files) == 1
        path = dev.trace_files[0]
        assert os.path.dirname(path) == trace_dir
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::mm" in str(e.get("name")) for e in events)
        dev.SetVerbosity(0)                         # nothing to stop
        assert len(dev.trace_files) == 1
    finally:
        dev.SetVerbosity(0)
        jdev.SetVerbosity(0)
