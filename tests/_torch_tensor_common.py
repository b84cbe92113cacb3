"""Helpers of the port's tensor-surface tests (test_torch_tensor.py,
test_torch_tensor_methods.py): seeded data, the same values as a JAX
Tensor and a port Tensor, the comparison of a result at its dtype's
tolerance, and JAX's side of many calls under one ``jax.jit``.

Tolerances, with the reason for each:

* float32 results at atol 1e-6: the inputs are drawn where the results
  stay within |x| <= 4, so one or two units in the last place of a
  differently ordered or differently approximated float32 computation
  fit;
* bfloat16 results within two bf16 units in the last place at
  max(|x|, 2^-6): XLA and torch round 16-bit intermediates at different
  points (a weak scalar rounded to bf16 first, a sum accumulated in
  float32 then rounded);
* int32 and bool results exactly;
* the result dtype exactly, and where JAX raises, the port raises too."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import tensor as jt
from singa_tpu.device import CppCPU as JCppCPU
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as tt

JDEV = JCppCPU(seed=0)
TDEV = tdevice.create_cpu_device(seed=0)
GRID = ("float32", "bfloat16", "int32", "bool")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "int32": jnp.int32, "bool": jnp.bool_}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32, "bool": torch.bool}
F32_ATOL = 1e-6
BF16_UNITS = 2.0


@pytest.fixture
def cpu_default():
    """The CPU as the default device for the test, restored after."""
    tdevice.set_default_device(tdevice.create_cpu_device(seed=0))
    yield
    tdevice.set_default_device(None)


def _rng(*key) -> np.random.RandomState:
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _data(rng, dtype, shape=(3, 4), lo=-2.0, hi=2.0, ilo=-3, ihi=4):
    """Seeded values of ``dtype``: floats in [lo, hi), ints in
    [ilo, ihi), bools."""
    if dtype == "bool":
        return rng.rand(*shape) < 0.5
    if dtype == "int32":
        return rng.randint(ilo, ihi, shape).astype(np.int32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _pair(arr, dtype):
    """The same values as a JAX Tensor and a port Tensor of ``dtype``."""
    j = jt.Tensor(data=jnp.asarray(arr, JDT[dtype]), device=JDEV)
    t = tt.Tensor(data=torch.tensor(np.asarray(arr)).to(TDT[dtype]),
                  device=TDEV)
    return j, t


def _vals(x):
    """(dtype name, values as numpy) of a Tensor of either package."""
    if isinstance(x, tt.Tensor):
        d = x.data.detach()
        name = str(d.dtype).replace("torch.", "")
        if d.dtype in (torch.bfloat16, torch.float16):
            d = d.float()
        return name, d.numpy()
    a = np.asarray(x.data)
    name = str(a.dtype)
    return name, a.astype(np.float32) if name == "bfloat16" else a


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[fin]),
                                                  2.0 ** -6))) - 7)
        units = np.abs(got[fin] - want[fin]) / ulp
        assert units.max(initial=0) <= BF16_UNITS, units.max()
    elif dtype in ("float32", "float"):
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=F32_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _same(jr, tr, in_dtype=None):
    """The port's result against JAX's: the same kind, dtype and shape,
    values at the tolerance of the result dtype (a Python float at that
    of ``in_dtype``)."""
    if isinstance(jr, (tuple, list)):
        assert len(jr) == len(tr)
        for a, b in zip(jr, tr):
            _same(a, b, in_dtype)
        return
    if isinstance(jr, float):
        assert isinstance(tr, float), type(tr)
        _close(tr, jr, in_dtype if in_dtype == "bfloat16" else "float")
        return
    assert isinstance(tr, tt.Tensor), type(tr)
    jname, jv = _vals(jr)
    tname, tv = _vals(tr)
    assert tname == jname, (tname, jname)
    assert tr.device is TDEV or tr.device.lang == "cpp"
    _close(tv, jv, jname)


def _both(jfn, tfn):
    """Both calls; when JAX's raises, the port's must raise too and the
    pair is (None, None)."""
    try:
        jr = jfn()
    except Exception:
        with pytest.raises(Exception):
            tfn()
        return None, None
    return jr, tfn()


def _jax_run(cases: dict, arrays):
    """JAX's result of every case (a function of the list of JAX Tensors
    made from ``arrays``) under one ``jax.jit`` (one compile a test, not
    one an op): {key: Tensor}, and the keys whose call raised."""
    raised = set()

    def run(*xs):
        ts = [jt.Tensor(data=x, device=JDEV) for x in xs]
        out = {}
        for k, case in cases.items():
            try:
                out[k] = case(ts).data
            except Exception:
                raised.add(k)
        return out

    out = jax.jit(run)(*[jnp.asarray(a, JDT[d]) for a, d in arrays])
    return {k: jt.Tensor(data=v, device=JDEV) for k, v in out.items()}, \
        raised


def _hold(make_cases, arrays):
    """Every case of ``make_cases(module)`` on the Tensors of ``arrays``
    (``(numpy array, dtype name)`` pairs), the port's against JAX's;
    where JAX raised, the port must raise."""
    want, raised = _jax_run(make_cases(jt), arrays)
    ts = [_pair(a, d)[1] for a, d in arrays]
    for k, case in make_cases(tt).items():
        if k in raised:
            with pytest.raises(Exception):
                case(ts)
        else:
            _same(want[k], case(ts))
