"""The port's elementwise catalogue (singa_tpu_torch.ops.elementwise, on
the CPU: the plain versions) against the JAX package's ``ew_unary``,
``ew_binary`` and ``clamp`` (the Pallas kernels in interpret mode), on
the inputs of the JAX package's own catalogue tests at rtol/atol 1e-6,
and on NaN, +-inf and +-0 (every pair of them for the binary ops),
compared NaN-equal.  ``copy`` to bfloat16 and float16 must round like
the reference, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch.ops import elementwise as ew

torch.set_num_threads(1)

SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5,
                    -0.5, 3.7, -2.25, 1e-3], np.float32)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_catalogue_names_match_the_reference():
    assert set(ew.EW_UNARY) == set(pk.EW_UNARY)
    assert set(ew.EW_BINARY) == set(pk.EW_BINARY)


@pytest.mark.parametrize("name", sorted(pk.EW_UNARY))
def test_ew_unary(name):
    x = np.abs(_rand((37, 5), 11)) + 0.1   # the reference test's inputs
    got = ew.ew_unary(name, _t(x))
    want = pk.ew_unary(name, jnp.asarray(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(pk.EW_BINARY))
def test_ew_binary(name):
    a = np.abs(_rand((11, 13), 12)) + 0.1
    b = np.abs(_rand((11, 13), 13)) + 0.1
    got = ew.ew_binary(name, _t(a), _t(b))
    want = pk.ew_binary(name, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(pk.EW_UNARY) + ["copy"])
def test_ew_unary_special_values(name):
    got = ew.ew_unary(name, _t(SPECIAL))
    want = np.asarray(pk.ew_unary(name, jnp.asarray(SPECIAL)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    # NaN exactly where the reference has NaN (relu, sign, ... keep it)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


@pytest.mark.parametrize("name", sorted(pk.EW_BINARY))
def test_ew_binary_special_values(name):
    a = np.repeat(SPECIAL, len(SPECIAL))
    b = np.tile(SPECIAL, len(SPECIAL))
    got = ew.ew_binary(name, _t(a), _t(b))
    want = np.asarray(pk.ew_binary(name, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_copy_converts_like_the_reference(dtype):
    x = np.concatenate([_rand((300,), 14) * 100, SPECIAL])
    got = ew.ew_unary("copy", _t(x), out_dtype=getattr(torch, dtype))
    want = pk.ew_unary("copy", jnp.asarray(x),
                       out_dtype=getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_clamp():
    x = np.concatenate([_rand((300,), 14), SPECIAL])
    got = ew.clamp(_t(x), -0.5, 0.5)
    want = np.asarray(pk.clamp(jnp.asarray(x), -0.5, 0.5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_dtype_of_a_binary_op():
    a, b = _rand((40,), 15), _rand((40,), 16)
    got = ew.ew_binary("threshold", _t(a), _t(b), out_dtype=torch.bfloat16)
    want = pk.ew_binary("threshold", jnp.asarray(a), jnp.asarray(b),
                        out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_other_dtypes_raise(dtype):
    x = torch.zeros(4, dtype=dtype)
    with pytest.raises(TypeError, match="float32, bfloat16 and float16"):
        ew.ew_unary("relu", x)
    with pytest.raises(TypeError, match="float32, bfloat16 and float16"):
        ew.ew_unary("copy", torch.zeros(4), out_dtype=dtype)


def test_cpu_launches_nothing():
    before = ew.launches
    ew.ew_unary("exp", torch.zeros(5))
    ew.ew_binary("add", torch.zeros(5), torch.ones(5))
    ew.clamp(torch.zeros(5), 0, 1)
    assert ew.launches == before
