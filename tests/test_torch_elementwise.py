"""The port's elementwise catalogue (singa_tpu_torch.ops.elementwise, on
the CPU: the plain versions) against the JAX package's ``ew_unary``,
``ew_binary`` and ``clamp`` (the Pallas kernels in interpret mode), on
the inputs of the JAX package's own catalogue tests at rtol/atol 1e-6,
and on NaN, +-inf and +-0 (every pair of them for the binary ops),
compared NaN-equal.  ``copy`` to bfloat16 and float16 must round like
the reference, bit for bit.  The kernel's vector split
(``_vector_split``: head, 16-byte units, tail) is checked on its own for
view offsets 0-7, ragged lengths, mixed element sizes and operands whose
misalignments differ (element by element)."""

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


# ---- the kernel's vector split (head, 16-byte units, tail) ------------

def _check_split(n, operands, split):
    """The split's invariants: the three parts cover n; the body starts
    on every operand's 16-byte boundary; the head is the first such
    place (shorter than one unit); the tail is shorter than one unit."""
    head, units, tail = split
    W = 16 // min(e for _, e in operands)
    assert head + units * W + tail == n and min(split) >= 0
    if units:
        assert all((p + head * e) % 16 == 0 for p, e in operands)
        assert head < W and tail < W
        assert not any(all((p + h * e) % 16 == 0 for p, e in operands)
                       for h in range(head))


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [3, 37, 1003])
@pytest.mark.parametrize("sizes", [(4, 4), (4, 2), (2, 4), (2, 2),
                                   (4, 4, 4), (2, 2, 4)],
                         ids=["f32", "f32->16b", "16b->f32", "16b",
                              "f32_binary", "16b_binary->f32"])
def test_vector_split_alike_misalignment(offset, n, sizes):
    """Every operand ``offset`` elements past a 64-byte boundary (the
    same misalignment in elements where the sizes agree)."""
    operands = [(4096 * (i + 1) + offset * e, e) for i, e in enumerate(sizes)]
    split = ew._vector_split(n, operands)
    _check_split(n, operands, split)
    W = 16 // min(sizes)
    if len(set(sizes)) == 1:                # one size: a common boundary
        want_head = min((-offset) % W, n)
        assert split[0] == want_head
        assert split[1] == (n - want_head) // W


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 2), (3, 1),
                                     (1, 1, 0), (2, 2, 3), (0, 0, 1)])
@pytest.mark.parametrize("n", [5, 64, 1001])
def test_vector_split_different_misalignments_go_element_by_element(
        offsets, n):
    operands = [(4096 * (i + 1) + o * 4, 4) for i, o in enumerate(offsets)]
    assert ew._vector_split(n, operands) == (n, 0, 0)


def test_vector_split_mixed_sizes():
    # float32 in, bfloat16 out: 8 values a unit (two loads, one store)
    assert ew._vector_split(100, [(4096, 4), (8192, 2)]) == (0, 12, 4)
    # float32 16 bytes past a boundary is on one too
    assert ew._vector_split(100, [(4096 + 16, 4), (8192, 2)]) == (0, 12, 4)
    # float32 one value off, bfloat16 aligned: no common boundary
    assert ew._vector_split(100, [(4096 + 4, 4), (8192, 2)]) == (100, 0, 0)
    # float32 3 values before a boundary, bfloat16 3 values before one:
    # 3 single values, then both on a boundary
    assert ew._vector_split(100, [(4096 + 4, 4), (8192 + 10, 2)]) == \
        (3, 12, 1)


@pytest.mark.parametrize("offset", range(8))
def test_vector_split_of_host_views_and_a_fresh_output(offset):
    """What the wrapper passes for a view ``offset`` values into a
    buffer and a fresh (aligned) output: the body only when the view
    sits on a 16-byte boundary, element by element otherwise."""
    base = torch.zeros(256)
    assume = base.data_ptr() % 16 == 0
    x = base[offset:offset + 200]
    y = torch.empty(200)
    split = ew._vector_split(200, [(x.data_ptr(), 4), (y.data_ptr(), 4)])
    _check_split(200, [(x.data_ptr(), 4), (y.data_ptr(), 4)], split)
    if assume and y.data_ptr() % 16 == 0:
        assert split == ((0, 50, 0) if offset % 4 == 0 else (200, 0, 0))


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cpu_views_take_the_plain_version(offset):
    x = torch.linspace(-3, 3, 301)[offset:]
    y = torch.linspace(1, 2, 301)[offset:]
    before = ew.launches
    np.testing.assert_array_equal(ew.ew_unary("gelu", x).numpy(),
                                  ew.ew_unary_reference("gelu", x).numpy())
    np.testing.assert_array_equal(ew.ew_binary("div", x, y).numpy(),
                                  ew.ew_binary_reference("div", x, y).numpy())
    assert ew.launches == before
