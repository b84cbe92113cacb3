"""The port's tensor functions (singa_tpu_torch.tensor) against the JAX
package's (singa_tpu.tensor) on the CPU, on the same seeded numpy
inputs: every name of the reference's ``__all__``, and one parametrised
test per function family (constructors, unary, binary and comparison,
``Clamp``/``Threshold``, reductions, the BLAS face, softmax and
cross-entropy, the shape family) over its names and the dtype grid
(float32, bfloat16, int32, bool), JAX's side of each test under one
``jax.jit``.  Tolerances: see ``_torch_tensor_common``."""

import numpy as np
import pytest
import torch

from _torch_tensor_common import (  # noqa: F401  (cpu_default: a fixture)
    GRID, JDEV, TDEV, TDT, _both, _data, _hold, _pair, _rng, _same,
    cpu_default, jt, tt)

torch.set_num_threads(1)


def test_every_reference_name_is_ported():
    missing = [n for n in jt.__all__ if not hasattr(tt, n)]
    assert not missing
    assert set(jt.__all__) <= set(tt.__all__)
    for n in jt.__all__:
        if n[0].isupper() or n in ("einsum", "zeros", "ones", "full",
                                   "arange", "eye"):
            assert callable(getattr(tt, n)), n


# ---------------------------------------------------------------------------
# constructors and dtype aliases
# ---------------------------------------------------------------------------

CONSTRUCTORS = {
    "zeros": lambda m, d: m.zeros((2, 3), device=d),
    "zeros_float64": lambda m, d: m.zeros((2, 3), dtype=m.float64, device=d),
    "zeros_int64": lambda m, d: m.zeros((2,), dtype=m.int64, device=d),
    "ones_int32": lambda m, d: m.ones((2, 2), dtype=m.int32, device=d),
    "ones_bool": lambda m, d: m.ones((3,), dtype=m.bool_, device=d),
    "ones_name": lambda m, d: m.ones((3,), dtype="kInt", device=d),
    "full_float64": lambda m, d: m.full((2, 2), 2.5, dtype=m.float64,
                                        device=d),
    "full_int": lambda m, d: m.full((2,), 7, dtype="int", device=d),
    "arange": lambda m, d: m.arange(5, device=d),
    "arange_step": lambda m, d: m.arange(0, 1, 0.125, device=d),
    "arange_int64": lambda m, d: m.arange(2, 9, 3, dtype=m.int64, device=d),
    "eye": lambda m, d: m.eye(3, device=d),
    "eye_uint8": lambda m, d: m.eye(2, dtype=m.uint8, device=d),
    "bf16": lambda m, d: m.zeros((2,), dtype=m.bfloat16, device=d),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_match_jax(name):
    _same(CONSTRUCTORS[name](jt, JDEV), CONSTRUCTORS[name](tt, TDEV))


@pytest.mark.parametrize("dtype", GRID)
def test_like_and_numpy_constructors_match_jax(dtype):
    j, t = _pair(_data(_rng("like", dtype), dtype), dtype)
    _same(jt.zeros_like(j), tt.zeros_like(t))
    _same(jt.ones_like(j), tt.ones_like(t))
    if dtype != "bfloat16":
        np.testing.assert_array_equal(tt.to_numpy(t), jt.to_numpy(j))
        _same(jt.from_raw_tensor(j.data, JDEV), tt.from_raw_tensor(t.data))
    assert tt.as_array(t) is t.data


def test_host_data_takes_the_32_bit_default(cpu_default):
    for arr in (np.arange(4.0), np.arange(4), [1.5, 2.5], 3):
        _same(jt.from_numpy(np.asarray(arr), JDEV), tt.from_numpy(arr))
    assert tt.as_array(np.arange(3.0)).dtype == torch.float32
    assert tt.Tensor(shape=(2,), dtype=np.float64).dtype == torch.float32


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

UNARY = ("Abs", "Exp", "Log", "Sign", "Sqrt", "Square", "ReLU", "Sigmoid",
         "Tanh", "Cos", "Sin", "Tan", "Cosh", "Sinh", "Acos", "Asin",
         "Atan", "Acosh", "Asinh", "Atanh", "Ceil", "Floor", "Round",
         "Reciprocal", "Erf", "Gelu", "SoftPlus", "SoftSign", "Neg")
# float domains keeping |result| <= 4 (F32_ATOL is two units there)
DOMAIN = {"Log": (0.1, 4.0), "Sqrt": (0.1, 4.0), "Exp": (-2.0, 1.3),
          "Acos": (-0.9, 0.9), "Asin": (-0.9, 0.9), "Atanh": (-0.9, 0.9),
          "Acosh": (1.0, 4.0), "Tan": (-1.2, 1.2), "Reciprocal": (0.5, 2.0)}


def _unary_data(name, dtype):
    rng = _rng("unary", name, dtype)
    lo, hi = DOMAIN.get(name, (-2.0, 2.0))
    arr = _data(rng, dtype, lo=lo, hi=hi)
    if name == "Reciprocal" and dtype != "bool":
        arr = arr * np.where(rng.rand(*arr.shape) < 0.5, -1, 1).astype(
            arr.dtype)
    if name == "Round" and dtype in ("float32", "bfloat16"):
        arr[0, :3] = [0.5, 1.5, -2.5]              # halves go to even
    return arr, dtype


@pytest.mark.parametrize("name", UNARY)
def test_unary_family_matches_jax(name):
    _hold(lambda m: {d: lambda ts, i=i: getattr(m, name)(ts[i])
                     for i, d in enumerate(GRID)},
          [_unary_data(name, d) for d in GRID])


def test_gelu_is_the_tanh_form_and_autograd_gelu_the_erf_form():
    from singa_tpu_torch import autograd as tautograd
    x = tt.Tensor(data=np.linspace(-3, 3, 13, dtype=np.float32),
                  device=TDEV)
    tanh_form = torch.nn.functional.gelu(x.data, approximate="tanh")
    erf_form = torch.nn.functional.gelu(x.data)
    assert torch.equal(tt.Gelu(x).data, tanh_form)
    prev, tautograd.training = tautograd.training, False
    try:
        assert torch.equal(tautograd.gelu(x).data, erf_form)
    finally:
        tautograd.training = prev
    assert not torch.equal(tanh_form, erf_form)


# ---------------------------------------------------------------------------
# elementwise binary, scalar and comparison
# ---------------------------------------------------------------------------

BINARY = ("Add", "Sub", "EltwiseMult", "Div", "Pow", "Mod", "Atan2",
          "Maximum", "Minimum", "LT", "LE", "GT", "GE", "EQ", "NE")
SCALARS = (2, 0.5, True, -3)


def _binary_data(name, dtype, rng, operand):
    if name == "Pow" and dtype in ("float32", "bfloat16"):
        lo, hi = (0.5, 2.0) if operand == "a" else (-1.5, 1.5)
        return _data(rng, dtype, lo=lo, hi=hi)
    if name == "Pow" and dtype == "int32" and operand == "b":
        # XLA's integer power of 0 to a negative exponent is undefined
        return _data(rng, dtype, ilo=0, ihi=3)
    if name in ("Div", "Mod") and operand == "b" and \
            dtype in ("float32", "bfloat16"):
        mag = rng.uniform(0.5, 2.0, (3, 4))
        return (mag * np.where(rng.rand(3, 4) < 0.5, -1, 1)).astype(
            np.float32)
    return _data(rng, dtype)


@pytest.mark.parametrize("name", BINARY)
def test_binary_family_matches_jax(name):
    """``name(a, b)`` for ``a`` of every dtype of the grid against every
    weakly typed scalar and a tensor of every dtype of the grid: the
    result dtype (jnp's promotion) and the values."""
    rng = _rng("binary", name)
    arrays = [(_binary_data(name, d, rng, "a"), d) for d in GRID] + \
        [(_binary_data(name, d, rng, "b"), d) for d in GRID]

    def cases(m):
        f, n = getattr(m, name), len(GRID)
        out = {}
        for i, a in enumerate(GRID):
            for s in SCALARS:
                out[a, repr(s)] = lambda ts, i=i, s=s: f(ts[i], s)
            for k, b in enumerate(GRID):
                out[a, b] = lambda ts, i=i, k=k: f(ts[i], ts[n + k])
        return out
    _hold(cases, arrays)


def test_integer_modulo_and_division_by_zero_match_jax():
    a = np.array([5, -5, 0, 7, -7], np.int32)
    b = np.array([0, 0, 0, -2, 2], np.int32)
    ja, ta = _pair(a, "int32")
    jb, tb = _pair(b, "int32")
    _same(jt.Mod(ja, jb), tt.Mod(ta, tb))
    _same(jt.Div(ja, jb), tt.Div(ta, tb))


@pytest.mark.parametrize("name", ("Clamp", "Threshold"))
def test_clamp_and_threshold_match_jax(name):
    args = ((-0.5, 0.5), (0.5, 2.5), (0, 1), (None, 1), (-1, None)) \
        if name == "Clamp" else ((0.1,), (1,), (True,))
    _hold(lambda m: {(d, repr(a)): lambda ts, i=i, a=a: getattr(m, name)(
        ts[i], *a)
                     for i, d in enumerate(GRID) for a in args},
          [(_data(_rng(name, d), d), d) for d in GRID])


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

REDUCTIONS = {
    "Sum": ({}, {"axis": 1}, {"axis": 0, "keepdims": True},
            {"axis": (0, 1)}, {"axis": ()}),
    "Average": ({}, {"axis": 1}, {"axis": -1, "keepdims": True},
                {"axis": (1, 0)}),
    "Max": ({}, {"axis": 0}, {"axis": 1, "keepdims": True}),
    "Min": ({}, {"axis": 0}, {"axis": (0, 1), "keepdims": True}),
    "Prod": ({}, {"axis": 1}, {"axis": (0, 1)}, {"axis": 0,
                                                  "keepdims": True}),
    "ArgMax": ({}, {"axis": 0}, {"axis": None}),
    "ArgMin": ({}, {"axis": 0}, {"axis": None}),
    "SumAll": ({},), "MaxAll": ({},), "MinAll": ({},), "Norm": ({},),
    "SumRows": ({},), "SumColumns": ({},), "AverageRows": ({},),
    "AverageColumns": ({},), "L2Norm": ({},), "L1Norm": ({},),
}


FLOAT_RESULTS = ("SumAll", "MaxAll", "MinAll", "Norm")


@pytest.mark.parametrize("name", list(REDUCTIONS))
def test_reduction_family_matches_jax(name):
    """Every call of ``name`` on every dtype of the grid; the four that
    return a Python float run eagerly (a float cannot leave a jit)."""
    lo, hi = (0.8, 1.2) if name == "Prod" else (-0.25, 0.25)
    arrays = [(_data(_rng("reduce", name, d), d, lo=lo, hi=hi, ilo=-2,
                     ihi=3), d) for d in GRID]
    if name in FLOAT_RESULTS:
        for arr, d in arrays:
            j, t = _pair(arr, d)
            jr, tr = _both(lambda: getattr(jt, name)(j),
                           lambda: getattr(tt, name)(t))
            if jr is not None:
                _same(jr, tr, d)
        return
    _hold(lambda m: {(d, k): lambda ts, i=i, kw=kw: getattr(m, name)(ts[i],
                                                                     **kw)
                     for i, d in enumerate(GRID)
                     for k, kw in enumerate(REDUCTIONS[name])}, arrays)


# ---------------------------------------------------------------------------
# the BLAS face
# ---------------------------------------------------------------------------

def _blas_cases(m, mk):
    a, b, c = mk("a", (3, 4)), mk("b", (4, 5)), mk("c", (3, 5))
    v, w = mk("v", (4,)), mk("w", (3,))
    at, bt = mk("at", (4, 3)), mk("bt", (5, 4))
    batch = mk("batch", (2, 3, 4))
    sq = mk("sq", (3, 3))
    return {
        "Mult": lambda: m.Mult(a, b),
        "Mult_vector": lambda: m.Mult(a, v),
        "Mult_batched": lambda: m.Mult(batch, b),
        "matmul_operator": lambda: a @ b,
        "GEMM": lambda: m.GEMM(a, b),
        "GEMM_c": lambda: m.GEMM(a, b, c, alpha=0.5, beta=2.0),
        "GEMM_int_scalars": lambda: m.GEMM(a, b, c, alpha=2, beta=3),
        "GEMM_trans": lambda: m.GEMM(at, bt, transA=True, transB=True),
        "GEMV": lambda: m.GEMV(a, v),
        "GEMV_y": lambda: m.GEMV(a, v, w, alpha=2.0, beta=0.5),
        "Dot": lambda: m.Dot(a, mk("a2", (3, 4))),
        "Einsum": lambda: m.Einsum("ij,jk->ik", a, b),
        "einsum_batched": lambda: m.einsum("bij,jk->bik", batch, b),
        "Einsum_ellipsis": lambda: m.Einsum("...ij,jk", batch, b),
        "Einsum_implicit": lambda: m.Einsum("ij,jk", a, b),
        "Einsum_trace": lambda: m.Einsum("ii->i", sq),
        "Einsum_all": lambda: m.Einsum("ij->", a),
        "Einsum_outer": lambda: m.Einsum("i,j->ij", v, w),
    }


BLAS_SHAPES = {"a": (3, 4), "b": (4, 5), "c": (3, 5), "v": (4,),
               "w": (3,), "at": (4, 3), "bt": (5, 4), "batch": (2, 3, 4),
               "sq": (3, 3), "a2": (3, 4)}


@pytest.mark.parametrize("case", list(_blas_cases(tt, lambda *a: None)))
def test_blas_family_matches_jax(case):
    """Each call on float32, int32 and bool operands (integer products
    exact)."""
    dtypes = ("float32", "int32", "bool")
    keys = list(BLAS_SHAPES)
    arrays = [(_data(_rng("blas", case, d, k), d, BLAS_SHAPES[k], -0.5,
                     0.5), d) for d in dtypes for k in keys]

    def cases(m):
        return {d: lambda ts, i=i: _blas_cases(
            m, lambda k, s: ts[i * len(keys) + keys.index(k)])[case]()
            for i, d in enumerate(dtypes)}
    _hold(cases, arrays)


@pytest.mark.parametrize("dtype", ("float32", "int32"))
@pytest.mark.parametrize("alpha", (0.5, 2))
def test_axpy_and_scale_match_jax_in_place_where_the_dtype_stays(dtype,
                                                                  alpha):
    rng = _rng("axpy", dtype, alpha)
    jx, tx = _pair(_data(rng, dtype), dtype)
    jy, ty = _pair(_data(rng, dtype), dtype)
    ptr = ty.data.data_ptr()
    jt.Axpy(alpha, jx, jy)
    assert tt.Axpy(alpha, tx, ty) is ty
    _same(jy, ty)
    assert (ty.data.data_ptr() == ptr) == (ty.dtype == TDT[dtype])
    ptr = tx.data.data_ptr()
    jt.Scale(alpha, jx)
    assert tt.Scale(alpha, tx) is tx
    _same(jx, tx)
    assert (tx.data.data_ptr() == ptr) == (tx.dtype == TDT[dtype])


# ---------------------------------------------------------------------------
# softmax and cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("SoftMax", "LogSoftMax"))
def test_softmax_family_matches_jax(name):
    _hold(lambda m: {(d, ax): lambda ts, i=i, ax=ax: getattr(m, name)(
        ts[i], axis=ax) for i, d in enumerate(GRID) for ax in (-1, 0)},
        [(_data(_rng("softmax", d), d), d) for d in GRID])


@pytest.mark.parametrize("onehot", (False, True), ids=("ids", "onehot"))
def test_cross_entropy_fwd_and_bwd_match_jax(onehot):
    rng = _rng("xent", onehot)
    p = np.exp(rng.randn(6, 5)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[0, 2] = 0.0                                  # the 1e-10 clip
    ids = rng.randint(0, 5, 6).astype(np.int32)
    ids[0] = 2
    target = np.eye(5, dtype=np.float32)[ids] if onehot else ids
    jp, tp = _pair(p, "float32")
    jtg = jt.Tensor(data=target, device=JDEV)
    ttg = tt.Tensor(data=target, device=TDEV)
    fwd = tt.CrossEntropyFwd(tp, ttg)
    _same(jt.CrossEntropyFwd(jp, jtg), fwd)
    assert abs(float(fwd.data[0]) + np.log(1e-10)) < 1e-4
    _same(jt.SoftmaxCrossEntropyBwd(jp, jtg), tt.SoftmaxCrossEntropyBwd(tp, ttg))
    if not onehot:              # numpy targets and an id out of range
        _same(jt.CrossEntropyFwd(jp, ids), tt.CrossEntropyFwd(tp, ids))
        bad = ids.copy()
        bad[1] = 7
        _same(jt.SoftmaxCrossEntropyBwd(jp, bad),
              tt.SoftmaxCrossEntropyBwd(tp, bad))


# ---------------------------------------------------------------------------
# shape family
# ---------------------------------------------------------------------------

def _shape_cases(m, a, b, c3, col):
    return {
        "Reshape": lambda: m.Reshape(a, (4, 3)),
        "Reshape_infer": lambda: m.Reshape(a, (-1,)),
        "Transpose": lambda: m.Transpose(a),
        "Transpose_3d": lambda: m.Transpose(c3),
        "Transpose_axes": lambda: m.Transpose(c3, (1, 0, 2)),
        "Broadcast": lambda: m.Broadcast(col, (3, 4)),
        "ConcatOn": lambda: m.ConcatOn([a, b], 1),
        "ConcatOn_rows": lambda: m.ConcatOn([a, b, a], 0),
        "SliceOn": lambda: m.SliceOn(a, 1, 3, 1),
        "SliceOn_rows": lambda: m.SliceOn(a, 0, 2, 0),
        "ConcatenateRows": lambda: m.ConcatenateRows([a, b]),
        "ConcatenateColumns": lambda: m.ConcatenateColumns([a, b]),
        "CopyRows": lambda: m.CopyRows(a, 1, 3),
        "CopyColumns": lambda: m.CopyColumns(a, 0, 2),
        "Stack": lambda: m.Stack([a, b]),
        "Stack_axis": lambda: m.Stack([a, b], 2),
        "Repeat": lambda: m.Repeat(a, 2),
        "Repeat_axis": lambda: m.Repeat(a, 2, 1),
        "Repeat_counts": lambda: m.Repeat(a, np.array([1, 0, 2]), 0),
        "Tile": lambda: m.Tile(a, 2),
        "Tile_2d": lambda: m.Tile(a, (2, 1)),
        "Tile_3d": lambda: m.Tile(a, (2, 1, 1)),
        "Squeeze": lambda: m.Squeeze(col),
        "Squeeze_axis": lambda: m.Squeeze(col, 0),
        "Squeeze_wrong_axis": lambda: m.Squeeze(col, 1),
        "Unsqueeze": lambda: m.Unsqueeze(a, 0),
        "Unsqueeze_last": lambda: m.Unsqueeze(a, -1),
        "Unsqueeze_two": lambda: m.Unsqueeze(a, (0, 3)),
        "Flatten": lambda: m.Flatten(c3),
        "Flatten_from_2": lambda: m.Flatten(c3, 2),
        "Gather": lambda: m.Gather(a, [0, -1, 5, -4]),
        "Gather_axis": lambda: m.Gather(a, [[1, -4], [4, 3]], 1),
        "Gather_axis_too_large": lambda: m.Gather(a, [0, 1], 2),
        "Gather_axis_too_small": lambda: m.Gather(a, [0, 1], -3),
    }


@pytest.mark.parametrize("case", list(_shape_cases(tt, *([None] * 4))))
def test_shape_family_matches_jax(case):
    dtypes = ("float32", "int32", "bool")
    shapes = ((3, 4), (3, 4), (2, 3, 4), (1, 4))
    arrays = [(_data(_rng("shape", case, d), d, s), d) for d in dtypes
              for s in shapes]
    _hold(lambda m: {d: lambda ts, i=i: _shape_cases(
        m, *ts[4 * i:4 * i + 4])[case]() for i, d in enumerate(dtypes)},
        arrays)


def test_concat_and_stack_promote_mixed_dtypes_as_jax():
    a = _pair(np.arange(6, dtype=np.int32).reshape(2, 3), "int32")
    b = _pair(np.ones((2, 3), np.float32) * 0.5, "float32")
    c = _pair(np.ones((2, 3), bool), "bool")
    _same(jt.ConcatOn([a[0], b[0]], 0), tt.ConcatOn([a[1], b[1]], 0))
    _same(jt.Stack([c[0], a[0]]), tt.Stack([c[1], a[1]]))


# the functions that torch would give as views of their input
