"""Flash-attention forward of the port (singa_tpu_torch.ops.flash_attention,
the plain PyTorch version that CPU tensors take) against the JAX Pallas
kernel (singa_tpu.ops.pallas_kernels.flash_attention, interpret mode on
CPU, as tests/test_pallas_kernels.py runs it).  Tolerance: atol 1e-5 in
float32 — the two differ only in summation order.

Also the kernel's design, without a card: the key split's plan (which
shapes split, and that a query tile's ranges cover its swept key columns
exactly once), the plain versions of the split route's two launches
(each range's partial forward, then the combine), and the 3xTF32
arithmetic of the tensor-core tiles, emulated on the CPU
(``matmul_3xtf32``) against the single TF32 product it avoids."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops.pallas_kernels import flash_attention as jax_flash
from singa_tpu_torch.ops import flash_attention as fa_mod
from singa_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_reference)

torch.set_num_threads(1)

NEG = -1e9


def _case(name, rng):
    """(B, H, T, S, d, mask or None, causal) for each named case."""
    if name == "none_causal":
        return 1, 2, 150, 150, 16, None, True
    if name == "vec_padded_keys":
        m = np.zeros((2, 1, 1, 70), np.float32)
        m[1, 0, 0, 60:] = NEG                      # batch 1 pads 10 keys
        return 2, 2, 40, 70, 16, m, False
    if name == "dense":
        m = np.where(rng.rand(1, 1, 64, 96) < 0.3, NEG, 0.0)
        m[..., 0] = 0.0
        return 1, 2, 64, 96, 32, m.astype(np.float32), False
    if name == "fully_masked_row":
        m = np.where(rng.rand(2, 2, 24, 40) < 0.2, NEG, 0.0)
        m[1, 0, 5, :] = NEG                        # one row sees nothing
        return 2, 2, 24, 40, 16, m.astype(np.float32), False
    if name == "dense_causal_ragged":
        m = np.where(rng.rand(1, 1, 130, 260) < 0.1, NEG, 0.0)
        return 1, 1, 130, 260, 16, m.astype(np.float32), True
    if name == "fully_masked_row_long_keys":
        m = np.where(rng.rand(1, 2, 40, 200) < 0.2, NEG, 0.0)
        m[0, 1, 7, :] = NEG                        # one row sees nothing
        return 1, 2, 40, 200, 32, m.astype(np.float32), False
    raise KeyError(name)


CASES = ["none_causal", "vec_padded_keys", "dense", "fully_masked_row",
         "dense_causal_ragged", "fully_masked_row_long_keys"]
# the cases whose keys span 2+ 64-key tiles, so that the key split has
# ranges to merge
SPLIT_CASES = [c for c in CASES if c != "fully_masked_row"]


def _inputs(name):
    rng = np.random.RandomState(CASES.index(name))
    B, H, T, S, d, mask, causal = _case(name, rng)
    q = rng.randn(B, H, T, d).astype(np.float32)
    k = rng.randn(B, H, S, d).astype(np.float32)
    v = rng.randn(B, H, S, d).astype(np.float32)
    return q, k, v, mask, causal


@functools.lru_cache(maxsize=None)
def _jax_out(name):
    q, k, v, mask, causal = _inputs(name)
    return np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal))


def _operands(name):
    """The kernel operands ``(q3, k3, v3, mask3, scale, mode, causal)``."""
    q, k, v, mask, causal = _inputs(name)
    q3, k3, v3, m3, scale, mode = fa_mod._prepare(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), None)
    return q3, k3, v3, m3, scale, mode, causal


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax_kernel(name):
    q, k, v, mask, causal = _inputs(name)
    ref = _jax_out(name)
    before = fa_mod.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          None if mask is None else torch.from_numpy(mask),
                          causal=causal)
    assert fa_mod.launches == before          # CPU tensors: no kernel
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    plain = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_fully_masked_row_averages_the_swept_columns():
    """The reference's -1e9 mask is finite, so a row with every column
    masked averages V over the 128-padded key axis (zero V padding)."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 1, 3, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 1, 20, 8).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, 1, 20, 8).astype(np.float32))
    m = torch.zeros(1, 1, 3, 20)
    m[0, 0, 1] = NEG
    out = flash_attention(q, k, v, m)
    np.testing.assert_allclose(out[0, 0, 1].numpy(),
                               (v[0, 0].sum(0) / 128).numpy(), atol=1e-6)


def test_kernel_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


# ---- the key split ---------------------------------------------------------

PLAN_SHAPES = {
    # (BH, T, S, causal): the tests' cases, then the card's two shapes
    **{n: None for n in CASES},
    "training (8,12,1024,64) causal": (96, 1024, 1024, True),
    "serving q 64 against 1024 keys": (12, 64, 1024, False),
    "causal B1 H2 T1024": (2, 1024, 1024, True),
}


def _plan_shape(name):
    if PLAN_SHAPES[name] is not None:
        return PLAN_SHAPES[name]
    B, H, T, S, *_ = _case(name, np.random.RandomState(0))
    return B * H, T, S, _case(name, np.random.RandomState(0))[-1]


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
@pytest.mark.parametrize("n_sm", [132, 1 << 20])
def test_split_ranges_cover_each_tiles_sweep_exactly_once(name, n_sm):
    BH, T, S, causal = _plan_shape(name)
    plan = fa_mod._fwd_split_plan(BH, T, S, causal, n_sm)
    Sp = -(-S // 128) * 128
    for tile, ranges in enumerate(fa_mod._split_ranges(plan, T, S, causal)):
        hi = min(Sp, (tile * 64 // 128 + 1) * 128) if causal else Sp
        kend = min(S, hi)
        cols = [c for lo, up in ranges for c in range(lo, up)]
        assert cols == list(range(kend))          # in order, each once
        assert 1 <= len(ranges) <= plan.n_split
        # the combine kernel's count of a row's ranges
        assert len(ranges) == -(-(-(-kend // 64)) // plan.per)
        assert all(up - lo <= plan.per * 64 for lo, up in ranges)


def test_training_shape_does_not_split():
    assert fa_mod._fwd_split_plan(96, 1024, 1024, True) == (1, 16)


def test_serving_shape_splits_into_one_key_tile_a_range():
    """12 blocks on 132 SMs: as many ranges as key tiles (16, one 64-key
    tile each), 192 blocks."""
    assert fa_mod._fwd_split_plan(12, 64, 1024, False) == (16, 1)
    assert fa_mod._fwd_split_plan(2, 1024, 1024, True) == (8, 2)


@pytest.mark.parametrize("name", SPLIT_CASES)
@pytest.mark.parametrize("n_sm", [1 << 20, 16])
def test_combine_of_ranges_matches_unsplit_and_jax(name, n_sm):
    q3, k3, v3, m3, scale, mode, causal = _operands(name)
    BH, T = q3.shape[:2]
    S = k3.shape[1]
    plan = fa_mod._fwd_split_plan(BH, T, S, causal, n_sm)
    assert plan.n_split > 1
    parts = fa_mod.flash_attention_fwd_partial_reference(
        q3, k3, v3, m3, scale, mode, causal, plan)
    assert parts[0].shape == (plan.n_split, BH, T, q3.shape[2])
    o, lse = fa_mod.flash_attention_fwd_combine_reference(*parts, T, S,
                                                          causal, plan.per)
    ro, rlse = fa_mod.flash_attention_fwd_reference(q3, k3, v3, m3, scale,
                                                    mode, causal)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.reshape(_jax_out(name).shape).numpy(),
                               _jax_out(name), atol=1e-5, rtol=0)


def test_combine_skips_ranges_the_kernel_leaves_unwritten():
    """Causal tiles sweep fewer key tiles than the longest: their last
    ranges are empty, and the kernel does not write them; the combine
    must not read them (NaN there changes nothing)."""
    q3, k3, v3, m3, scale, mode, causal = _operands("none_causal")
    BH, T = q3.shape[:2]
    plan = fa_mod._fwd_split_plan(BH, T, k3.shape[1], causal, 1 << 20)
    o_p, m_p, l_p = fa_mod.flash_attention_fwd_partial_reference(
        q3, k3, v3, m3, scale, mode, causal, plan)
    valid = fa_mod._valid_ranges(plan.n_split, T, k3.shape[1], causal,
                                 plan.per, "cpu")
    assert not bool(valid.all())                 # some ranges are empty
    o_p = torch.where(valid[..., None], o_p, torch.nan)
    m_p = torch.where(valid, m_p, torch.nan)
    l_p = torch.where(valid, l_p, torch.nan)
    o, _ = fa_mod.flash_attention_fwd_combine_reference(
        o_p, m_p, l_p, T, k3.shape[1], causal, plan.per)
    ro, _ = fa_mod.flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode,
                                                 causal)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), atol=1e-5, rtol=0)


# ---- the precision design: 3xTF32 tensor-core products ---------------------

def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                             # TF32's 10-bit mantissa
    x = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23],
                     dtype=torch.float32)
    want = [one, one + ulp, one + ulp, -(one + ulp), one]
    np.testing.assert_array_equal(fa_mod.tf32_round(x).numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_3xtf32_forward_matches_jax_kernel(name):
    q3, k3, v3, m3, scale, mode, causal = _operands(name)
    o, _ = fa_mod.flash_attention_fwd_reference(
        q3, k3, v3, m3, scale, mode, causal, matmul=fa_mod.matmul_3xtf32)
    np.testing.assert_allclose(o.reshape(_jax_out(name).shape).numpy(),
                               _jax_out(name), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_1xtf32_forward_misses_the_float32_tolerance(name):
    """Why the kernels split each operand: one TF32 product keeps about
    three digits, and the error reaches the output."""
    q3, k3, v3, m3, scale, mode, causal = _operands(name)
    o, _ = fa_mod.flash_attention_fwd_reference(
        q3, k3, v3, m3, scale, mode, causal, matmul=fa_mod.matmul_1xtf32)
    err = float(np.abs(o.reshape(_jax_out(name).shape).numpy()
                       - _jax_out(name)).max())
    print(f"{name}: 1xTF32 forward max abs error {err:.3e} against the JAX "
          f"kernel (CPU tolerance 1e-5; the card's FLASH_TOL 1e-4)")
    assert err > 1e-5


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float16, torch.float16, torch.bfloat16),
    (torch.float64, torch.float64, torch.float64)])
def test_operands_of_mixed_or_other_dtypes_raise(dtypes):
    """The launchers take q, k and v of one dtype in float32, bfloat16 or
    float16: anything else raises TypeError naming the dtypes, on CPU
    tensors as on the card.  The entries promote mixed operands to their
    common dtype first (:func:`test_mixed_operands_run_in_their_common_
    dtype`), so there only a dtype outside the three raises."""
    q, k, v = (torch.zeros(1, 8, 16, dtype=dt) for dt in dtypes)
    plan = fa_mod._fwd_split_plan(1, 8, 8, False, n_sm=1 << 20)
    with pytest.raises(TypeError, match="one dtype"):
        fa_mod.flash_attention_fwd_partial(q, k, v, None, 0.25, "none",
                                           False, plan)
    if len(set(dtypes)) == 1:
        with pytest.raises(TypeError, match="one dtype"):
            flash_attention(q[None], k[None], v[None])


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16, torch.bfloat16)])
def test_mixed_operands_run_in_their_common_dtype(dtypes):
    """q, k and v of different dtypes: the reference's kernels upcast each
    operand to float32 as they read it and write ``o`` in q's dtype
    (pallas_kernels.py:106-145, :314), so the entries compute the call on
    the operands promoted to their common dtype, bit for bit, and return
    ``o`` in q's dtype; the gradients come back in each operand's
    dtype."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g).to(dt)
               for dt in dtypes)
    mask = torch.where(torch.rand(1, 1, 8, 8, generator=g) < 0.2, -1e9, 0.0)
    common = functools.reduce(torch.promote_types, dtypes)
    want = flash_attention(q.to(common), k.to(common), v.to(common), mask)
    got = flash_attention(q, k, v, mask)
    assert got.dtype == q.dtype
    assert torch.equal(got, want.to(q.dtype))
    assert torch.equal(fa_mod.flash_attention_reference(q, k, v, mask), got)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, mask).float().sum().backward()
    assert [t.grad.dtype for t in leaves] == list(dtypes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_combine_writes_the_requested_dtype(dtype):
    """The plain combine rounds its float32 merge once to ``out_dtype``;
    lse stays float32."""
    g = torch.Generator().manual_seed(0)
    q3, k3, v3 = (torch.randn(2, n, 16, generator=g) for n in (32, 200, 200))
    plan = fa_mod._fwd_split_plan(2, 32, 200, False, n_sm=1 << 20)
    parts = fa_mod.flash_attention_fwd_partial(q3, k3, v3, None, 0.25, "none",
                                               False, plan)
    o32, lse32 = fa_mod.flash_attention_fwd_combine(*parts, 32, 200, False,
                                                    plan.per)
    o, lse = fa_mod.flash_attention_fwd_combine(*parts, 32, 200, False,
                                                plan.per, dtype)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(o, o32.to(dtype)) and torch.equal(lse, lse32)
