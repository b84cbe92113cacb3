"""Flash-attention forward of the port (singa_tpu_torch.ops.flash_attention,
the plain PyTorch version that CPU tensors take) against the JAX Pallas
kernel (singa_tpu.ops.pallas_kernels.flash_attention, interpret mode on
CPU, as tests/test_pallas_kernels.py runs it).  Tolerance: atol 1e-5 in
float32 — the two differ only in summation order."""

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
    raise KeyError(name)


CASES = ["none_causal", "vec_padded_keys", "dense", "fully_masked_row",
         "dense_causal_ragged"]


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax_kernel(name):
    rng = np.random.RandomState(CASES.index(name))
    B, H, T, S, d, mask, causal = _case(name, rng)
    q = rng.randn(B, H, T, d).astype(np.float32)
    k = rng.randn(B, H, S, d).astype(np.float32)
    v = rng.randn(B, H, S, d).astype(np.float32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal))
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
