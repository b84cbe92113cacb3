"""Paged decode attention of the port
(singa_tpu_torch.ops.paged_attention, the plain version CPU tensors
take) against the JAX Pallas kernel
(singa_tpu.ops.paged_attention.paged_decode_attention, interpret=True),
on the block table of tests/test_paged_serving.py (NULL and stale
entries, mid-page positions).  Tolerance: atol 1e-5 in float32.  The
int8 and bfloat16-page variants are held against the reference in
tests/test_torch_quantized_serving.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from singa_tpu_torch.ops import paged_attention as pa_mod
from singa_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)

torch.set_num_threads(1)


def _inputs(S, H, d, P, Ps, N, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, d).astype(np.float32)
    k_pages = rng.randn(N, H, P, d).astype(np.float32)
    v_pages = rng.randn(N, H, P, d).astype(np.float32)
    return rng, q, k_pages, v_pages


def _table_case():
    S, H, d, P, Ps, N = 3, 2, 16, 8, 4, 10
    _, q, kp, vp = _inputs(S, H, d, P, Ps, N)
    table = np.zeros((S, Ps), np.int32)
    table[0] = [3, 7, 1, 0]                        # NULL tail
    table[1] = [2, 0, 0, 0]
    table[2] = [9, 4, 5, 8]
    pos = np.array([17, 3, 30], np.int32)          # mid-page frontiers
    return q, kp, vp, table, pos


def _random_case():
    S, H, d, P, Ps, N = 5, 3, 32, 4, 6, 31
    rng, q, kp, vp = _inputs(S, H, d, P, Ps, N, seed=1)
    table = rng.randint(0, N, size=(S, Ps)).astype(np.int32)   # stale ids
    pos = np.array([0, 5, 23, 11, 16], np.int32)
    return q, kp, vp, table, pos


@pytest.mark.parametrize("make", [_table_case, _random_case],
                         ids=["serving_table", "random_stale_table"])
def test_plain_version_matches_jax_kernel(make):
    q, kp, vp, table, pos = make()
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(table),
                               jnp.asarray(pos), interpret=True))
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    before = pa_mod.launches
    got = paged_decode_attention(*args)
    assert pa_mod.launches == before          # CPU tensors: no kernel
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        paged_decode_attention_reference(*args).numpy(), got.numpy())


def test_columns_past_pos_carry_no_weight():
    q, kp, vp, table, pos = _table_case()
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    out = paged_decode_attention(*args)
    junk = torch.from_numpy(vp).clone()
    junk[0] = 1e6                                  # NULL page: never live
    junk[1, :, 2:] = 1e6                           # slot 0 tail past pos 17
    again = paged_decode_attention(args[0], args[1], junk, args[3], args[4])
    np.testing.assert_array_equal(again.numpy(), out.numpy())


@pytest.mark.parametrize("which", ["k_scales", "v_scales"])
def test_scales_come_in_pairs(which):
    """As in the reference: both scale pools or neither."""
    q, kp, vp, table, pos = [torch.from_numpy(a) for a in _table_case()]
    kq = kp.round().clamp(-127, 127).to(torch.int8)
    vq = vp.round().clamp(-127, 127).to(torch.int8)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        paged_decode_attention(q, kq, vq, table, pos,
                               **{which: torch.ones(10, 2, 8)})
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        jax_paged(*(jnp.asarray(t.numpy()) for t in (q, kq, vq, table, pos)),
                  interpret=True, **{which: jnp.ones((10, 2, 8))})
