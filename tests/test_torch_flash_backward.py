"""Flash-attention backward of the port (singa_tpu_torch.ops.flash_attention:
the autograd Function over the plain backward that CPU tensors take)
against ``jax.vjp`` of the JAX ``flash_attention`` (Pallas dq and dk/dv
kernels in interpret mode on CPU, as tests/test_pallas_kernels.py runs
them).  Tolerance: atol 1e-5 in float32 — the two differ only in
summation order.  Cases include fully masked rows, where the
reference's formula (p == 1 on every swept pair) differs from the
autodiff of the forward; the cotangent is drawn at a tenth of unit
scale so that such a row's gradient, a sum over up to 256 swept
columns, stays O(1) like the others.

The kernels compute every product on the tensor cores as 3xTF32;
``matmul_3xtf32`` emulates that on the CPU, in place of the plain
backward's matmuls, and must hold the same tolerance, where one TF32
product (``matmul_1xtf32``) does not."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops.pallas_kernels import flash_attention as jax_flash
from singa_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

NEG = -1e9


def _case(name, rng):
    """(B, H, T, S, d, mask or None, causal) for each named case."""
    if name == "causal_ragged":
        return 1, 2, 150, 150, 16, None, True
    if name == "vec_padded_keys":
        m = np.zeros((2, 1, 1, 70), np.float32)
        m[1, 0, 0, 60:] = NEG                      # batch 1 pads 10 keys
        return 2, 2, 40, 70, 16, m, False
    if name == "dense":
        m = np.where(rng.rand(1, 1, 64, 96) < 0.3, NEG, 0.0)
        m[..., 0] = 0.0
        return 1, 2, 64, 96, 32, m.astype(np.float32), False
    if name == "per_head_vec":
        m = np.where(rng.rand(2, 3, 1, 50) < 0.25, NEG, 0.0)
        m[..., 0] = 0.0
        return 2, 3, 20, 50, 16, m.astype(np.float32), False
    if name == "fully_masked_row":
        m = np.where(rng.rand(2, 2, 24, 40) < 0.2, NEG, 0.0)
        m[1, 0, 5, :] = NEG                        # one row sees nothing
        return 2, 2, 24, 40, 16, m.astype(np.float32), False
    if name == "dense_causal_ragged":
        m = np.where(rng.rand(1, 1, 130, 260) < 0.1, NEG, 0.0)
        m[0, 0, 129, :] = NEG      # fully masked, in the second 128-block
        return 1, 1, 130, 260, 16, m.astype(np.float32), True
    raise KeyError(name)


CASES = ["causal_ragged", "vec_padded_keys", "dense", "per_head_vec",
         "fully_masked_row", "dense_causal_ragged"]


def _inputs(name):
    rng = np.random.RandomState(100 + CASES.index(name))
    B, H, T, S, d, mask, causal = _case(name, rng)
    q = rng.randn(B, H, T, d).astype(np.float32)
    k = rng.randn(B, H, S, d).astype(np.float32)
    v = rng.randn(B, H, S, d).astype(np.float32)
    do = (0.1 * rng.randn(B, H, T, d)).astype(np.float32)
    return q, k, v, do, mask, causal


@functools.lru_cache(maxsize=None)
def _jax_vjp(name):
    """JAX's output and ``(dq, dk, dv)`` for case ``name``."""
    q, k, v, do, mask, causal = _inputs(name)
    jm = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jm,
                                                   causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out_j), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _plain_grads(name, matmul):
    """``(dq, dk, dv)`` of the plain forward and backward with their
    products computed by ``matmul``, as ``(B, H, T|S, d)`` arrays."""
    q, k, v, do, mask, causal = _inputs(name)
    q3, k3, v3, m3, scale, mode = fa._prepare(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), None)
    o, lse = fa.flash_attention_fwd_reference(q3, k3, v3, m3, scale, mode,
                                              causal, matmul=matmul)
    grads = fa.flash_attention_bwd_reference(
        q3, k3, v3, m3, o, lse, torch.from_numpy(do).reshape(q3.shape), scale,
        mode, causal, matmul=matmul)
    return [g.reshape(a.shape).numpy() for g, a in zip(grads, (q, k, v))]


def _port_grads(q, k, v, do, mask, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt,
                             None if mask is None else torch.from_numpy(mask),
                             causal=causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_jax_vjp(name):
    q, k, v, do, mask, causal = _inputs(name)
    out_j, want = _jax_vjp(name)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out, got = _port_grads(q, k, v, do, mask, causal)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before
    np.testing.assert_allclose(out, np.asarray(out_j), atol=1e-5, rtol=0)
    for n, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"d{n}")


def test_ordinary_rows_match_autograd_of_the_plain_forward():
    """Without a fully masked row, the kernels' formula is the gradient
    of the forward."""
    q, k, v, do, mask, causal = _inputs("dense_causal_ragged")
    mask[..., 0] = 0.0                 # every row sees its first column
    _, got = _port_grads(q, k, v, do, mask, causal)
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention_reference(qt, kt, vt,
                                       torch.from_numpy(mask).double(),
                                       causal=causal)
    out.backward(torch.from_numpy(do).double())
    for n, g, t in zip("qkv", got, (qt, kt, vt)):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{n}")


def test_fully_masked_row_carries_gradient_in_its_diagonal_block():
    """A fully masked row has lse == -1e9, so p == 1 on every swept
    column: the causal-masked columns of its diagonal 128-block get a dv
    contribution, the columns past that block none."""
    q, k, v, do, mask, causal = _inputs("dense_causal_ragged")
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    dot = torch.zeros_like(qt)
    dot[0, 0, 129] = torch.from_numpy(do[0, 0, 129])   # only that row
    fa.flash_attention(qt, kt, vt, torch.from_numpy(mask),
                       causal=True).backward(dot)
    dv = vt.grad[0, 0]
    np.testing.assert_allclose(dv[:256].numpy(),
                               np.broadcast_to(do[0, 0, 129], (256, 16)),
                               atol=1e-6)
    assert float(dv[256:].abs().max()) == 0.0


def test_no_grad_call_saves_nothing():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with torch.no_grad():
        out = fa.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    out = fa.flash_attention(q.detach(), q.detach(), q.detach())
    assert out.grad_fn is None
    out = fa.flash_attention(q, q, q)
    names = [type(f).__name__ for f, _ in out.grad_fn.next_functions]
    assert any("FlashAttentionFunction" in n for n in names), names


def test_backward_wrapper_refuses_other_devices():
    q = torch.zeros(2, 4, 16, device="meta")
    lse = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q, 0.25, "none", False)


@pytest.mark.parametrize("name", CASES)
def test_3xtf32_backward_matches_jax_vjp(name):
    _, want = _jax_vjp(name)
    for n, g, w in zip("qkv", _plain_grads(name, fa.matmul_3xtf32), want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("name", CASES)
def test_1xtf32_backward_misses_the_float32_tolerance(name):
    _, want = _jax_vjp(name)
    err = max(float(np.abs(g - w).max())
              for g, w in zip(_plain_grads(name, fa.matmul_1xtf32), want))
    print(f"{name}: 1xTF32 backward max abs error {err:.3e} against jax.vjp "
          f"(CPU tolerance 1e-5; the card's FLASH_TOL 1e-4)")
    assert err > 1e-5
