"""The port's fused LSTM cell (singa_tpu_torch.ops.lstm_cell, unpacked
operands, on the CPU: the plain version forward and the reference's
recompute backward) against the JAX package's ``lstm_cell_fused`` (the
Pallas kernel in interpret mode) on the same numpy inputs packed by
``pack_lstm_weights`` into the TPU's 128-aligned gate layout, outputs
sliced back to H.

Tolerances: forward atol 1e-5 (float32, summation order only); the
gradients of xw, h, c, W_hh and b against ``jax.vjp`` at rtol 2e-4,
atol 2e-5, the tolerance of the JAX package's own fused-cell test
(tests/test_rnn.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch.ops import lstm_cell as lc

torch.set_num_threads(1)

CASES = [(B, H) for H in (5, 128, 130) for B in (3, 8, 9)]


def _inputs(B, H, seed):
    rng = np.random.RandomState(seed)
    u = 1.0 / np.sqrt(H)
    return dict(
        xw=rng.randn(B, 4 * H).astype(np.float32),
        h=rng.uniform(-1, 1, (B, H)).astype(np.float32),
        c=rng.randn(B, H).astype(np.float32),
        W_hh=rng.uniform(-u, u, (H, 4 * H)).astype(np.float32),
        b=rng.uniform(-u, u, (4 * H,)).astype(np.float32),
        wh=rng.randn(B, H).astype(np.float32),     # cotangents of h', c'
        wc=rng.randn(B, H).astype(np.float32))


def _jax_cell(xw, h, c, W_hh, b):
    """The reference kernel on unpacked operands: pack, run, slice."""
    H = h.shape[1]
    dummy_ih = jnp.zeros((1, 4 * H), jnp.float32)
    _, W_hh_p, b_p, Hp = pk.pack_lstm_weights(dummy_ih, W_hh, b, H)
    xw_p = pk._pack_gates(xw, H, Hp)
    pad = [(0, 0), (0, Hp - H)]
    ho, co = pk.lstm_cell_fused(xw_p, jnp.pad(h, pad), jnp.pad(c, pad),
                                W_hh_p, b_p)
    return ho[:, :H], co[:, :H]


@pytest.mark.parametrize("B,H", CASES)
def test_forward_and_gradients_match_jax(B, H):
    """One ``jax.vjp`` of the reference against the port's forward and
    ``torch.autograd.grad`` with the same cotangents on (h', c')."""
    d = _inputs(B, H, seed=B * 1000 + H)
    names = ("xw", "h", "c", "W_hh", "b")
    (jh, jc), vjp = jax.vjp(_jax_cell, *[jnp.asarray(d[n]) for n in names])
    jgrads = vjp((jnp.asarray(d["wh"]), jnp.asarray(d["wc"])))

    targs = [torch.from_numpy(d[n]).requires_grad_() for n in names]
    th, tc = lc.lstm_cell_fused(*targs)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               rtol=0, atol=1e-5)
    tgrads = torch.autograd.grad((th, tc), targs,
                                 (torch.from_numpy(d["wh"]),
                                  torch.from_numpy(d["wc"])))
    for n, g, jg in zip(names, tgrads, jgrads):
        assert g.shape == tuple(jg.shape), n
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-5, err_msg=n)


def test_cpu_takes_the_plain_version_without_a_launch():
    d = _inputs(3, 5, seed=1)
    args = [torch.from_numpy(d[n]) for n in ("xw", "h", "c", "W_hh", "b")]
    before = lc.launches
    h2, c2 = lc.lstm_cell_forward(*args)
    rh, rc = lc.lstm_cell_reference(*args)
    assert lc.launches == before
    torch.testing.assert_close(h2, rh, rtol=0, atol=0)
    torch.testing.assert_close(c2, rc, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shape", "device"])
def test_bad_operands_raise(bad):
    d = _inputs(2, 4, seed=2)
    args = [torch.from_numpy(d[n]) for n in ("xw", "h", "c", "W_hh", "b")]
    if bad == "shape":
        args[3] = args[3][:, :8]
        with pytest.raises(ValueError, match="W_hh"):
            lc._check_kernel_operands(*args)
    else:
        args[0] = args[0].to("meta")
        with pytest.raises(ValueError, match="different devices"):
            lc.lstm_cell_forward(*args)


def test_kernel_refuses_bfloat16():
    d = _inputs(2, 4, seed=3)
    args = [torch.from_numpy(d[n]).to(torch.bfloat16)
            for n in ("xw", "h", "c", "W_hh", "b")]
    with pytest.raises(TypeError, match="float32"):
        lc._check_kernel_operands(*args)
