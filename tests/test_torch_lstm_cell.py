"""The port's fused LSTM cell (singa_tpu_torch.ops.lstm_cell, unpacked
operands, on the CPU: the plain versions of the forward and backward
kernels) against the JAX package's ``lstm_cell_fused`` (the Pallas
kernel in interpret mode) on the same numpy inputs packed by
``pack_lstm_weights`` into the TPU's 128-aligned gate layout, outputs
sliced back to H.

Tolerances: float32 forward atol 1e-5 (summation order only); the
gradients of xw, h, c, W_hh and b, and the backward's plain version,
against ``jax.vjp`` at rtol 2e-4, atol 2e-5, the tolerance of the JAX
package's own fused-cell test (tests/test_rnn.py); bfloat16 and float16
outputs and gradients within one ulp of their type (see ``ULP``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch.ops import lstm_cell as lc

torch.set_num_threads(1)

CASES = [(B, H) for H in (5, 128, 130) for B in (3, 8, 9)]
NAMES = ("xw", "h", "c", "W_hh", "b")


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


@pytest.mark.parametrize("dtypes", [
    ("float32",) * 5, ("bfloat16",) * 5, ("float16",) * 5,
    ("float64",) * 5, ("int32",) * 5,
    ("bfloat16", "bfloat16", "bfloat16", "float32", "bfloat16")])
def test_kernel_operand_dtypes(dtypes):
    """The kernel takes float32, bfloat16 and float16 operands when all
    five share one dtype; any other dtype, or a mix, raises."""
    d = _inputs(2, 4, seed=3)
    args = [torch.from_numpy(d[n]).to(getattr(torch, dt))
            for n, dt in zip(NAMES, dtypes)]
    if len(set(dtypes)) == 1 and dtypes[0] in ("float32", "bfloat16",
                                               "float16"):
        lc._check_kernel_operands(*args)
    else:
        with pytest.raises(TypeError, match="lstm_cell"):
            lc._check_kernel_operands(*args)


# one unit in the last place of the output type at 1.0: both sides
# compute in float32 from the same operands and round once, so a value
# near a rounding tie may land on either side of it
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float16": (torch.float16, jnp.float16)}


def _low_inputs(B, H, seed, tdt):
    """``_inputs`` rounded to ``tdt``, as float32 numpy (exact), so both
    frameworks cast the same values."""
    return {k: torch.from_numpy(v).to(tdt).float().numpy()
            for k, v in _inputs(B, H, seed).items()}


def _ulp_check(got, ref, ulp, what):
    """``got`` (torch) against ``ref`` (jax): every value within one ulp
    of the output type relative to max(1, |ref|); returns the share of
    values that differ at all."""
    g = got.detach().float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    assert g.shape == r.shape, what
    err = np.abs(g - r) / np.maximum(1.0, np.abs(r))
    assert err.max() <= ulp, (what, err.max())
    return float((g != r).mean())


@pytest.mark.parametrize("dt", list(LOW))
def test_plain_cell_rounds_once_like_jax(dt):
    """The plain cell (the CPU path and the card's oracle) upcasts its
    five operands to float32 and rounds h' and c' once, as the
    reference's ``_lstm_kernel`` does: at most 1 % of values may differ
    from the JAX cell's, each by at most one ulp.  (Computing in the
    operands' dtype leaves c' one ulp off on most values, which the ulp
    bound alone would not catch.)"""
    tdt, jdt = LOW[dt]
    d = _low_inputs(8, 128, 21, tdt)
    jh, jc = _jax_cell(*[jnp.asarray(d[n]).astype(jdt) for n in NAMES])
    th, tc = lc.lstm_cell_fused(*[torch.from_numpy(d[n]).to(tdt)
                                  for n in NAMES])
    assert th.dtype == tc.dtype == tdt
    for what, got, ref in (("h'", th, jh), ("c'", tc, jc)):
        share = _ulp_check(got, ref, ULP[tdt], what)
        assert share <= 0.01, (what, share)


@pytest.mark.parametrize("dt", list(LOW))
def test_low_precision_gradients_match_jax(dt):
    """Gradients of all five operands at bf16 / fp16 against ``jax.vjp``
    of the reference: both recompute the gates in float32 from the saved
    operands, keep the cotangents in float32 and round each gradient
    once to its operand's dtype, so each value is within one ulp of the
    output type (relative to max(1, |ref|))."""
    tdt, jdt = LOW[dt]
    d = _low_inputs(8, 16, 22, tdt)
    (jh, jc), vjp = jax.vjp(_jax_cell, *[jnp.asarray(d[n]).astype(jdt)
                                         for n in NAMES])
    jgrads = vjp((jnp.asarray(d["wh"]).astype(jdt),
                  jnp.asarray(d["wc"]).astype(jdt)))
    targs = [torch.from_numpy(d[n]).to(tdt).requires_grad_() for n in NAMES]
    th, tc = lc.lstm_cell_fused(*targs)
    tgrads = torch.autograd.grad(
        (th, tc), targs, (torch.from_numpy(d["wh"]).to(tdt),
                          torch.from_numpy(d["wc"]).to(tdt)))
    for n, g, jg in zip(NAMES, tgrads, jgrads):
        assert g.dtype == tdt, n
        _ulp_check(g, jg, ULP[tdt], n)


@pytest.mark.parametrize("B,H", [(3, 5), (8, 128), (9, 130)])
def test_backward_reference_matches_jax(B, H):
    """``lstm_cell_backward_reference`` (what the backward kernel
    writes: dgates, which is dxw, dc_prev, and h with a column of ones)
    against ``jax.vjp`` of the reference cell, at the tolerance of the
    gradient test above; ``h1^T @ dgates`` stacks dW_hh and db."""
    d = _inputs(B, H, seed=B * 100 + H)
    _, vjp = jax.vjp(_jax_cell, *[jnp.asarray(d[n]) for n in NAMES])
    jdxw, _, jdc, jdW, jdb = vjp((jnp.asarray(d["wh"]),
                                   jnp.asarray(d["wc"])))
    dgates, dc_prev, h1 = lc.lstm_cell_backward_reference(
        *[torch.from_numpy(d[n]) for n in NAMES + ("wh", "wc")])
    assert dgates.dtype == dc_prev.dtype == h1.dtype == torch.float32
    np.testing.assert_array_equal(h1.numpy(), np.concatenate(
        [d["h"], np.ones((B, 1), np.float32)], axis=1))
    np.testing.assert_allclose((h1.T @ dgates).numpy(), np.concatenate(
        [np.asarray(jdW), np.asarray(jdb)[None]]), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dgates.numpy(), np.asarray(jdxw), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(dc_prev.numpy(), np.asarray(jdc), rtol=2e-4,
                               atol=2e-5)


def test_cpu_backward_takes_the_plain_version_without_a_launch():
    d = _inputs(3, 5, seed=4)
    args = [torch.from_numpy(d[n]) for n in NAMES + ("wh", "wc")]
    before = lc.launches_bwd
    got = lc.lstm_cell_backward(*args)
    ref = lc.lstm_cell_backward_reference(*args)
    assert lc.launches_bwd == before
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_grid_fills_the_card():
    """At the training shape (B 64, H 256) a launch has at least 128
    blocks (the H100 has 132 SMs); at B 1 the grid is over units
    alone."""
    assert lc.grid_blocks(64, 256) >= 128
    assert lc.grid_blocks(1, 256) == lc.grid_blocks(2, 256)
    assert lc.grid_blocks(1, 1000) >= lc.grid_blocks(1, 256)
