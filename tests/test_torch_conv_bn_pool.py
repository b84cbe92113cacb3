"""The port's convolution, batch-norm and pooling ops
(singa_tpu_torch.ops.convolution / batchnorm / pooling, and their
layers) against the JAX package's (singa_tpu.ops.*) on the CPU, on
seeded numpy inputs: the forward, and the gradients against ``jax.vjp``
of the reference's forward, in both layouts.

Tolerances: float32 at atol 1e-5 (values of order 1; a 3x3 conv sums 9 to
36 products); a bf16 activation under a float32 filter at one unit in
the last place of bf16 (both sides compute in float32 and round once);
the batch-norm running buffers after 3 training steps at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import tensor as jtensor
from singa_tpu.ops import batchnorm as jbn
from singa_tpu.ops import convolution as jconv
from singa_tpu.ops import pooling as jpool
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch.ops import batchnorm as tbn
from singa_tpu_torch.ops import convolution as tconv
from singa_tpu_torch.ops import pooling as tpool
from singa_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _check_vjp(jfn, tfn, args, dy, atol=ATOL):
    """Forward and every argument's gradient of ``tfn`` (torch) against
    ``jax.vjp`` of ``jfn`` on the same numpy ``args`` and cotangent."""
    def fwd_bwd(dy, *a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp(dy)
    want, grads = jax.jit(fwd_bwd)(jnp.asarray(dy), *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = tfn(*ts)
    got.backward(torch.tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)
    for i, (t, g) in enumerate(zip(ts, grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=atol,
                                   rtol=1e-5, err_msg=f"argument {i}")


# (kernel, stride, padding, dilation, groups, bias)
CONVS = {"3x3": (3, 1, 1, 1, 1, True),
         "stride2-nopad": (3, 2, 0, 1, 1, False),
         "dilation2": (3, 1, 2, 2, 1, True),
         "groups4": (3, 1, 1, 1, 4, True),
         "depthwise": (3, 2, 1, 1, 8, False),
         "3x5-s21-p12": ((3, 5), (2, 1), (1, 2), 1, 2, True)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv2d_matches_jax(case, layout):
    k, s, p, d, g, bias = CONVS[case]
    rng = np.random.RandomState(0)
    C, O = 8, 16 if case == "depthwise" else 12
    kh, kw = (k, k) if isinstance(k, int) else k
    x = _rand(rng, 2, C, 9, 10)
    w = _rand(rng, O, C // g, kh, kw) * 0.3
    args = [x, w] + ([_rand(rng, O)] if bias else [])
    jh = jconv.ConvHandle(C, k, s, p, bias, g, d, layout=layout)
    th = tconv.ConvHandle(C, k, s, p, bias, g, d, layout=layout)
    if layout == "NHWC":
        args[0] = _nhwc(x)
    out = tconv._conv_fwd(*map(torch.tensor, args), handle=th)
    dy = _rand(rng, *out.shape)
    _check_vjp(lambda *a: jconv._conv_fwd(*a, handle=jh),
               lambda *a: tconv._conv_fwd(*a, handle=th), args, dy)


def test_conv2d_casts_the_filter_to_the_activation_dtype():
    """A bf16 activation under a float32 filter: the filter is cast to
    bf16 (``_conv_fwd``, :53), the bias added after, the output bf16."""
    rng = np.random.RandomState(1)
    x, w, b = _rand(rng, 2, 4, 8, 8), _rand(rng, 6, 4, 3, 3), _rand(rng, 6)
    jh = jconv.ConvHandle(4, 3, 1, 1)
    th = tconv.ConvHandle(4, 3, 1, 1)
    want = jconv._conv_fwd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                           jnp.asarray(b), handle=jh)
    got = tconv._conv_fwd(torch.tensor(x).bfloat16(), torch.tensor(w),
                          torch.tensor(b), handle=th)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ref = np.asarray(want.astype(jnp.float32))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(ref), 2 ** -6))[1] - 8)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def test_conv_layer_and_raw_forward():
    """``layer.Conv2d``: OIHW He-normal weights from the device's
    generator (std sqrt(2 / fan_in)), zero bias, NHWC in and out;
    ``GpuConvForward`` gives the op's forward without a graph."""
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 16, 12, 12)
    conv = tlayer.Conv2d(64, 3, padding=1, groups=2)
    out = conv(Tensor(data=x, device="cpu"))
    assert conv.W.shape == (64, 8, 3, 3) and out.shape == (2, 64, 12, 12)
    std = float(conv.W.data.detach().std())
    assert abs(std / np.sqrt(2.0 / (8 * 9)) - 1) < 0.1
    assert not conv.b.data.any()
    nhwc = tlayer.Conv2d(64, 3, padding=1, groups=2, layout="NHWC")
    nhwc(Tensor(data=_nhwc(x), device="cpu"))
    nhwc.set_states(conv.get_states())
    got = nhwc(Tensor(data=_nhwc(x), device="cpu")).numpy()
    np.testing.assert_allclose(got, _nhwc(out.numpy()), atol=ATOL)
    raw = tconv.GpuConvForward(Tensor(data=x, device="cpu"), conv.W, conv.b,
                               conv.handle)
    np.testing.assert_array_equal(raw.numpy(), out.numpy())
    assert raw.creator is None


BN_SHAPES = {"NCHW": (4, 6, 5, 5), "NHWC": (4, 5, 5, 6), "NC": (8, 6)}


@pytest.mark.parametrize("case", sorted(BN_SHAPES))
def test_batchnorm_train_and_infer_match_jax(case):
    """Training mode (batch moments in float32, the biased variance) and
    inference mode (the running buffers), forward and gradients."""
    layout = "NHWC" if case == "NHWC" else "NCHW"
    rng = np.random.RandomState(3)
    x = _rand(rng, *BN_SHAPES[case]) * 2 + 0.5
    g, b = _rand(rng, 6), _rand(rng, 6)
    rm, rv = _rand(rng, 6) * 0.1, np.abs(_rand(rng, 6)) + 0.5
    dy = _rand(rng, *x.shape)
    h = tbn.BatchNormHandle(layout=layout)
    _check_vjp(lambda *a: jbn._bn_train_fwd(*a, eps=1e-5, layout=layout),
               lambda *a: tbn._bn_train_fwd(*a, torch.zeros(6),
                                            torch.ones(6), handle=h),
               [x, g, b], dy)
    _check_vjp(lambda xx, gg, bb: jbn._bn_infer_fwd(
        xx, gg, bb, jnp.asarray(rm), jnp.asarray(rv), eps=1e-5,
        layout=layout),
        lambda xx, gg, bb: tbn._bn_infer_fwd(
            xx, gg, bb, torch.tensor(rm), torch.tensor(rv), handle=h),
        [x, g, b], dy)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_running_buffers_after_three_steps(layout):
    """``new = 0.9 old + 0.1 batch`` with the biased batch variance (not
    ``F.batch_norm``'s unbiased one), updated in place: the layer's
    buffers are the same tensors after the steps."""
    rng = np.random.RandomState(4)
    xs = [_rand(rng, 3, 4, 6, 6) * (i + 1) + i for i in range(3)]
    if layout == "NHWC":
        xs = [_nhwc(x) for x in xs]
    jl = jlayer.BatchNorm2d(layout=layout)
    tl = tlayer.BatchNorm2d(layout=layout)
    jautograd.training = tautograd.training = True
    try:
        for i, x in enumerate(xs):
            jl(jtensor.from_numpy(x))
            tl(Tensor(data=x, device="cpu"))
            if i == 0:
                rm_t, rv_t = tl.running_mean.data, tl.running_var.data
    finally:
        jautograd.training = tautograd.training = False
    assert tl.running_mean.data is rm_t and tl.running_var.data is rv_t
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tl, name).numpy(),
                                   np.asarray(getattr(jl, name).data),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert set(tl.get_states()) == {"scale", "bias", "running_mean",
                                    "running_var"}
    assert set(tl.get_params()) == {"scale", "bias"}


def test_batchnorm_bf16_moments_in_float32():
    """A bf16 activation: the moments in float32 and the output bf16,
    within one bf16 unit of the reference's."""
    rng = np.random.RandomState(5)
    x = _rand(rng, 4, 3, 6, 6) * 3 + 100.0     # variance underflows in bf16
    g, b = _rand(rng, 3), _rand(rng, 3)
    want = jbn._bn_train_fwd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                             jnp.asarray(b), eps=1e-5)
    got = tbn._bn_train_fwd(torch.tensor(x).bfloat16(), torch.tensor(g),
                            torch.tensor(b), torch.zeros(3), torch.ones(3),
                            handle=tbn.BatchNormHandle())
    assert got.dtype == torch.bfloat16
    ref = np.asarray(want.astype(jnp.float32))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(ref), 2 ** -6))[1] - 8)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


# (is_max, kernel, stride, padding, count_include_pad)
POOLS = {"max-2x2": (True, 2, None, 0, False),
         "max-3x3-s2-p1": (True, 3, 2, 1, False),
         "max-pad-over-half": (True, 2, 1, 2, False),
         "avg-2x2": (False, 2, None, 0, False),
         "avg-3x3-s2-p1": (False, 3, 2, 1, False),
         "avg-3x3-p1-incl": (False, 3, 1, 1, True),
         "avg-pad-over-half": (False, 2, 2, 2, False),
         "avg-3x2-s12-p10": (False, (3, 2), (1, 2), (1, 0), False)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_matches_jax(case, layout):
    """Max pools pad with -inf; average pools leave the padding out of
    the count unless ``count_include_pad``; the stride defaults to the
    kernel; paddings over half the kernel take the explicit-pad route."""
    is_max, k, s, p, incl = POOLS[case]
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 3, 7, 8)
    if layout == "NHWC":
        x = _nhwc(x)
    jh = jpool.PoolingHandle(k, s, p, is_max, incl, layout=layout)
    th = tpool.PoolingHandle(k, s, p, is_max, incl, layout=layout)
    out = tpool._pool_fwd(torch.tensor(x), handle=th)
    hw = x.shape[1:3] if layout == "NHWC" else x.shape[2:]
    assert tpool.out_shape(th, hw) == jpool.out_shape(jh, hw)
    assert tuple(out.shape[1:3] if layout == "NHWC" else out.shape[2:]) == \
        tpool.out_shape(th, hw)
    dy = _rand(rng, *out.shape)
    _check_vjp(lambda a: jpool._pool_fwd(a, handle=jh),
               lambda a: tpool._pool_fwd(a, handle=th), [x], dy)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_global_avg_pool_and_pool_layers(layout):
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 5, 6, 6)
    if layout == "NHWC":
        x = _nhwc(x)
    want = jlayer.GlobalAvgPool2d(layout=layout)(jtensor.from_numpy(x))
    got = tlayer.GlobalAvgPool2d(layout=layout)(Tensor(data=x, device="cpu"))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), atol=ATOL)
    for cls in ("MaxPool2d", "AvgPool2d"):
        want = getattr(jlayer, cls)(3, 2, 1, layout=layout)(
            jtensor.from_numpy(x))
        lay = getattr(tlayer, cls)(3, 2, 1, layout=layout)
        got = lay(Tensor(data=x, device="cpu"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want.data),
                                   atol=ATOL, err_msg=cls)
        raw = tpool.GpuPoolingForward(lay.handle, Tensor(data=x, device="cpu"))
        np.testing.assert_array_equal(raw.numpy(), got.numpy())
