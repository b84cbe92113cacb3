"""Paged decode attention of the port
(singa_tpu_torch.ops.paged_attention, the plain versions CPU tensors
take) against the JAX Pallas kernel
(singa_tpu.ops.paged_attention.paged_decode_attention, interpret=True),
on the block table of tests/test_paged_serving.py (NULL and stale
entries, mid-page positions).  Tolerance: atol 1e-5 in float32.  The
int8 and bfloat16-page variants of the whole function are held against
the reference in tests/test_torch_quantized_serving.py.

The kernel's decomposition: the split plan (every table entry in one
range, the serving shape's block target, the same launch arguments for
any pos), and the plain versions of its two launches
(``paged_decode_partial_reference`` / ``paged_decode_merge_reference``)
against the JAX kernel under several plans, for float32 pages and int8
pages with bf16 and float32 scales, at pos -1, 0, a page edge and
max_len - 1.  A slot at pos -1 gets the reference's uniform mean of
v_scale * v over its whole table row."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from singa_tpu_torch.ops import paged_attention as pa_mod
from singa_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference,
    paged_decode_merge_reference, paged_decode_partial_reference)

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


# ---- the kernel's decomposition: the split plan and its plain pair ----

_SERVING = dict(S=8, H=12, Ps=64, n_sm=132)


@pytest.mark.parametrize("S,H,Ps,n_sm", [
    (8, 12, 64, 132), (1, 1, 64, 132), (3, 2, 4, 132), (64, 32, 64, 132),
    (2, 4, 43, 132), (5, 3, 7, 8), (1, 12, 1, 132), (8, 12, 128, 114)])
def test_split_plan_covers_every_table_entry_once(S, H, Ps, n_sm):
    R, ppr = pa_mod._split_plan(S, H, Ps, n_sm)
    ranges = [range(r * ppr, min((r + 1) * ppr, Ps)) for r in range(R)]
    seen = [j for rg in ranges for j in rg]
    assert sorted(seen) == list(range(Ps))          # each entry once
    assert all(len(rg) > 0 for rg in ranges)        # no empty range
    assert ppr <= pa_mod._MAX_PPR
    # the block target, wherever one page a range allows it
    assert S * H * R >= min(2 * n_sm, S * H * Ps)


def test_serving_shape_reaches_its_block_target():
    R, ppr = pa_mod._split_plan(*_SERVING.values())
    assert (R, ppr) == (8, 8)
    assert 8 * 12 * R >= 2 * 132


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _stub_launch_path(monkeypatch, fn):
    monkeypatch.setattr(pa_mod, "_fn", lambda: fn)
    monkeypatch.setattr(pa_mod, "_stream", lambda index: 7)
    monkeypatch.setattr(pa_mod, "_sm_count", lambda index: 132)
    sizes = []

    class _Buf:
        def data_ptr(self):
            return 2000

    def scratch(device, n):
        sizes.append((device.type, n))
        return _Buf()

    monkeypatch.setattr(pa_mod, "_scratch", scratch)
    S, H, d, P, Ps = 8, 12, 8, 16, 64
    return (torch.zeros(S, H, d), torch.zeros(3, H, P, d),
            torch.zeros(S, Ps, dtype=torch.int32), sizes)


def test_launch_path_passes_the_same_plan_for_any_pos(monkeypatch):
    """The wrapper's launch path on host tensors, with the C entry, the
    stream and the SM count stubbed: whatever pos holds, the call passes
    the same arguments but for the buffers' addresses, and pos only as
    an address (the plan never reads it: no device-to-host sync)."""
    rec = _Recorder()
    q, kp, table, sizes = _stub_launch_path(monkeypatch, rec)
    before = (pa_mod.launches, pa_mod.launches_merge)
    for fill in (-1, 0, 15, 16, 64 * 16 - 1, 10 ** 6):
        pos = torch.full((8,), fill, dtype=torch.int32)
        pa_mod._kernel_call(q, kp, kp, table, pos, None, None, None)
        assert rec.calls[-1][6] == pos.data_ptr()
    assert (pa_mod.launches, pa_mod.launches_merge) == (before[0] + 6,
                                                        before[1] + 6)
    # every argument but the pos and output addresses, the same
    keep = [i for i in range(len(rec.calls[0])) if i not in (6, 7)]
    assert len({tuple(c[i] for i in keep) for c in rec.calls}) == 1
    assert rec.calls[0][14:16] == (8, 8)                     # R, ppr
    assert rec.calls[0][8] == 2000                           # partials
    # scratch for (m, l, acc) of every (slot, head, range)
    assert sizes == [("cpu", 8 * 12 * 8 * (8 + 2))] * 6


def test_the_unsplit_plan_launches_no_merge(monkeypatch):
    """Under ``R = 1`` the call passes no partials buffer and counts no
    merge launch."""
    rec = _Recorder()
    q, kp, table, sizes = _stub_launch_path(monkeypatch, rec)
    before = (pa_mod.launches, pa_mod.launches_merge)
    pa_mod._launch(q, kp, kp, table, torch.zeros(8, dtype=torch.int32),
                   0.125, None, None, (1, 64))
    assert rec.calls[0][8] is None and rec.calls[0][14:16] == (1, 64)
    assert sizes == []
    assert (pa_mod.launches, pa_mod.launches_merge) == (before[0] + 1,
                                                        before[1])


def test_a_launch_that_fails_raises_and_counts_nothing(monkeypatch):
    q, kp, table, _ = _stub_launch_path(monkeypatch, lambda *args: 700)
    before = (pa_mod.launches, pa_mod.launches_merge)
    pos = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        pa_mod._kernel_call(q, kp, kp, table, pos, None, None, None)
    assert (pa_mod.launches, pa_mod.launches_merge) == before


def _decomposition_case(variant):
    """4 slots at pos -1, 0, a page edge (P) and max_len - 1 over a
    table with stale and NULL entries; float32 pages, or int8 pages
    with bf16 / float32 scales."""
    S, H, d, P, Ps, N = 4, 2, 16, 8, 6, 13
    rng, q, kp, vp = _inputs(S, H, d, P, Ps, N, seed=3)
    table = rng.randint(0, N, size=(S, Ps)).astype(np.int32)
    table[1, 1:] = 0                                 # NULL tail
    pos = np.array([-1, 0, P, Ps * P - 1], np.int32)
    scales = {}
    if variant != "f32":
        kp = rng.randint(-127, 128, size=kp.shape).astype(np.int8)
        vp = rng.randint(-127, 128, size=vp.shape).astype(np.int8)
        scales = {k: (0.002 + 0.028 * rng.rand(N, H, P)).astype(np.float32)
                  for k in ("k_scales", "v_scales")}
    return q, kp, vp, table, pos, scales


_VARIANTS = {"f32": None, "int8_bf16_scales": "bfloat16",
             "int8_f32_scales": "float32"}


@functools.lru_cache(maxsize=None)
def _jax_decomposition_ref(variant):
    q, kp, vp, table, pos, scales = _decomposition_case(variant)
    low = _VARIANTS[variant]
    kw = {k: jnp.asarray(v).astype(getattr(jnp, low))
          for k, v in scales.items()}
    return np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.asarray(pos), interpret=True, **kw))


def _torch_case(variant):
    q, kp, vp, table, pos, scales = _decomposition_case(variant)
    low = _VARIANTS[variant]
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    kw = {k: torch.from_numpy(v).to(getattr(torch, low))
          for k, v in scales.items()}
    return args, kw


@pytest.mark.parametrize("plan", [(1, 6), (6, 1), (2, 3), (3, 2), (2, 4)],
                         ids=["unsplit", "page_a_range", "2x3", "3x2",
                              "4_then_2"])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_partial_merge_pair_matches_jax_kernel(variant, plan):
    """The plain version of the kernel's two launches under several
    plans, against the JAX kernel in interpret mode, at pos -1 (every
    column at -1e9: the uniform mean of v_scale * v over the table row),
    0, a page edge and max_len - 1."""
    args, kw = _torch_case(variant)
    before = (pa_mod.launches, pa_mod.launches_q8, pa_mod.launches_merge)
    ml, acc = paged_decode_partial_reference(*args, plan, **kw)
    got = paged_decode_merge_reference(ml, acc, args[4], plan, 8, 6)
    assert (pa_mod.launches, pa_mod.launches_q8,
            pa_mod.launches_merge) == before
    np.testing.assert_allclose(got.numpy(), _jax_decomposition_ref(variant),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_pos_below_zero_is_the_mean_of_v_over_the_row(variant):
    """The reference's answer for a slot at pos -1, written out: every
    column of the table row weighs 1 / (Ps * P), stale and NULL entries
    included.  A kernel returning zeros there fails this."""
    args, kw = _torch_case(variant)
    q, kp, vp, table, pos = args
    rows = vp[table[0].long()].float()                      # (Ps, H, P, d)
    if kw:
        rows = rows * kw["v_scales"][table[0].long()].float()[..., None]
    want = rows.transpose(0, 1).reshape(2, -1, 16).mean(1)  # (H, d)
    ref = _jax_decomposition_ref(variant)[0]
    np.testing.assert_allclose(want.numpy(), ref, atol=1e-5, rtol=0)
    assert np.abs(ref).max() > 1e-3
    got = paged_decode_attention(q, kp, vp, table, pos, **kw)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("q_dtype,page_dtype,codes", [
    (torch.float32, torch.float32, (0, 0)),
    (torch.bfloat16, torch.bfloat16, (1, 1)),
    (torch.float16, torch.float16, (2, 3)),
    (torch.bfloat16, torch.float32, (1, 0))])
def test_launch_passes_the_query_and_page_type_codes(monkeypatch, q_dtype,
                                                     page_dtype, codes):
    """The C entry gets the query's type code before the pages' (the
    page type independent of the query's); a 16-bit query counts on
    ``launches_lowp`` as well as on ``launches``."""
    rec = _Recorder()
    q, kp, table, _ = _stub_launch_path(monkeypatch, rec)
    before = (pa_mod.launches, pa_mod.launches_lowp)
    out = pa_mod._kernel_call(q.to(q_dtype), kp.to(page_dtype),
                              kp.to(page_dtype), table,
                              torch.zeros(8, dtype=torch.int32), None, None,
                              None)
    assert out.dtype == q_dtype
    assert rec.calls[0][17:20] == codes + (0,)
    lowp = int(q_dtype != torch.float32)
    assert (pa_mod.launches, pa_mod.launches_lowp) == (before[0] + 1,
                                                       before[1] + lowp)


def test_mixed_query_types_the_kernel_does_not_take_raise():
    q = torch.zeros(2, 2, 8, dtype=torch.float64)
    kp = torch.zeros(3, 2, 4, 8)
    table = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="query"):
        pa_mod._check_kernel_operands(q, kp, kp, table, pos, None, None)
