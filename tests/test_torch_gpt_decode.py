"""The port's GPT decode path (singa_tpu_torch.models.gpt) against the JAX
functions it mirrors (singa_tpu.models.gpt), with and without RoPE, on a
seeded tiny GPT: the decode pytree crosses unchanged; the chunked paged
prefill block, the paged decode block and the whole decode iteration
agree from the same pages, table and tokens (hidden state atol 1e-5,
pages at the written positions atol 1e-5, greedy tokens equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import layer as jlayer
from singa_tpu.models import gpt as jgpt
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch.models import gpt as tgpt

torch.set_num_threads(1)

P = 8            # page tokens
S = 3            # slots


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=[False, True], ids=["pos", "rope"])
def models(request):
    np.random.seed(1)
    cfg = jgpt.GPTConfig.tiny(use_rope=request.param)
    m = jgpt.GPT(cfg)
    jgpt.ensure_decode_ready(m)
    tree = jax.tree.map(np.asarray, m.decode_params())
    tcfg = tgpt.GPTConfig.tiny(use_rope=request.param)
    tm = tgpt.GPT.from_jax_decode_params(tree, tcfg, device="cpu")
    return cfg, tree, tm


def _pages(cfg, seed):
    rng = np.random.RandomState(seed)
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    Ps = cfg.max_len // P
    N = 1 + S * Ps
    return [(rng.randn(N, H, P, dh).astype(np.float32),
             rng.randn(N, H, P, dh).astype(np.float32))
            for _ in range(cfg.n_layers)]


def _table(cfg):
    Ps = cfg.max_len // P
    table = np.zeros((S, Ps), np.int32)
    table[0, :4] = [3, 7, 1, 9]                    # NULL tail
    table[1, :] = np.arange(10, 10 + Ps)
    table[2, :3] = [2, 19, 4]
    return table


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_decode_params_cross_unchanged(models):
    cfg, tree, tm = models
    got = dict(_leaves(jax.tree.map(lambda t: t.numpy(),
                                    tm.decode_params())))
    want = dict(_leaves(tree))
    assert got.keys() == want.keys()
    assert ("pos" in want) == (not cfg.use_rope)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_chunk_prefill_block_matches_jax(models):
    cfg, tree, tm = models
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    rng = np.random.RandomState(2)
    C, off = 16, 8
    h = rng.randn(1, C, D).astype(np.float32)
    kp, vp = _pages(cfg, 3)[0]
    row = _table(cfg)[0]
    positions = off + np.arange(C)
    bp = tree["blocks"][0]
    jh, jk, jv = jgpt._block_chunk_prefill_paged(
        _jtree(bp), jnp.asarray(h), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(row), jnp.asarray(positions), H, scale, cfg.use_rope,
        cfg.rope_base)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    th, tk, tv = tgpt._block_chunk_prefill_paged(
        tm.decode_params()["blocks"][0], torch.from_numpy(h), tk, tv,
        torch.from_numpy(row), torch.from_numpy(positions), H, scale,
        cfg.use_rope, cfg.rope_base)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    phys, offs = row[positions // P], positions % P
    for mine, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy()[phys, :, offs],
                                   np.asarray(ref)[phys, :, offs], atol=1e-5)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_block_matches_jax(models):
    cfg, tree, tm = models
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    rng = np.random.RandomState(4)
    h = rng.randn(S, 1, D).astype(np.float32)
    kp, vp = _pages(cfg, 5)[0]
    table = _table(cfg)
    dpos = np.array([27, 40, cfg.max_len - 1], np.int32)
    active = np.array([True, True, False])
    jh, jk, _ = jgpt._block_decode_slots_paged(
        _jtree(tree["blocks"][0]), jnp.asarray(h), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(dpos),
        jnp.asarray(active), H, scale, cfg.use_rope, cfg.rope_base)
    th, tk, _ = tgpt._block_decode_slots_paged(
        tm.decode_params()["blocks"][0], torch.from_numpy(h),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
        torch.from_numpy(table), torch.from_numpy(dpos),
        torch.from_numpy(active), H, scale, cfg.use_rope, cfg.rope_base)
    # the inactive slot's row is garbage by contract (stale table row)
    np.testing.assert_allclose(th.numpy()[:2], np.asarray(jh)[:2],
                               atol=1e-5)
    for s in range(2):
        pg, o = table[s, dpos[s] // P], dpos[s] % P
        np.testing.assert_allclose(tk.numpy()[pg, :, o],
                                   np.asarray(jk)[pg, :, o], atol=1e-5)


def test_decode_iterations_match_jax(models):
    cfg, tree, tm = models
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    pages = _pages(cfg, 6)
    table = _table(cfg)
    tok = np.array([5, 17, 0], np.int32)
    pos = np.array([27, 40, 9], np.int32)
    active = np.array([True, True, False])
    limits = np.array([31, 60, 63], np.int32)
    stops = np.full((S, 8), -1, np.int32)
    zeros_f = np.zeros(S, np.float32)
    zeros_i = np.zeros(S, np.int32)
    kw = dict(H=H, scale=scale, rope=cfg.use_rope, base=cfg.rope_base,
              max_len=cfg.max_len)
    jstate = (tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pages),
              jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active))
    tpages = tuple((torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                   for k, v in pages)
    tstate = (torch.from_numpy(tok), torch.from_numpy(pos),
              torch.from_numpy(active))
    keys = jnp.zeros((S, 2), jnp.uint32)
    jparams = _jtree(tree)
    tparams = tm.decode_params()
    for it in range(6):
        jp, jt, jpos, jact, keys = jgpt.decode_slots_iteration_paged(
            jparams, jstate[0], jnp.asarray(table), *jstate[1:],
            jnp.asarray(zeros_f), jnp.asarray(zeros_i), keys,
            jnp.asarray(limits), jnp.asarray(stops), **kw)
        jstate = (jp, jt, jpos, jact)
        _, tt, tpos, tact = tgpt.decode_slots_iteration_paged(
            tparams, tpages, torch.from_numpy(table), *tstate,
            torch.from_numpy(zeros_f), torch.from_numpy(zeros_i), None,
            torch.from_numpy(limits), torch.from_numpy(stops), **kw)
        tstate = (tt, tpos, tact)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"iteration {it}")
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert not tstate[2].numpy()[0]            # slot 0 hit its limit
    for (k, v), (jk, jv) in zip(tpages, jstate[0]):
        for s in range(2):
            for p in range(pos[s], int(tstate[1][s])):
                pg, o = table[s, p // P], p % P
                np.testing.assert_allclose(k.numpy()[pg, :, o],
                                           np.asarray(jk)[pg, :, o],
                                           atol=1e-5)
                np.testing.assert_allclose(v.numpy()[pg, :, o],
                                           np.asarray(jv)[pg, :, o],
                                           atol=1e-5)


def test_bucket_length_matches_jax():
    for max_len in (64, 1024):
        got = [tgpt.bucket_length(n, max_len) for n in range(1, max_len + 1)]
        want = [jgpt.bucket_length(n, max_len)
                for n in range(1, max_len + 1)]
        assert got == want
    with pytest.raises(ValueError):
        tgpt.bucket_length(65, 64)


def test_apply_rope_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    positions = np.array([0, 3, 9, 10, 40])
    want = np.asarray(jlayer.apply_rope(jnp.asarray(x),
                                        positions=jnp.asarray(positions)))
    got = tlayer.apply_rope(torch.from_numpy(x),
                            positions=torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_seeded_params_fit_the_jax_layout():
    cfg = tgpt.GPTConfig.tiny()
    a = tgpt.seeded_decode_params(cfg, seed=3)
    b = tgpt.seeded_decode_params(cfg, seed=3)
    for (na, xa), (nb, xb) in zip(_leaves(a), _leaves(b)):
        assert na == nb
        np.testing.assert_array_equal(xa, xb)
    tm = tgpt.GPT.from_jax_decode_params(a, cfg, device="cpu")
    assert tm.decode_params()["blocks"][1]["f1"]["W"].shape == (32, 128)
    bad = dict(a, head={"W": a["head"]["W"], "Ws": a["head"]["b"],
                        "b": a["head"]["b"]})
    with pytest.raises(ValueError, match="quantized"):
        tgpt.GPT.from_jax_decode_params(bad, cfg, device="cpu")
