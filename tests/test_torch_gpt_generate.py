"""The port's standalone decode (singa_tpu_torch.models.gpt: GPT.generate,
its causal prefill block, its one-token step through the slot decode
block with every row at one position, generated_lengths,
ensure_decode_ready) against the JAX package's, with and without RoPE.

The JAX side runs as its own tests run it on the CPU: the prefill block's
einsum route (prefill_flash_enabled is False off the TPU); the port's
prefill block runs the flash-attention kernel's plain version with
``causal=True``.  Tolerances: block outputs and caches atol 1e-5; greedy
tokens identical on the lightly trained tiny GPT of
tests/test_torch_serving.py's fixture, at every decode_horizon (the
reference's 3 and 8 overrun the last chunk; the port's horizon changes
nothing).  The port samples from a torch.Generator, so
sampled tokens are held against the port's own other route, not JAX.

The JAX models train and compile once per module (module-scoped
fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import opt, tensor
from singa_tpu.models import gpt as jgpt
from singa_tpu_torch.models import gpt as tgpt
from singa_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

N_NEW = 20
HORIZONS = [None, 1, 3, 8]


def _stream(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros(n, np.int32)
    x[0] = rng.randint(vocab)
    for i in range(1, n):
        x[i] = (3 * x[i - 1] + 7) % vocab
    return x


@pytest.fixture(scope="module", params=[False, True], ids=["pos", "rope"])
def trained(request):
    """The lightly trained tiny GPT of tests/test_torch_serving.py (its
    greedy continuations are prompt-sensitive), with or without RoPE,
    and the port's model from its decode pytree."""
    import conftest

    np.random.seed(0)
    cfg = jgpt.GPTConfig.tiny(use_rope=request.param)
    m = jgpt.GPT(cfg)
    m.set_optimizer(opt.Adam(lr=3e-3))
    data = _stream(cfg.vocab_size, 8 * 32 * 8 + 1)
    B, T = 8, 32
    with conftest.xla_cache_paused():
        m.compile([tensor.from_numpy(data[:B * T].reshape(B, T))],
                  is_train=True, use_graph=True)
        for _ in range(4):
            for s in range(8):
                seg = data[s * B * T:(s + 1) * B * T + 1]
                m.train_one_batch(
                    tensor.from_numpy(seg[:-1].reshape(B, T)),
                    tensor.from_numpy(seg[1:].reshape(B, T)))
    m.eval()
    jgpt.ensure_decode_ready(m)
    tree = jax.tree.map(np.asarray, m.decode_params())
    tm = tgpt.GPT.from_jax_decode_params(
        tree, tgpt.GPTConfig.tiny(use_rope=request.param), device="cpu")
    return cfg, m, tree, tm


def _prompts(cfg):
    """Three prompts of 11 tokens: two stream continuations and a random
    one (rows of one batch)."""
    rng = np.random.RandomState(5)
    return np.stack([_stream(cfg.vocab_size, 11, seed=3),
                     _stream(cfg.vocab_size, 11, seed=4),
                     rng.randint(0, cfg.vocab_size, 11).astype(np.int32)])


@pytest.fixture(scope="module")
def jax_tokens(trained):
    """JAX generate's greedy tokens for the batch at every horizon."""
    cfg, m, _, _ = trained
    p = _prompts(cfg)
    return {K: m.generate(p, N_NEW, decode_horizon=K) for K in HORIZONS}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---- the blocks ---------------------------------------------------------

def test_block_prefill_matches_jax(trained):
    cfg, _, tree, tm = trained
    H, D = cfg.n_heads, cfg.d_model
    scale = 1.0 / np.sqrt(D // H)
    h = np.random.RandomState(2).randn(2, 32, D).astype(np.float32)
    bp = tree["blocks"][1]
    jh, jk, jv = jgpt._block_prefill(_jtree(bp), jnp.asarray(h), H, scale,
                                     cfg.use_rope, cfg.rope_base)
    before = fa.launches
    th, tk, tv = tgpt._block_prefill(tm.decode_params()["blocks"][1],
                                     torch.from_numpy(h), H, scale,
                                     cfg.use_rope, cfg.rope_base)
    assert fa.launches == before                 # CPU: the plain version
    for mine, ref in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("pos", [0, 17, 63])
def test_block_decode_matches_jax(trained, pos):
    cfg, _, tree, tm = trained
    H, D, L = cfg.n_heads, cfg.d_model, cfg.max_len
    scale = 1.0 / np.sqrt(D // H)
    rng = np.random.RandomState(pos)
    h = rng.randn(3, 1, D).astype(np.float32)
    kc = rng.randn(3, H, L, D // H).astype(np.float32)
    vc = rng.randn(3, H, L, D // H).astype(np.float32)
    bp = tree["blocks"][0]
    jh, jk, jv = jgpt._block_decode(_jtree(bp), jnp.asarray(h),
                                    jnp.asarray(kc), jnp.asarray(vc), pos, H,
                                    scale, cfg.use_rope, cfg.rope_base)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    th, tk2, tv2 = tgpt._block_decode_slots(
        tm.decode_params()["blocks"][0], torch.from_numpy(h), tk, tv,
        torch.full((3,), pos), H, scale, cfg.use_rope, cfg.rope_base)
    assert tk2 is tk and tv2 is tv                # updated in place
    for mine, ref in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5)


# ---- generate -----------------------------------------------------------

@pytest.mark.parametrize("K", HORIZONS, ids=lambda k: f"horizon{k}")
def test_greedy_generate_matches_jax(trained, jax_tokens, K):
    cfg, _, _, tm = trained
    got = tm.generate(_prompts(cfg), N_NEW, decode_horizon=K)
    assert got.dtype == np.int32 and got.shape == (3, N_NEW)
    np.testing.assert_array_equal(got, jax_tokens[K])
    # the JAX package's own routes agree with each other too
    np.testing.assert_array_equal(jax_tokens[K], jax_tokens[None])


def test_one_prompt_and_one_token(trained, jax_tokens):
    """A 1-D prompt is one row; one new token is the prefill's alone (on
    both routes)."""
    cfg, _, _, tm = trained
    p = _prompts(cfg)
    np.testing.assert_array_equal(tm.generate(p[1], N_NEW),
                                  jax_tokens[None][1:2])
    for K in (None, 4):
        np.testing.assert_array_equal(tm.generate(p, 1, decode_horizon=K),
                                      jax_tokens[None][:, :1])


@pytest.mark.parametrize("temperature, top_k", [(0.0, 0), (1.3, 5),
                                                 (0.7, 0)])
def test_horizon_equals_monolithic(trained, temperature, top_k):
    cfg, _, _, tm = trained
    p = _prompts(cfg)
    kw = dict(temperature=temperature, top_k=top_k, seed=11)
    mono = tm.generate(p, N_NEW, **kw)
    for K in (1, 3, 8, 32):
        np.testing.assert_array_equal(
            tm.generate(p, N_NEW, decode_horizon=K, **kw), mono,
            err_msg=f"decode_horizon={K}")
    if temperature > 0:
        np.testing.assert_array_equal(tm.generate(p, N_NEW, **kw), mono)
        other = tm.generate(p, N_NEW, **dict(kw, seed=12))
        assert not np.array_equal(other, mono)


def test_stop_tokens_and_lengths_match_jax(trained, jax_tokens):
    cfg, m, _, tm = trained
    p = _prompts(cfg)
    full = jax_tokens[None]
    stops = {int(full[0, 4]), int(full[2, 9])}
    want_toks, want_len = m.generate(p, N_NEW, stop_tokens=stops)
    for K in (None, 3):
        toks, lengths = tm.generate(p, N_NEW, stop_tokens=stops,
                                    decode_horizon=K)
        np.testing.assert_array_equal(toks, want_toks)
        np.testing.assert_array_equal(lengths, want_len)
        np.testing.assert_array_equal(
            lengths, jgpt.generated_lengths(toks, stops))
    assert want_len[0] <= 5 and want_len[2] <= 10
    toks, lengths = tm.generate(p, N_NEW, return_lengths=True)
    np.testing.assert_array_equal(lengths, np.full(3, N_NEW, np.int32))


def test_generated_lengths_matches_jax():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 6, (7, 9)).astype(np.int32)
    for stops in (None, (), {2}, {0, 5}, [9], {1, 2, 3, 4}):
        got = tgpt.generated_lengths(toks, stops)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jgpt.generated_lengths(toks,
                                                                  stops))


@pytest.mark.parametrize("args, kw", [
    ((0,), {}), ((-2,), {}), ((60,), {}), ((4,), dict(decode_horizon=0))],
    ids=["no_tokens", "negative", "past_max_len", "horizon_0"])
def test_generate_raises_as_jax(trained, args, kw):
    cfg, m, _, tm = trained
    p = _prompts(cfg)[:, :8]
    with pytest.raises(ValueError) as want:
        m.generate(p, *args, **kw)
    with pytest.raises(ValueError) as got:
        tm.generate(p, *args, **kw)
    assert str(got.value) == str(want.value)


def test_ensure_decode_ready_materialises_on_the_model_device():
    """A fresh port model's lazy params exist after the call; the tree
    lies on the model's device (nothing is moved) and the int8 tree is
    memoised."""
    tm = tgpt.GPT(tgpt.GPTConfig.tiny(), device="cpu")
    assert not hasattr(tm.ln_f, "scale")
    tree = tgpt.ensure_decode_ready(tm)
    assert hasattr(tm.ln_f, "scale")
    assert tree["blocks"][0]["q"]["W"].device.type == "cpu"
    q8 = tgpt.ensure_decode_ready(tm, "int8")
    assert q8["head"]["W"].dtype == torch.int8
    assert tgpt.ensure_decode_ready(tm, "int8") is q8
    got = tm.generate(np.arange(5), 4)
    assert got.shape == (1, 4)
