"""GPT of the port: training through the layer API and the decode path.
Counterpart: ``singa_tpu/models/gpt.py``.

Ported here: the configuration (``GPTConfig`` with ``use_flash`` and
``precision``, ``bucket_length``, the ``NONFINITE_TOKEN`` sentinel);
``GPTBlock`` (the pre-LN block with the erf-gelu FFN) and :class:`GPT`,
the port's :class:`~singa_tpu_torch.model.Model` with ``tok``, ``pos``
(absent with rope), ``blocks``, ``ln_f`` and ``head``, its ``forward``,
``train_one_batch`` and ``generate``; ``decode_params()``, the JAX
decode pytree built from those same parameters (``_build_decode_params``),
float or with every Linear quantized per output channel, so a model
trained in the port serves through the engine; the int8 quantization
helpers (``_quantize_rows``, ``_quantize_channels``); and the functional
decode pieces:

* ``generate``'s own: the causal prefill block (attention through the
  flash-attention kernel, ``causal=True``); its one-token steps run the
  slot decode block with every row at one position;
* the slot-layout serving engine's: the chunked prefill block over one
  slot's row (float caches: attention through the flash-attention kernel
  with the ``(C, L)`` dense mask; quantized caches: the reference's
  einsum with the scales folded in), the one-token decode block over
  every slot and its decode iteration (the reference's einsum: no
  kernel computes slot decode attention on the TPU either);
* the paged serving engine's: the chunked paged prefill block (flash
  with the dense mask, or the einsum when quantized) and the paged
  one-token decode block (the paged decode kernel, float or int8).

Unlike JAX's functional updates, caches and page pools (and their scale
pools) are updated in place: each block writes its K/V rows into the
tensors it was handed and returns those same tensors.

Mixed precision: ``GPTConfig(precision="bfloat16" | "float16" | a
Policy)`` installs the policy on the model (reference gpt.py:231).
Training then runs in the compute dtype with float32 masters
(:mod:`singa_tpu_torch.model`), and ``decode_params()`` casts every
float leaf to the compute dtype (one copy; a quantized tree quantizes
its Linear weights from the float32 masters and casts the rest), so
``generate`` and the engines run in it and their caches take its dtype.
Each decode op keeps the dtype the reference's gives: a float32
constant mask added to 16-bit scores is cast to their dtype first, as
JAX's weakly typed ``jnp.where(..., 0.0, -1e9)`` is.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .. import _graphs, autograd, layer
from ..device import get_device
from ..layer import apply_rope
from ..model import Model
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..precision import dtype_name, resolve_dtype
from ..tensor import Tensor

__all__ = ["GPTConfig", "GPTBlock", "GPT", "bucket_length",
           "ensure_decode_ready", "generated_lengths", "NONFINITE_TOKEN",
           "MIN_PREFILL_BUCKET", "GEN_CACHE_MAX", "seeded_decode_params",
           "decode_slots_iteration", "decode_slots_iteration_paged"]

# Sentinel token emitted when a row's logits go non-finite; -1 is never a
# real token id, so the ordinary token fetch doubles as the poison probe.
NONFINITE_TOKEN = -1

# prompt lengths are padded up to the next power of two at least this
# large (the JAX package's prefill bucketing)
MIN_PREFILL_BUCKET = 16

# generate's decode loops kept per model, least recently used dropped
# first (the reference's bound on its compiled-program cache)
GEN_CACHE_MAX = 8


def bucket_length(n: int, max_len: int,
                  min_bucket: int = MIN_PREFILL_BUCKET) -> int:
    """Pad a prompt length up to its power-of-2 bucket (clamped to
    ``max_len``)."""
    if n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len {max_len}")
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_len)


def generated_lengths(tokens: np.ndarray, stop_tokens) -> np.ndarray:
    """Per-row generated length under stop-token semantics: the stop
    token is included in the length (the engine streams it, then
    evicts).  ``stop_tokens`` empty or None: every row is full length."""
    B, n = tokens.shape
    if not stop_tokens:
        return np.full(B, n, np.int32)
    hit = np.isin(tokens, np.asarray(sorted(stop_tokens), np.int32))
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, n)
    return first.astype(np.int32)


class GPTConfig:
    def __init__(self, vocab_size=256, d_model=128, n_layers=4, n_heads=4,
                 max_len=256, use_flash: bool | None = False,
                 use_rope: bool = False, rope_base: float = 10000.0,
                 precision=None):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.max_len = max_len
        # True/False force the attention path; None picks by device
        # (flash on CUDA, naive on the CPU)
        self.use_flash = use_flash
        # rotary position embeddings instead of the learned pos table
        self.use_rope = use_rope
        self.rope_base = float(rope_base)
        # a mixed-precision policy name ("bfloat16"/"float16"/"float32") or
        # a precision.Policy, installed by GPT; None keeps Model.compile's
        self.precision = precision

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 64)
        kw.setdefault("d_model", 32)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 2)
        kw.setdefault("max_len", 64)
        return cls(**kw)

    @classmethod
    def small(cls, **kw):  # GPT-2-small dims
        kw.setdefault("vocab_size", 50257)
        kw.setdefault("d_model", 768)
        kw.setdefault("n_layers", 12)
        kw.setdefault("n_heads", 12)
        kw.setdefault("max_len", 1024)
        return cls(**kw)


def _shapes(c: GPTConfig) -> dict:
    """Leaf shapes of the decode pytree (``{W, b}`` Linears with ``W``
    as (in, out), ``{g, b}`` LayerNorms)."""
    D, V, Fd = c.d_model, c.vocab_size, 4 * c.d_model
    lin = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D),
           "f1": (D, Fd), "f2": (Fd, D)}
    block = {n: {"W": s, "b": (s[1],)} for n, s in lin.items()}
    block["ln1"] = {"g": (D,), "b": (D,)}
    block["ln2"] = {"g": (D,), "b": (D,)}
    out = {"tok": (V, D), "lnf": {"g": (D,), "b": (D,)},
           "head": {"W": (D, V), "b": (V,)},
           "blocks": [block] * c.n_layers}
    if not c.use_rope:
        out["pos"] = (c.max_len, D)
    return out


def seeded_decode_params(config: GPTConfig, seed: int = 0) -> dict:
    """A random decode pytree of numpy float32 arrays in the JAX
    package's layout, made from ``seed`` (weights ~ N(0, 0.02), biases
    0, LayerNorm gains 1) — the input :meth:`GPT.from_jax_decode_params`
    takes when no trained JAX model is at hand."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "g":
            return np.ones(shape, np.float32)
        if name == "b":
            return np.zeros(shape, np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def build(name, spec):
        if isinstance(spec, tuple):
            return leaf(name, spec)
        if isinstance(spec, list):
            return [build(name, s) for s in spec]
        return {k: build(k, v) for k, v in spec.items()}

    return build("", _shapes(config))


class GPTBlock(layer.Layer):
    """Pre-LN decoder block: x + attn(ln1 x); x + ffn(ln2 x), erf-gelu
    FFN."""

    def __init__(self, n_heads, ffn_dim, use_flash=False, use_rope=False,
                 rope_base=10000.0, name=None):
        super().__init__(name)
        self.ln1 = layer.LayerNorm(name=f"{self.name}.ln1")
        self.attn = layer.MultiHeadAttention(n_heads, causal=True,
                                             use_flash=use_flash,
                                             rope=use_rope,
                                             rope_base=rope_base,
                                             name=f"{self.name}.attn")
        self.ln2 = layer.LayerNorm(name=f"{self.name}.ln2")
        self.fc1 = layer.Linear(ffn_dim, name=f"{self.name}.fc1")
        self.fc2 = None  # sized to d_model on first call

    def initialize(self, x):
        self.fc2 = layer.Linear(x.shape[-1], name=f"{self.name}.fc2")

    def forward(self, x):
        x = autograd.add(x, self.attn(self.ln1(x)))
        h = autograd.gelu(self.fc1(self.ln2(x)))
        return autograd.add(x, self.fc2(h))


class GPT(Model):
    """GPT language model: ``tok`` (and ``pos`` without rope)
    embeddings, ``blocks``, ``ln_f`` and the ``head`` Linear.  The
    embeddings are created on ``device`` (the card by default) at
    construction; the rest materialise at ``compile`` (or at the first
    ``decode_params()``).  State names after ``compile`` are the JAX
    package's (``tok.W``, ``blocks0.attn.Wq.W``, ...)."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = self.config = config
        self.device = get_device(device)
        self.tok = layer.Embedding(c.vocab_size, c.d_model,
                                   device=self.device)
        # learned pos table only without rope
        self.pos = None if c.use_rope else \
            layer.Embedding(c.max_len, c.d_model, device=self.device)
        self.blocks = [GPTBlock(c.n_heads, 4 * c.d_model,
                                use_flash=c.use_flash, use_rope=c.use_rope,
                                rope_base=c.rope_base, name=f"blk{i}")
                       for i in range(c.n_layers)]
        self.ln_f = layer.LayerNorm()
        self.head = layer.Linear(c.vocab_size)
        # decode trees that are not the parameters' own storage (cast to
        # a mixed policy's compute dtype, or quantized), by (compute
        # dtype, weight_dtype, scale_dtype) name: (the state tensors,
        # their version counters, tree)
        self._decode_memo: dict = {}
        # generate's decode loops, by (B, compute dtype, sampled)
        self._gen_entries: OrderedDict = OrderedDict()
        if c.precision is not None:
            self.set_precision_policy(c.precision)

    # ---- training path (layer API) ------------------------------------
    def forward(self, ids):
        T = ids.shape[1]
        if self.config.use_rope:
            h = self.tok(ids)   # positions live in the attention rotation
        else:
            pos_ids = Tensor(data=torch.arange(
                T, dtype=torch.int32, device=ids.device.torch_device),
                requires_grad=False)
            h = autograd.add(self.tok(ids), self.pos(pos_ids))
        for blk in self.blocks:
            h = blk(h)
        return self.head(self.ln_f(h))

    def train_one_batch(self, ids, targets):
        logits = self.forward(ids)
        B, T, V = logits.shape
        loss = autograd.softmax_cross_entropy(
            autograd.reshape(logits, (B * T, V)),
            autograd.reshape(targets, (B * T,)))
        self.optimizer(loss)
        return logits, loss

    def _materialize(self):
        """Create the lazy params (a one-token placeholder pass on the
        model's device) without touching the train/eval mode."""
        if not hasattr(self.ln_f, "scale"):
            ids = Tensor(data=torch.zeros((1, 1), dtype=torch.int32,
                                          device=self.device.torch_device),
                         requires_grad=False)
            self._placeholder_pass([ids])

    # ---- weights across from the JAX package --------------------------
    @classmethod
    def from_jax_states(cls, states, config: GPTConfig, device=None):
        """Build the port's model from ``{name: np.ndarray}`` as the JAX
        ``m.get_states()`` gives it after ``compile``
        (``jax.tree.map(np.asarray, m.get_states())``).  Reads nothing
        else; the names and shapes must be exactly the port's."""
        model = cls(config, device=device)
        model._materialize()
        mine = model.get_states()
        missing, extra = set(mine) - set(states), set(states) - set(mine)
        if missing or extra:
            raise ValueError(f"state names differ: missing {sorted(missing)}"
                             f", unexpected {sorted(extra)}")
        for name, t in mine.items():
            shape = tuple(np.shape(states[name]))
            if shape != t.shape:
                raise ValueError(f"{name}: shape {shape}, expected {t.shape}")
        model.set_states(states)
        return model

    @classmethod
    def from_jax_decode_params(cls, tree, config: GPTConfig, device=None):
        """Build the port's model from the JAX decode pytree given as
        numpy arrays (``jax.tree.map(np.asarray,
        jax_model.decode_params())``).  Reads only the dict of arrays —
        no JAX import.  Every leaf must be float and shaped as
        ``config`` says; quantized pytrees (``Ws`` scales) are refused."""
        model = cls(config, device=device)
        model._materialize()
        mine = model._build_decode_params(None, None, cast=False)
        want = _shapes(config)

        def copy(dst, src, spec, path):
            if isinstance(spec, tuple):
                a = np.asarray(src)
                if a.shape != spec:
                    raise ValueError(f"{path}: shape {a.shape}, expected "
                                     f"{spec}")
                if not np.issubdtype(a.dtype, np.floating):
                    raise ValueError(f"{path}: dtype {a.dtype} is not float")
                dst.copy_(torch.tensor(np.asarray(a, np.float32)))
                return
            if isinstance(spec, list):
                if len(src) != len(spec):
                    raise ValueError(f"{path}: {len(src)} blocks, expected "
                                     f"{len(spec)}")
                for i, (d, s, w) in enumerate(zip(dst, src, spec)):
                    copy(d, s, w, f"{path}[{i}]")
                return
            if set(src) != set(spec):
                raise ValueError(f"{path}: keys {sorted(src)}, expected "
                                 f"{sorted(spec)} (quantized decode "
                                 f"pytrees are not taken: pass the float "
                                 f"weights and let the engine quantize "
                                 f"them, ServingEngine(weight_dtype="
                                 f"'int8'))")
            for k in spec:
                copy(dst[k], src[k], spec[k], f"{path}.{k}" if path else k)

        with torch.no_grad():
            copy(mine, tree, want, "")
        return model

    # ---- inference path ------------------------------------------------
    def decode_params(self, weight_dtype=None,
                      scale_dtype=torch.bfloat16) -> dict:
        """The parameters as the JAX decode pytree
        (``_build_decode_params``): a nested dict of ``{W, b}`` Linears
        with ``W`` as (in, out) and ``{g, b}`` LayerNorms.  The float tree
        shares storage with the layers' parameters; under a mixed
        precision policy every float leaf is a copy in the compute dtype.

        ``weight_dtype`` (int8): quantized serving — every Linear
        (q/k/v/o/f1/f2/head) stores a per-output-channel quantized ``W``
        plus a ``Ws`` scale row in ``scale_dtype``
        (:func:`_quantize_channels`); LayerNorms and embeddings stay
        float and shared.  A tree that is not the parameters' own
        storage (quantized, or cast under a mixed policy) is memoised per
        ``(compute dtype, weight_dtype, scale_dtype)`` and rebuilt once a
        state tensor has been replaced or updated in place (training,
        ``set_states``): the tensors and their version counters key the
        memo.  So repeated calls return the same tensors, which a
        captured ``generate`` loop reads."""
        self._materialize()
        pol = self.precision_policy
        cast = pol is not None and pol.mixed
        if weight_dtype is None and not cast:
            return self._build_decode_params(None, None)
        wd = sd = None
        if weight_dtype is not None:
            wd, sd = resolve_dtype(weight_dtype), resolve_dtype(scale_dtype)
        key = tuple(dtype_name(d) if d is not None else None
                    for d in (pol.compute_dtype if cast else None, wd, sd))
        srcs = [t.data for t in self.get_states().values()]
        versions = [t._version for t in srcs]
        hit = self._decode_memo.get(key)
        if hit is None or hit[1] != versions \
                or any(a is not b for a, b in zip(hit[0], srcs)):
            hit = self._decode_memo[key] = (
                srcs, versions, self._build_decode_params(wd, sd))
        return hit[2]

    def _build_decode_params(self, weight_dtype, scale_dtype, cast=True):
        """The decode tree; with ``cast`` and a mixed policy, its float
        leaves in the compute dtype (reference gpt.py:283-290), the
        quantized Linear weights from the float32 masters."""
        pol = self.precision_policy
        to = pol.compute_dtype if (cast and pol is not None
                                   and pol.mixed) else None

        def c(t):
            t = t.detach()
            return t.to(to) if to is not None else t

        def lin(lay):
            W, b = lay.W.data.detach(), c(lay.b.data)
            if weight_dtype is None:
                return {"W": c(W), "b": b}
            Wq, Ws = _quantize_channels(W, scale_dtype, weight_dtype)
            return {"W": Wq, "Ws": Ws, "b": b}

        def ln(lay):
            return {"g": c(lay.scale.data), "b": c(lay.bias.data)}

        blocks = []
        for blk in self.blocks:
            a = blk.attn
            blocks.append({
                "ln1": ln(blk.ln1), "ln2": ln(blk.ln2),
                "q": lin(a.Wq), "k": lin(a.Wk), "v": lin(a.Wv),
                "o": lin(a.Wo), "f1": lin(blk.fc1), "f2": lin(blk.fc2)})
        out = {"tok": c(self.tok.W.data), "lnf": ln(self.ln_f),
               "head": lin(self.head), "blocks": blocks}
        if self.pos is not None:
            out["pos"] = c(self.pos.W.data)
        return out

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 seed: int = 0, stop_tokens=None,
                 return_lengths: bool = False,
                 decode_horizon: int | None = None, _capture: bool = True):
        """Autoregressive generation on the model's device: the prompt
        (B, Tp), padded to its power-of-2 bucket, is prefilled through
        the causal flash-attention kernel into per-layer ``(B, H,
        max_len, dh)`` caches; the first new token comes from the true
        last prompt position; then one-token decode steps follow.
        ``temperature=0`` is greedy; otherwise samples from
        ``logits/temperature`` (optionally top-k filtered), drawing from
        one ``torch.Generator`` seeded by ``seed`` for the call.

        The decode loop belongs to an entry kept per ``(B, compute
        dtype, greedy or sampled)`` (at most :data:`GEN_CACHE_MAX`, the
        least recently used dropped first; the reference's compiled
        program cache): its caches, zeroed once when it is made (an
        earlier call's columns stay finite and weigh exactly 0 under the
        mask), its token buffer, device position, temperature and top-k
        and its generator, re-seeded every call.  On the card the decode
        step is a CUDA graph (the protocol of :mod:`singa_tpu_torch.
        _graphs`: the entry's first step runs eagerly, its second
        captures): ``max_new_tokens - 1`` replays, whatever the prompt,
        its length, the temperature or top-k (device scalars).  The
        prefill stays eager.  On the CPU the same step runs eagerly.
        ``_capture=False`` runs the card's loop eagerly too: the twin a
        check holds the graph against.  ``decode_horizon`` is checked
        (>= 1) as in the reference and changes nothing: one loop serves
        every horizon with the same tokens, greedy or sampled.  The
        tokens stay on the device and are fetched once at the end.

        Returns a numpy array (B, max_new_tokens); with ``stop_tokens=``
        or ``return_lengths=True``, ``(tokens, lengths)`` where
        ``lengths[b]`` counts tokens up to and including the first stop
        token."""
        c = self.config
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        B, Tp = prompt.shape
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if Tp + max_new_tokens > c.max_len:
            raise ValueError(f"{Tp}+{max_new_tokens} exceeds max_len "
                             f"{c.max_len}")
        params = self.decode_params()
        Tb = bucket_length(Tp, c.max_len)
        padded = np.zeros((B, Tb), np.int32)
        padded[:, :Tp] = prompt
        if decode_horizon is not None and decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, "
                             f"got {decode_horizon}")
        dev = self.device.torch_device
        t, k = float(temperature), int(top_k or 0)
        key = ("generate", B, dtype_name(params["tok"].dtype), t > 0)
        e = self._gen_entry(key, B, params["tok"].dtype, dev)
        e.gen.manual_seed(int(seed))
        tok = _make_gen_prefill(c)(params, torch.from_numpy(padded).to(dev),
                                   Tp, t, k, e.gen, e.caches)
        e.start(tok, Tp, t, k)
        gens = [e.gen] * B if t > 0 else None
        n = int(max_new_tokens) - 1
        if n and _capture and _graphs.captures_on(dev):
            # a graph is bound to the parameters' storage (the tree's
            # view objects are new every call)
            self._gc.call(key, dev, _gen_decode_step, (params, e, c, gens),
                          lambda: tuple(x.data_ptr() for x in _leaves(params)),
                          generators=[e.gen] if gens else (), k=n)
        else:
            for _ in range(n):
                _gen_decode_step(params, e, c, gens)
        # a copy: on the CPU the tensor's numpy view is the entry's buffer
        toks = e.out[:, :max_new_tokens].cpu().numpy().copy()
        if stop_tokens is None and not return_lengths:
            return toks
        return toks, generated_lengths(toks, stop_tokens)

    def _gen_entry(self, key, B, dtype, dev):
        """The decode loop's entry of ``key``, made (and the least
        recently used one dropped, with its graph) when missing."""
        entries = self._gen_entries
        e = entries.pop(key, None)
        if e is None:
            self._gc.forget(key)
            e = _GenEntry(self.config, B, dtype, dev)
            while len(entries) >= GEN_CACHE_MAX:
                self._gc.forget(entries.popitem(last=False)[0])
        entries[key] = e
        return e


# the reference's name for the same call
ensure_decode_ready = GPT.decode_params


# ---- pure decode math (mirrors the JAX functions one for one) ----------

def _ln(x, p, eps=1e-5):
    # fp32 accumulation pin, as in the JAX package
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) / torch.sqrt(var + eps) * p["g"].to(torch.float32) \
        + p["b"].to(torch.float32)
    return out.to(x.dtype)


def _lin(x, p):
    # quantized decode weights carry a per-output-channel scale "Ws": the
    # dequant folds into the matmul OUTPUT, as in the reference (the int8
    # W is converted to x's dtype on its way into a plain torch.matmul)
    if "Ws" in p:
        return (x @ p["W"].to(x.dtype)) * p["Ws"].to(x.dtype) + p["b"]
    return x @ p["W"] + p["b"]


# ---- int8 quantization helpers ------------------------------------------

# symmetric-range ceiling per quantized storage format (the reference's
# table; the port validates int8 only — precision.validate_quant_dtype)
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}


def _quantize_rows(x, scale_dtype=torch.bfloat16, q_dtype=torch.int8):
    """Symmetric per-vector quantization over the LAST axis (the d_head
    axis of a K/V row): returns ``(q, scale)`` with
    ``x ~= q * scale[..., None]``.  The scale is rounded to
    ``scale_dtype`` BEFORE dividing, so the stored pair dequantises with
    the exact scale that produced it; rounding is half to even, as
    ``jnp.round``."""
    name = dtype_name(q_dtype)
    qmax = _QMAX[name]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    sc = (torch.clamp_min(amax, 1e-8) / qmax).to(scale_dtype)
    q = xf / sc.to(torch.float32)[..., None]
    if name == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(q_dtype), sc


def _quantize_channels(W, scale_dtype=torch.bfloat16, q_dtype=torch.int8):
    """Per-OUTPUT-channel weight quantization: ``W`` (D_in, D_out) ->
    ``(W_q, Ws (D_out,))`` with ``W ~= W_q * Ws[None, :]``."""
    name = dtype_name(q_dtype)
    qmax = _QMAX[name]
    Wf = W.to(torch.float32)
    amax = Wf.abs().amax(dim=0)
    Ws = (torch.clamp_min(amax, 1e-8) / qmax).to(scale_dtype)
    Wq = Wf / Ws.to(torch.float32)[None, :]
    if name == "int8":
        Wq = torch.clamp(torch.round(Wq), -qmax, qmax)
    return Wq.to(q_dtype), Ws


def _layer_kv(kv):
    """Split one cache layer into ``(k, v, k_scale, v_scale)``: scales
    are None for the 2-leaf float layout, tensors for the quantized
    4-leaf layout."""
    if len(kv) == 4:
        return tuple(kv)
    k, v = kv
    return k, v, None, None


def _pack_kv(k, v, k_scale, v_scale):
    return (k, v) if k_scale is None else (k, v, k_scale, v_scale)


def _heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).permute(0, 2, 1, 3)   # (B,H,T,dh)


def _logits(params, h):
    return _lin(_ln(h, params["lnf"]), params["head"])


def _embed(params, tok, pos_idx, rope=False):
    e = params["tok"][tok.long()]
    if rope:
        return e  # positions live in the attention rotation
    return e + params["pos"][pos_idx.long()]


def _rope_rows(x, positions, base=10000.0):
    """Rotary embedding for a one-token step with per-row positions:
    ``x`` (B, H, 1, dh), ``positions`` (B,)."""
    half = x.shape[-1] // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None]    # (B, half)
    cos = torch.cos(ang)[:, None, None]                       # (B,1,1,half)
    sin = torch.sin(ang)[:, None, None]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gather_pages(pages, page_rows):
    """Contiguous per-slot K or V rows from the page pool: ``pages``
    (N, H, P, dh) gathered through ``page_rows`` (..., Ps) ->
    (..., H, Ps*P, dh); column ``c`` holds logical position ``c``."""
    g = pages[page_rows.long()]                       # (..., Ps, H, P, dh)
    *lead, Ps, H, P, dh = g.shape
    n = len(lead)
    order = tuple(range(n)) + (n + 1, n, n + 2, n + 3)
    return g.permute(order).reshape(*lead, H, Ps * P, dh)


def _gather_page_scales(scales, page_rows):
    """:func:`_gather_pages` for the (N, H, P) scale pool ->
    (..., H, Ps*P), the same column <-> logical-position mapping."""
    return _gather_pages(scales[..., None], page_rows)[..., 0]


def _qkv(bp, h, H):
    """The block's pre-LN and its q, k, v heads, each (B, H, T, dh)."""
    x = _ln(h, bp["ln1"])
    return tuple(_heads(_lin(x, bp[n]), H) for n in ("q", "k", "v"))


def _block_out(bp, h, ctx):
    """The block after attention: ``ctx`` (B, H, T, dh) through the
    output projection and the residual, then the erf-gelu FFN."""
    B, H, T, dh = ctx.shape
    ctx = ctx.permute(0, 2, 1, 3).reshape(B, T, H * dh)
    h = h + _lin(ctx, bp["o"])
    f = F.gelu(_lin(_ln(h, bp["ln2"]), bp["f1"]))
    return h + _lin(f, bp["f2"])


def _chunk_attention(q, kr, vr, positions, scale, ksr=None, vsr=None):
    """A prompt chunk's queries ``q`` (1, H, C, dh) over one slot's whole
    row ``kr``/``vr`` (1, H, L, dh) under the ``(C, L)`` mask ``col <=
    position``: columns past the written prefix weigh exactly zero.
    Float rows go through the flash-attention kernel with that dense
    mask; rows in another dtype than q's (float32 pages under a bf16
    policy) go in as they are and flash computes on the common dtype,
    returning q's (reference gpt.py:655-661, :966-975).  With
    ``ksr``/``vsr`` (1, H, L), the quantized rows' scales, it is the
    reference's own route, an einsum with the K scales folded into the
    scores and the V scales into the softmax weights, the int8 rows cast
    to q's dtype (:630, :963): no kernel runs there on the TPU either,
    so flash is not launched."""
    L = kr.shape[2]
    cols = torch.arange(L, device=positions.device)
    mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)  # (C, L)
    if ksr is None:
        return flash_attention(q.contiguous(), kr, vr, mask[None, None],
                               sm_scale=scale)
    s = torch.einsum("bhtd,bhsd->bhts", q, kr.to(q.dtype)) * scale
    s = s * ksr.to(s.dtype)[:, :, None, :]
    s = s + mask[None, None].to(s.dtype)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", w * vsr.to(w.dtype)[:, :, None, :],
                        vr.to(w.dtype))


def _block_prefill(bp, h, H, scale, rope=False, base=10000.0):
    """Full causal attention over the (bucket-padded) prompt ``h`` (B, T,
    D): returns ``(h', k, v)`` with k, v (B, H, T, dh) for the cache.
    With rope, K enters the cache already rotated (decode never rotates
    cached keys again).  Attention runs through the flash-attention
    kernel with ``causal=True``; the pad tail's rows are garbage that no
    real position attends."""
    q, k, v = _qkv(bp, h, H)
    if rope:
        q, k = apply_rope(q, base=base), apply_rope(k, base=base)
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          sm_scale=scale, causal=True)
    return _block_out(bp, h, ctx), k, v


def _leaves(tree):
    """The tensors of a decode tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class _GenEntry:
    """One ``generate`` decode loop: per-layer ``(B, H, max_len, dh)``
    caches (zeroed once), the current tokens ``tok`` (B,) int32, the
    shared position ``pos`` and the next column ``n`` of ``out`` (B,
    max_len) int32 (one-element int64 tensors, advanced by the step),
    the temperature and top-k (one-element device tensors), and the
    loop's generator."""

    def __init__(self, c, B, dtype, dev):
        H = c.n_heads
        shape = (B, H, c.max_len, c.d_model // H)
        self.caches = tuple(
            (torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(c.n_layers))
        self.tok = torch.zeros(B, dtype=torch.int32, device=dev)
        self.out = torch.zeros((B, c.max_len), dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        self.n = torch.zeros(1, dtype=torch.long, device=dev)
        self.temp = torch.zeros(1, dtype=torch.float32, device=dev)
        self.topk = torch.zeros(1, dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev)

    def start(self, tok, pos, temperature, top_k):
        """A call's first token ``tok`` (B,) at ``out[:, 0]``, the loop
        at position ``pos`` (fills on the device: no upload)."""
        self.tok.copy_(tok)
        self.out[:, :1].copy_(tok[:, None])
        self.pos.fill_(pos)
        self.n.fill_(1)
        self.temp.fill_(temperature)
        self.topk.fill_(top_k)


def _gen_decode_step(params, e, c, gens):
    """``generate``'s decode body on entry ``e`` (:class:`_GenEntry`):
    one token for the whole batch at the shared position ``e.pos``,
    through :func:`_block_decode_slots` with every row there, sampled
    per row with the entry's device temperature and top-k from ``gens``
    (the entry's generator once a row, or None when greedy); the token,
    the position and the output column are advanced in place, so the
    step reads no host scalar and can be captured."""
    from ..serving.sampling import sample_logits_per_row

    B = e.tok.shape[0]
    H = c.n_heads
    scale = 1.0 / math.sqrt(c.d_model // H)
    dpos = e.pos.expand(B)
    h = _embed(params, e.tok[:, None], dpos[:, None], c.use_rope)  # (B,1,D)
    for bp, (kc, vc) in zip(params["blocks"], e.caches):
        h = _block_decode_slots(bp, h, kc, vc, dpos, H, scale, c.use_rope,
                                c.rope_base)[0]
    nxt = sample_logits_per_row(_logits(params, h)[:, 0], e.temp.expand(B),
                                e.topk.expand(B), gens)
    e.tok.copy_(nxt)
    e.out.index_copy_(1, e.n, nxt[:, None])
    e.pos.add_(1)
    e.n.add_(1)


def _make_gen_prefill(c):
    """``generate``'s prefill: the bucket-padded prompt (B, Tb) through
    every block, its K/V written into ``[0, Tb)`` of the given ``(B, H,
    max_len, dh)`` caches, and the first new token sampled from the true
    last prompt position ``tp - 1``.  Returns ``run(params, prompt, tp,
    temperature, top_k, gen, caches) -> tok``."""
    H = c.n_heads
    dh = c.d_model // H
    scale = 1.0 / math.sqrt(dh)

    def run(params, prompt, tp, temperature, top_k, gen, caches):
        from ..serving.sampling import sample_logits

        B, Tb = prompt.shape
        dev = prompt.device
        h = _embed(params, prompt, torch.arange(Tb, device=dev), c.use_rope)
        for bp, (kc, vc) in zip(params["blocks"], caches):
            h, k, v = _block_prefill(bp, h, H, scale, c.use_rope, c.rope_base)
            kc[:, :, :Tb] = k
            vc[:, :, :Tb] = v
        return sample_logits(_logits(params, h[:, tp - 1:tp])[:, 0],
                             temperature, top_k, gen)

    return run


def _block_chunk_prefill(bp, h, k_cache, v_cache, slot, off, positions, H,
                         scale, rope=False, base=10000.0, k_scale=None,
                         v_scale=None):
    """Chunked-prefill block step of the slot-layout engine: ONE prompt
    chunk ``h`` (1, C, D) of the admitting slot ``slot`` (a host int, or
    the engine's one-element device index), caches (S, H, L, dh),
    ``positions = off + arange(C)`` on the device (``off``, the
    reference's argument, is not read: the positions carry it).  Writes
    the chunk's K/V at ``positions`` of the slot's row first (an
    ``index_put``), then the chunk's queries attend over the whole row,
    read back with ``index_select`` (:func:`_chunk_attention`: flash
    with the ``(C, L)`` dense mask): no host scalar of the request
    enters, so the engine's step can be captured.  ``k_scale``/``v_scale`` (S,
    H, L): the quantized 4-leaf cache; the rows are quantized on write
    and attention is the reference's einsum with the scales folded in.
    Returns ``(h, k_cache, v_cache)``, plus the two scale caches when
    quantized, all updated in place."""
    q, k, v = _qkv(bp, h, H)
    if rope:
        q = apply_rope(q, positions=positions, base=base)
        k = apply_rope(k, positions=positions, base=base)
    if not torch.is_tensor(slot):
        slot = torch.full((1,), int(slot), device=positions.device)
    s, cols = slot.reshape(1).long(), positions.long()
    ksr = vsr = None
    if k_scale is not None:
        k, ks = _quantize_rows(k, k_scale.dtype, k_cache.dtype)  # (1,H,C)
        v, vs = _quantize_rows(v, v_scale.dtype, v_cache.dtype)
        k_scale[s, :, cols] = ks[0].transpose(0, 1)            # (C, H)
        v_scale[s, :, cols] = vs[0].transpose(0, 1)
        ksr, vsr = k_scale.index_select(0, s), v_scale.index_select(0, s)
    k_cache[s, :, cols] = k[0].transpose(0, 1).to(k_cache.dtype)  # (C,H,dh)
    v_cache[s, :, cols] = v[0].transpose(0, 1).to(v_cache.dtype)
    kr = k_cache.index_select(0, s)                         # (1,H,L,dh)
    vr = v_cache.index_select(0, s)
    ctx = _chunk_attention(q, kr, vr, positions, scale, ksr, vsr)
    return (_block_out(bp, h, ctx),) + _pack_kv(k_cache, v_cache, k_scale,
                                                v_scale)


def _block_chunk_prefill_paged(bp, h, k_pages, v_pages, page_row,
                               positions, H, scale, rope=False,
                               base=10000.0, k_scale=None, v_scale=None):
    """Chunked-prefill block step over the paged cache: the chunk's K/V
    scatter through the admitting slot's block-table row ``page_row``
    (Ps,), then attention gathers the row back under the ``(C, L)`` mask
    ``col <= position`` (:func:`_chunk_attention`).  Chunk positions
    past the request's pages land in NULL page 0, which no query
    attends.  Float rows reach attention in the pool's dtype, as in
    the reference (float32 pages under a bf16 policy are not rounded to
    bf16).  ``k_scale``/``v_scale`` (N, H, P): the
    quantized 4-leaf pool, quantized on write.  Returns ``(h, k_pages,
    v_pages)``, plus the two scale pools when quantized."""
    q, k, v = _qkv(bp, h, H)
    if rope:
        q = apply_rope(q, positions=positions, base=base)
        k = apply_rope(k, positions=positions, base=base)
    P = k_pages.shape[2]
    phys = page_row.long()[positions // P]                   # (C,)
    offs = positions % P
    ksr = vsr = None
    if k_scale is not None:
        k, ks = _quantize_rows(k, k_scale.dtype, k_pages.dtype)  # (1,H,C)
        v, vs = _quantize_rows(v, v_scale.dtype, v_pages.dtype)
        k_scale[phys, :, offs] = ks[0].transpose(0, 1)
        v_scale[phys, :, offs] = vs[0].transpose(0, 1)
        ksr = _gather_page_scales(k_scale, page_row)[None]   # (1,H,L)
        vsr = _gather_page_scales(v_scale, page_row)[None]
    k_pages[phys, :, offs] = k[0].permute(1, 0, 2).to(k_pages.dtype)
    v_pages[phys, :, offs] = v[0].permute(1, 0, 2).to(v_pages.dtype)
    kr = _gather_pages(k_pages, page_row)[None]              # (1,H,L,dh)
    vr = _gather_pages(v_pages, page_row)[None]
    ctx = _chunk_attention(q, kr, vr, positions, scale, ksr, vsr)
    return (_block_out(bp, h, ctx),) + _pack_kv(k_pages, v_pages, k_scale,
                                                v_scale)


def _decode_qkv(bp, h, H, dpos, rope, base):
    """A one-token step's q (S, H, 1, dh) and this token's K/V rows (S, H,
    dh), rotated at each slot's own position with rope."""
    q, k1, v1 = _qkv(bp, h, H)
    if rope:
        q = _rope_rows(q, dpos, base)
        k1 = _rope_rows(k1, dpos, base)
    return q, k1[:, :, 0], v1[:, :, 0]


def _block_decode_slots(bp, h, k_cache, v_cache, pos, H, scale, rope=False,
                        base=10000.0, k_scale=None, v_scale=None):
    """One-token step over the slot batch with per-slot positions: ``h``
    (S, 1, D), caches (S, H, L, dh), ``pos`` (S,); also ``generate``'s
    step, every row at one position.  Each slot writes its K/V at its
    ``pos`` first, then attends over its whole row under ``col <= pos``,
    the reference's einsum.  ``k_scale``/``v_scale`` (S, H, L): the quantized
    4-leaf cache; rows are quantized on write and the scales fold into
    the scores and the softmax weights.  Returns ``(h, k_cache,
    v_cache)``, plus the two scale caches when quantized, all updated in
    place."""
    q, k1, v1 = _decode_qkv(bp, h, H, pos, rope, base)
    rows = torch.arange(pos.shape[0], device=pos.device)
    cols = pos.long()
    if k_scale is not None:
        k1, k1s = _quantize_rows(k1, k_scale.dtype, k_cache.dtype)  # (S,H)
        v1, v1s = _quantize_rows(v1, v_scale.dtype, v_cache.dtype)
        k_scale[rows, :, cols] = k1s
        v_scale[rows, :, cols] = v1s
    k_cache[rows, :, cols] = k1.to(k_cache.dtype)
    v_cache[rows, :, cols] = v1.to(v_cache.dtype)
    s = torch.einsum("bhtd,bhsd->bhts", q,
                     k_cache.to(q.dtype)) * scale           # (S,H,1,L)
    if k_scale is not None:
        s = s * k_scale.to(s.dtype)[:, :, None, :]
    L = k_cache.shape[2]
    mask = torch.where(torch.arange(L, device=pos.device)[None]
                       <= pos[:, None], 0.0, -1e9)          # (S, L)
    w = torch.softmax(s + mask.to(s.dtype)[:, None, None], dim=-1)
    if k_scale is not None:
        w = w * v_scale.to(w.dtype)[:, :, None, :]
    ctx = torch.einsum("bhts,bhsd->bhtd", w, v_cache.to(w.dtype))
    return (_block_out(bp, h, ctx),) + _pack_kv(k_cache, v_cache, k_scale,
                                                v_scale)


def _block_decode_slots_paged(bp, h, k_pages, v_pages, table, dpos, active,
                              H, scale, rope=False, base=10000.0,
                              k_scale=None, v_scale=None):
    """One-token step over the slot batch with paged K/V.  An active slot
    appends into ``table[s, pos // P]`` at offset ``pos % P``; an
    inactive one parks its write at page 0's last offset (its table row
    may be stale and must never be written through).  Attention runs
    through the paged decode kernel.  ``k_scale``/``v_scale`` (N, H, P):
    the quantized 4-leaf pool — the rows are quantized on write and the
    kernel's int8 variant folds the scales in.  Returns ``(h, k_pages,
    v_pages)``, plus the two scale pools when quantized."""
    q, k1, v1 = _decode_qkv(bp, h, H, dpos, rope, base)
    P = k_pages.shape[2]
    S = dpos.shape[0]
    rows = torch.arange(S, device=dpos.device)
    phys = torch.where(active, table[rows, (dpos // P).long()], 0).long()
    offs = torch.where(active, dpos % P, P - 1).long()
    if k_scale is not None:
        k1, k1s = _quantize_rows(k1, k_scale.dtype, k_pages.dtype)  # (S,H)
        v1, v1s = _quantize_rows(v1, v_scale.dtype, v_pages.dtype)
        k_scale[phys, :, offs] = k1s
        v_scale[phys, :, offs] = v1s
    k_pages[phys, :, offs] = k1.to(k_pages.dtype)
    v_pages[phys, :, offs] = v1.to(v_pages.dtype)
    ctx = paged_decode_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                                 table, dpos, sm_scale=scale,
                                 k_scales=k_scale, v_scales=v_scale)
    return (_block_out(bp, h, ctx[:, :, None]),) + _pack_kv(
        k_pages, v_pages, k_scale, v_scale)


def _finish_iteration(params, h, tok, pos, active, temps, top_ks, gens,
                      limits, stops):
    """The tail every slot decode iteration shares: logits, sampling and
    the on-device finish predicate (stop token, token budget, non-finite
    logits, whose rows emit ``NONFINITE_TOKEN``).  An inactive slot
    freezes its token and position.  Returns ``(nxt, new_pos,
    new_active)``."""
    from ..serving.sampling import sample_logits_per_row

    logits = _logits(params, h)[:, 0]                   # (S, V)
    ok = torch.isfinite(logits).all(dim=-1)             # poison probe
    samp = sample_logits_per_row(logits, temps, top_ks, gens)
    samp = torch.where(ok, samp, NONFINITE_TOKEN)
    nxt = torch.where(active, samp, tok)
    new_pos = torch.where(active, pos + 1, pos)
    stop_hit = (nxt[:, None] == stops).any(dim=-1)
    return nxt, new_pos, active & ok & ~stop_hit & (new_pos < limits)


def decode_slots_iteration(params, caches, tok, pos, active, temps, top_ks,
                           gens, limits, stops, *, H, scale, rope=False,
                           base=10000.0):
    """One decode iteration over every slot of the slot-layout cache:
    embed, the slot decode blocks, then :func:`_finish_iteration`.  An
    inactive slot parks its write at ``L - 1`` of its own row, so a
    mid-horizon stop never touches committed K/V.  ``gens`` is a per-slot
    list of ``torch.Generator`` (None for greedy slots) or None, in
    place of the JAX per-slot keys.  ``caches`` holds one 2-leaf ``(k,
    v)`` or quantized 4-leaf tuple per layer.  Returns ``(caches, nxt,
    new_pos, new_active)``."""
    L = caches[0][0].shape[2]
    dpos = torch.where(active, pos, L - 1)
    h = _embed(params, tok[:, None], dpos[:, None], rope)
    for bp, layer_kv in zip(params["blocks"], caches):
        kc, vc, ksc, vsc = _layer_kv(layer_kv)
        h = _block_decode_slots(bp, h, kc, vc, dpos, H, scale, rope, base,
                                k_scale=ksc, v_scale=vsc)[0]
    return (caches,) + _finish_iteration(params, h, tok, pos, active, temps,
                                         top_ks, gens, limits, stops)


def decode_slots_iteration_paged(params, pages, table, tok, pos, active,
                                 temps, top_ks, gens, limits, stops, *, H,
                                 scale, rope=False, base=10000.0, max_len):
    """One decode iteration over every slot of the paged cache: embed, the
    paged decode blocks, then :func:`_finish_iteration`.  ``gens`` as in
    :func:`decode_slots_iteration`; ``pages`` holds one 2-leaf ``(k, v)``
    or quantized 4-leaf ``(k, v, k_scale, v_scale)`` tuple per layer.
    Returns ``(pages, nxt, new_pos, new_active)``."""
    dpos = torch.where(active, pos, max_len - 1)
    h = _embed(params, tok[:, None], dpos[:, None], rope)
    for bp, layer_kv in zip(params["blocks"], pages):
        kp, vp, ksp, vsp = _layer_kv(layer_kv)
        h = _block_decode_slots_paged(bp, h, kp, vp, table, dpos, active, H,
                                      scale, rope, base, k_scale=ksp,
                                      v_scale=vsp)[0]
    return (pages,) + _finish_iteration(params, h, tok, pos, active, temps,
                                        top_ks, gens, limits, stops)
