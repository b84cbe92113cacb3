"""GPT of the port: training through the layer API and the decode path.
Counterpart: ``singa_tpu/models/gpt.py``.

Ported here: the configuration (``GPTConfig`` with ``use_flash`` and
``precision``, ``bucket_length``, the ``NONFINITE_TOKEN`` sentinel);
``GPTBlock`` (the pre-LN block with the erf-gelu FFN) and :class:`GPT`,
the port's :class:`~singa_tpu_torch.model.Model` with ``tok``, ``pos``
(absent with rope), ``blocks``, ``ln_f`` and ``head``, its ``forward``
and ``train_one_batch``; ``decode_params()``, the JAX decode pytree
built from those same parameters (``_build_decode_params``), float or
with every Linear quantized per output channel, so a model trained in
the port serves through the engine; the int8 quantization helpers
(``_quantize_rows``, ``_quantize_channels``); and the functional decode
pieces the paged serving engine runs — the chunked paged prefill block
(float pools: attention through the flash-attention kernel with the
``(C, L)`` dense mask; quantized pools: the reference's einsum with the
scales folded in) and the paged one-token decode block (attention
through the paged decode kernel, float or int8).  ``generate`` and the
slot decode paths belong to later slices.

Unlike JAX's functional updates, the page pools (and their scale pools)
are updated in place: each block writes its K/V rows into the pool
tensors it was handed and returns those same tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd, layer
from ..device import get_device
from ..layer import apply_rope
from ..model import Model
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..precision import dtype_name, resolve_dtype
from ..tensor import Tensor

__all__ = ["GPTConfig", "GPTBlock", "GPT", "bucket_length",
           "NONFINITE_TOKEN", "MIN_PREFILL_BUCKET", "seeded_decode_params",
           "decode_slots_iteration_paged"]

# Sentinel token emitted when a row's logits go non-finite; -1 is never a
# real token id, so the ordinary token fetch doubles as the poison probe.
NONFINITE_TOKEN = -1

# prompt lengths are padded up to the next power of two at least this
# large (the JAX package's prefill bucketing)
MIN_PREFILL_BUCKET = 16


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
        if precision not in (None, "float32"):
            raise NotImplementedError(
                f"precision={precision!r} belongs to the mixed-precision "
                f"slice of the port (ROADMAP.md queue 1, item 4)")
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
        # quantized decode trees, by (weight_dtype, scale_dtype) name:
        # (Linear weights, their version counters, tree)
        self._decode_quant: dict = {}

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
        mine = model.decode_params()
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
        shares storage with the layers' parameters.

        ``weight_dtype`` (int8): quantized serving — every Linear
        (q/k/v/o/f1/f2/head) stores a per-output-channel quantized ``W``
        plus a ``Ws`` scale row in ``scale_dtype``
        (:func:`_quantize_channels`); LayerNorms and embeddings stay
        float and shared.  The quantized tree is memoised per
        ``(weight_dtype, scale_dtype)`` and rebuilt once a Linear weight
        has been replaced or updated in place (training, ``set_states``):
        its tensors and their version counters key the memo."""
        self._materialize()
        if weight_dtype is None:
            return self._build_decode_params(None, None)
        wd, sd = resolve_dtype(weight_dtype), resolve_dtype(scale_dtype)
        key = (dtype_name(wd), dtype_name(sd))
        ws = [lay.W.data for lay in self._linears()]
        versions = [w._version for w in ws]
        hit = self._decode_quant.get(key)
        if hit is None or hit[1] != versions \
                or any(a is not b for a, b in zip(hit[0], ws)):
            hit = self._decode_quant[key] = (
                ws, versions, self._build_decode_params(wd, sd))
        return hit[2]

    def _linears(self):
        for blk in self.blocks:
            a = blk.attn
            yield from (a.Wq, a.Wk, a.Wv, a.Wo, blk.fc1, blk.fc2)
        yield self.head

    def _build_decode_params(self, weight_dtype, scale_dtype):
        def lin(lay):
            W, b = lay.W.data.detach(), lay.b.data.detach()
            if weight_dtype is None:
                return {"W": W, "b": b}
            Wq, Ws = _quantize_channels(W, scale_dtype, weight_dtype)
            return {"W": Wq, "Ws": Ws, "b": b}

        def ln(lay):
            return {"g": lay.scale.data.detach(), "b": lay.bias.data.detach()}

        blocks = []
        for blk in self.blocks:
            a = blk.attn
            blocks.append({
                "ln1": ln(blk.ln1), "ln2": ln(blk.ln2),
                "q": lin(a.Wq), "k": lin(a.Wk), "v": lin(a.Wv),
                "o": lin(a.Wo), "f1": lin(blk.fc1), "f2": lin(blk.fc2)})
        out = {"tok": self.tok.W.data.detach(), "lnf": ln(self.ln_f),
               "head": lin(self.head), "blocks": blocks}
        if self.pos is not None:
            out["pos"] = self.pos.W.data.detach()
        return out


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


def _block_chunk_prefill_paged(bp, h, k_pages, v_pages, page_row,
                               positions, H, scale, rope=False,
                               base=10000.0, k_scale=None, v_scale=None):
    """Chunked-prefill block step over the paged cache: the chunk's K/V
    scatter through the admitting slot's block-table row ``page_row``
    (Ps,), then attention gathers the row back under the ``(C, L)`` mask
    ``col <= position``.  Chunk positions past the request's pages land
    in NULL page 0, which no query attends.

    Float pools: attention runs through the flash-attention kernel; the
    gathered rows are cast to q's dtype first (exact for the bfloat16
    storage override — what the reference's einsum promotion computes).
    ``k_scale``/``v_scale`` (N, H, P): the quantized 4-leaf pool.  The
    rows are quantized on write (:func:`_quantize_rows`) and attention is
    the reference's own route, an einsum with the K scales folded into
    the scores and the V scales into the softmax weights: no kernel runs
    here, on the TPU either, so the flash kernel is not launched on the
    quantized path.  Returns ``(h, k_pages, v_pages)``, plus the two
    scale pools when quantized."""
    x = _ln(h, bp["ln1"])
    q, k, v = (_heads(_lin(x, bp[n]), H) for n in ("q", "k", "v"))
    if rope:
        q = apply_rope(q, positions=positions, base=base)
        k = apply_rope(k, positions=positions, base=base)
    P = k_pages.shape[2]
    phys = page_row.long()[positions // P]                   # (C,)
    offs = positions % P
    if k_scale is not None:
        k, ks = _quantize_rows(k, k_scale.dtype, k_pages.dtype)  # (1,H,C)
        v, vs = _quantize_rows(v, v_scale.dtype, v_pages.dtype)
        k_scale[phys, :, offs] = ks[0].transpose(0, 1)
        v_scale[phys, :, offs] = vs[0].transpose(0, 1)
    k_pages[phys, :, offs] = k[0].permute(1, 0, 2).to(k_pages.dtype)
    v_pages[phys, :, offs] = v[0].permute(1, 0, 2).to(v_pages.dtype)
    kr = _gather_pages(k_pages, page_row)[None].to(q.dtype)  # (1,H,L,dh)
    vr = _gather_pages(v_pages, page_row)[None].to(q.dtype)
    L = kr.shape[2]
    cols = torch.arange(L, device=positions.device)
    mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)  # (C, L)
    if k_scale is not None:
        ksr = _gather_page_scales(k_scale, page_row)[None]   # (1,H,L)
        vsr = _gather_page_scales(v_scale, page_row)[None]
        s = torch.einsum("bhtd,bhsd->bhts", q, kr) * scale
        s = s * ksr.to(s.dtype)[:, :, None, :]
        s = s + mask[None, None].to(s.dtype)
        w = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhts,bhsd->bhtd",
                           w * vsr.to(w.dtype)[:, :, None, :], vr)
    else:
        ctx = flash_attention(q.contiguous(), kr, vr, mask[None, None],
                              sm_scale=scale)
    B, _, C, dh = ctx.shape
    ctx = ctx.permute(0, 2, 1, 3).reshape(B, C, H * dh)
    h = h + _lin(ctx, bp["o"])
    f = F.gelu(_lin(_ln(h, bp["ln2"]), bp["f1"]))
    h = h + _lin(f, bp["f2"])
    return (h,) + _pack_kv(k_pages, v_pages, k_scale, v_scale)


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
    x = _ln(h, bp["ln1"])                                   # (S, 1, D)
    q = _heads(_lin(x, bp["q"]), H)                         # (S,H,1,dh)
    k1h = _heads(_lin(x, bp["k"]), H)
    if rope:
        q = _rope_rows(q, dpos, base)
        k1h = _rope_rows(k1h, dpos, base)
    k1 = k1h[:, :, 0]                                       # (S,H,dh)
    v1 = _heads(_lin(x, bp["v"]), H)[:, :, 0]
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
    ctx = ctx.reshape(S, 1, -1)                             # (S,1,H*dh)
    h = h + _lin(ctx, bp["o"])
    f = F.gelu(_lin(_ln(h, bp["ln2"]), bp["f1"]))
    h = h + _lin(f, bp["f2"])
    return (h,) + _pack_kv(k_pages, v_pages, k_scale, v_scale)


def decode_slots_iteration_paged(params, pages, table, tok, pos, active,
                                 temps, top_ks, gens, limits, stops, *, H,
                                 scale, rope=False, base=10000.0, max_len):
    """One decode iteration over every slot: embed, the paged decode
    blocks, logits, sampling, and the on-device finish predicate (stop
    token, token budget, non-finite logits).  ``gens`` is a per-slot
    list of ``torch.Generator`` (None for greedy slots) or None; it
    takes the place of the JAX per-slot keys.  ``pages`` holds one
    2-leaf ``(k, v)`` or quantized 4-leaf ``(k, v, k_scale, v_scale)``
    tuple per layer.  Returns ``(pages, nxt, new_pos, new_active)``."""
    from ..serving.sampling import sample_logits_per_row

    dpos = torch.where(active, pos, max_len - 1)
    h = _embed(params, tok[:, None], dpos[:, None], rope)
    for bp, layer_kv in zip(params["blocks"], pages):
        kp, vp, ksp, vsp = _layer_kv(layer_kv)
        h = _block_decode_slots_paged(bp, h, kp, vp, table, dpos, active, H,
                                      scale, rope, base, k_scale=ksp,
                                      v_scale=vsp)[0]
    logits = _logits(params, h)[:, 0]                   # (S, V)
    ok = torch.isfinite(logits).all(dim=-1)             # poison probe
    samp = sample_logits_per_row(logits, temps, top_ks, gens)
    samp = torch.where(ok, samp, NONFINITE_TOKEN)
    nxt = torch.where(active, samp, tok)
    new_pos = torch.where(active, pos + 1, pos)
    stop_hit = (nxt[:, None] == stops).any(dim=-1)
    new_active = active & ok & ~stop_hit & (new_pos < limits)
    return pages, nxt, new_pos, new_active
