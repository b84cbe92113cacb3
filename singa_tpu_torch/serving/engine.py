"""Continuous-batching serving engine: chunked prefill fused into the
decode step over a slot or a paged KV cache (with prefix sharing), and
device-resident scheduler state; or the monolithic baseline.
Counterpart: ``singa_tpu/serving/engine.py`` — the chunked engine with
one admission lane on either layout (``paged=True`` or ``False``) and
the monolithic engine (``chunked=False``, slots).

Chunked engine, per ``step()``:

* while an admission is in flight (or could start), one UNIFIED step:
  (a) one ``chunk_tokens`` prompt chunk for the admitting slot, its
  attention through the flash-attention kernel over the slot's whole
  row; (b) one decode token for every active slot, attention through
  the paged decode kernel (paged) or the reference's einsum over each
  slot's row (slots); (c) the admission commit, a masked write of the
  admitted slot's token/pos/active/sampling/limit/stops (and table row)
  into the device state;
* otherwise (steady-state decode), one HORIZON: ``decode_horizon``
  decode iterations back to back, emitting one ``(K, n_slots)`` int32
  token block.  The block is copied to pinned host memory behind the
  horizon's kernels and fetched one horizon later, so host-side
  emission overlaps the next horizon's device work.

The per-slot scheduler state (token, position, active mask,
temperature, top-k, token budget, stop row, and the block table when
paged) lives in device tensors updated in place; finish detection (stop
token, budget, non-finite logits) happens on the device and the host
replays the same predicate from the fetched tokens.  Steady-state decode
uploads nothing and fetches one block per horizon; an admission step
uploads one packed int32 array (chunk tokens, table row, stop row).
Both counts land in :class:`ServingMetrics` (``host_uploads`` /
``host_syncs``).

Monolithic engine (``chunked=False``, the reference's baseline): each
admission prefills the whole bucket-padded prompt into its slot in one
call (causal flash attention at B 1) and fetches the first token; each
step uploads the host-resident scheduler state, advances every slot one
token and fetches the tokens.  One sync an admission and one a step;
``decode_horizon`` is 1.

Where the JAX package compiles a pinned set of programs, the port
captures each step as a CUDA graph on the card (the protocol of
:mod:`singa_tpu_torch._graphs`: a step's first call runs eagerly, its
second captures, later calls replay): the unified step
(``unified:C{C}``, with ``:paged`` and the quantization tags ``:kv8``,
``:w8`` as the reference labels its programs), the horizon
(``horizon:K{K}``; with ``decode_horizon=1`` its one-iteration graph
plays the step without an admission) and the monolithic decode step
(``decode``), each with a greedy twin and a ``:sampled`` one (a stream
of greedy requests draws no noise): at most 2 graphs a sampling mode
for the chunked engine and 1 for the monolithic one, whatever the mix
of prompt lengths.  ``trace_log`` lists the labels in order of first
use, on either device; ``graph_captures`` / ``graph_replays`` count by
kind (``unified``, ``horizon``, ``decode``; nothing on the CPU).  Every
per-request value of an admission (slot, write offset, last prompt
position, prompt length, temperature by its float32 bit pattern,
top-k, token budget, the commit flag) travels in the admission's one
packed int32 upload and is read on the device: the chunk half runs
every unified step, always computes its token, and the commit masks it
(no ``lax.cond`` and no Python branch); the decode half runs every
slot, an inactive one frozen.  A capture that fails raises.  The CPU
runs the same step functions eagerly; ``_capture=False`` (a check hook,
not a knob) runs them eagerly on the card too.

Sampling: a request's k-th token takes the k-th ``rand(V)`` draw of a
generator seeded with its seed, whatever its neighbours are (the port's
stand-in for the reference's per-slot keys).  The engine owns one
generator a slot and one for the admission's first token, registered
with every sampled graph, and every slot draws every iteration of a
sampled step (a greedy, free or prefilling slot's noise is discarded by
the ``torch.where`` that picks greedy rows): the admission generator and
the admitted slot's are re-seeded with the request's seed just before
the step that commits it, so its first token takes draw 0 and the
discarded decode draw of that step is draw 0 of the slot's generator,
and every later iteration, eager or replayed, advances it by one draw.
The monolithic prefill re-seeds its slot's generator and takes draw 0.

Quantized serving (``kv_dtype="int8"``, ``weight_dtype="int8"``, the
chunked engine on either layout) stores K/V as int8 rows with one scale
per (slot or page, head, position) and every decode Linear as int8 with
one scale per output channel; the dequant folds into the attention (the
paged decode kernel's int8 variant; the reference's einsum for the
prefill chunk and for slot decode) and into each matmul's output.
``kv_dtype="bfloat16"``/``"float32"`` is a plain storage override.  The
quality contract is the reference's: drift under its committed
tolerances against the float engine, and same-seed determinism — not a
bit-match.

Priorities, preemption and cancellation (the chunked engine): the
queue is ordered by ``submit(priority=)``, higher first and FIFO by rid
within a priority (all-default priorities keep the plain FIFO
schedule).  With ``preemption=True`` a queue head that cannot be
admitted preempts the running request of lowest priority below its
own: the victim's slot and pages are released, it re-queues ahead of
later arrivals at its priority, and it restores through the ordinary
chunked prefill of its prompt plus the tokens it already emitted (its
full prompt pages mapped from the prefix index on pages), finishing as
``PREEMPTED_RESTORED`` with the tokens of an uninterrupted run; a
sampled victim's restore starts both the admission's and its new
slot's generator from the state its old slot's generator had at the
preemption, so its draws continue where they stopped.  ``cancel(rid)``
ends a queued, prefilling or live request as ``CANCELLED``.  A live
slot is stopped on the device by one masked in-place write to the
device active mask (the "kill", one upload counted in
``host_kill_uploads``), issued on the engine's stream after the
pipelined horizons are drained and before the next step, so the slot
writes nothing more before its rows or pages reach a new owner; while
a kill is pending or a preemption is wanted the engine leaves the
horizon.  The monolithic engine ignores ``preemption=True``, as the
reference does.

Admission control (the reference's): ``submit(deadline_ms=)`` (chunked
engine) sets a completion deadline on the metrics clock; a sweep after
the pipelined horizons are drained and before any preemption or
admission ends every overdue request ``EVICTED_DEADLINE``, queued, in
prefill or live (a live one through the kill above), and an overdue
request leaves the horizon as a pending kill does.  ``max_queue=``
bounds the queue: a full queue sheds its lowest-priority, newest request
for an arrival that outranks it and otherwise refuses the arrival, both
``REJECTED`` (``submit`` still returns the rid).  ``step_budget_ms=``
times each step on the metrics clock: a slow step strikes the in-flight
admission, which ends ``FAILED`` after more than ``max_slow_steps``
strikes.  ``evacuate()`` strands every request of an engine taken as
lost and ``adopt(req)`` re-queues one on another engine, its emitted
tokens replayed through the restore path.  A raising ``on_token`` or
``on_done`` is counted in ``callback_errors`` and never stops the
engine.  Every terminal closes the request's record in the engine's
:class:`~singa_tpu_torch.telemetry.FlightRecorder` with the cause the
reference names (:meth:`ServingEngine.postmortem`).

Telemetry and fault injection (the reference's): ``tracer=`` (else the
process-global ``telemetry.tracer.current()``) or :meth:`attach_tracer`
records each request's lifecycle on its lane of the requests process
(``queued``, ``admitted``, ``prefill_chunk`` spans, ``first_token`` with
its TTFT, ``token``, ``preempted``, ``terminal`` and a ``req<rid>``
span over its life) and one span a step on the host lane
(``unified_step``, ``decode_horizon``, ``mono_step``), every time on the
metrics clock.  The probes are host code around ``_run``, never inside
a step function, so a tracer adds no graph key, upload or sync; a
horizon's span covers its enqueue and the previous block's fetch.  The
reference's roofline/MFU gauges under a tracer wait for
``telemetry/profiling.py`` (ROADMAP.md queue 1, item 12).
``faults=`` (a :class:`~singa_tpu_torch.serving.faults.FaultPlan`, the
chunked engine) threads the plan's seams through the engine: admission
attempts the allocator refuses, tokens delivered as the non-finite
sentinel (an injected one ends its request ``FAILED`` through the kill,
since the device row is still live), latency at the top of a step, and
``on_token`` deliveries dropped.  Each fired fault lands in the plan's
``events``, on the tracer and in the flight recorder, and every
casualty's postmortem on ``plan.postmortems``.  The fleet faults wait
for ``serving/sharded.py`` (item 12).

Constructor arguments that select other engines or features raise
``NotImplementedError`` naming the ROADMAP.md slice that will port them.
The defaults differ from the reference's (``paged=False,
admit_lanes=2, preemption=True`` there): the port's are ``paged=True,
admit_lanes=1, preemption=False`` until multi-lane admission is ported,
which flips them together.
"""

from __future__ import annotations

import enum
import itertools
import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _graphs
from .. import precision as _precision
from ..device import resolve_device
from ..models import gpt as _gpt
from ..telemetry import tracer as _trace
from ..telemetry.flight import FlightRecorder
from .kv_cache import DEFAULT_PAGE_TOKENS, PagedKVCache, SlotKVCache
from .metrics import ServingMetrics
from .sampling import SamplingParams, sample_logits, sample_logits_per_row

__all__ = ["Request", "RequestStatus", "TERMINAL_STATUSES",
           "ServingEngine", "EngineStalledError", "DEFAULT_CHUNK_TOKENS",
           "DEFAULT_DECODE_HORIZON", "DEFAULT_STALL_LIMIT",
           "MAX_STOP_TOKENS"]

# Per-step prompt-chunk size of the unified step.
DEFAULT_CHUNK_TOKENS = 64

# Decode iterations per horizon (1 disables the horizon).
DEFAULT_DECODE_HORIZON = 8

# Width of the device-resident per-slot stop-token row (padded with -1,
# which is never a real token id).
MAX_STOP_TOKENS = 8

# run() raises EngineStalledError after this many consecutive steps
# with no observable scheduler progress.
DEFAULT_STALL_LIMIT = 512

_SLICES = {
    11: "speculative and multi-lane decoding",
    12: "the rest of the framework: tensor parallel, disaggregated "
        "serving and the analysis passes",
}


def _not_ported(what: str, slice_no: int):
    raise NotImplementedError(
        f"{what} is not ported yet: it belongs to ROADMAP.md queue 1, "
        f"slice {slice_no} ({_SLICES[slice_no]})")


class RequestStatus(str, enum.Enum):
    """Lifecycle of a submitted request.  QUEUED, RUNNING and PREEMPTED
    are transient (a
    preempted request re-queues at once and reads QUEUED while it
    waits, as in the reference); the rest are terminal: a request
    reaches exactly one, and ``on_done(rid, status)`` fires then.
    ``done`` (and a place in
    :meth:`ServingEngine.results`) is kept for the two that produced a
    whole output: COMPLETED and PREEMPTED_RESTORED (completed after at
    least one preemption)."""
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    PREEMPTED = "PREEMPTED"
    COMPLETED = "COMPLETED"
    REJECTED = "REJECTED"
    EVICTED_DEADLINE = "EVICTED_DEADLINE"
    PREEMPTED_RESTORED = "PREEMPTED_RESTORED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


TERMINAL_STATUSES = frozenset({
    RequestStatus.COMPLETED, RequestStatus.REJECTED,
    RequestStatus.EVICTED_DEADLINE, RequestStatus.PREEMPTED_RESTORED,
    RequestStatus.FAILED, RequestStatus.CANCELLED})


class EngineStalledError(RuntimeError):
    """run() saw no scheduler progress for ``stall_limit`` steps."""


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    params: SamplingParams
    stop_tokens: frozenset
    on_token: object = None
    tokens: list = field(default_factory=list)
    done: bool = False
    priority: int = 0
    deadline_t: float | None = None    # absolute, on the metrics clock
    on_done: object = None
    status: RequestStatus = RequestStatus.QUEUED
    preemptions: int = 0
    # the state of the victim slot's generator at the last preemption
    # (the reference's ``restore_key``): a restore's first draws start
    # from it
    restore_state: torch.Tensor | None = None
    slow_strikes: int = 0              # over-budget steps in admission


@dataclass
class _Prefill:
    """Host-side state of the in-flight chunked admission.  ``prompt``
    and ``n_new`` are the effective values: for a restore, the prompt
    followed by the tokens already emitted, and the budget left."""
    req: Request
    slot: int
    off: int                    # next chunk starts here
    prompt: np.ndarray
    n_new: int


# the per-request scalars at the end of an admission's packed int32 array
# (temperature by its float32 bit pattern)
_ADM_SCALARS = ("slot", "woff", "p_last", "p_len", "temp", "top_k", "limit",
                "commit")


def _decode_iteration(params, caches, st, gens, H, scale, rope, base,
                      max_len):
    """One decode iteration of every slot on the engine's layout (paged
    when the state carries a block table), the state updated in place;
    returns the iteration's tokens ``(S,)``."""
    if "table" in st:
        _, nxt, new_pos, new_active = _gpt.decode_slots_iteration_paged(
            params, caches, st["table"], st["tok"], st["pos"], st["active"],
            st["temp"], st["topk"], gens, st["limit"], st["stops"], H=H,
            scale=scale, rope=rope, base=base, max_len=max_len)
    else:
        _, nxt, new_pos, new_active = _gpt.decode_slots_iteration(
            params, caches, st["tok"], st["pos"], st["active"], st["temp"],
            st["topk"], gens, st["limit"], st["stops"], H=H, scale=scale,
            rope=rope, base=base)
    st["tok"].copy_(nxt)
    st["pos"].copy_(new_pos)
    st["active"].copy_(new_active)
    return nxt


def _make_unified_step(cfg, C, Ps, max_len):
    """The unified step (port of the JAX ``_make_unified_step`` and
    ``_make_unified_step_paged`` with one lane): (a) one prompt chunk of
    the admitting slot and its first new token, sampled from the true
    last prompt position; (b) one decode iteration of every slot; (c)
    the masked admission commit.  ``buf`` is the admission's packed
    int32 array on the device: the chunk's C tokens, the slot's ``Ps``
    block-table entries (paged; ``Ps == 0`` for slots), its stop row and
    the scalars ``_ADM_SCALARS``.  ``st`` is the engine's device state,
    updated in place.  Nothing is read from the host, so the step can be
    captured: the chunk half always runs (a non-final chunk's token is
    masked out by the commit flag) and the decode half runs every slot
    (an inactive one frozen)."""
    rope, base = cfg.use_rope, cfg.rope_base
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.d_model // H)
    M = MAX_STOP_TOKENS

    def step(params, caches, st, gens, adm_gen, buf):
        toks = buf[:C]
        pages = buf[C:C + Ps] if Ps else None
        stops = buf[C + Ps:C + Ps + M]
        slot, woff, p_last, p_len, t_bits, top_k, limit, commit = (
            buf[C + Ps + M + i:C + Ps + M + i + 1]
            for i in range(len(_ADM_SCALARS)))
        temp = t_bits.view(torch.float32)
        # ---- (a) one prompt chunk for the admitting slot --------------
        positions = woff + torch.arange(C, device=buf.device)
        h = _gpt._embed(params, toks[None], positions, rope)
        for bp, layer_kv in zip(params["blocks"], caches):
            kc, vc, ksc, vsc = _gpt._layer_kv(layer_kv)
            if pages is not None:
                h = _gpt._block_chunk_prefill_paged(
                    bp, h, kc, vc, pages, positions, H, scale, rope, base,
                    k_scale=ksc, v_scale=vsc)[0]
            else:
                h = _gpt._block_chunk_prefill(
                    bp, h, kc, vc, slot, None, positions, H, scale, rope,
                    base, k_scale=ksc, v_scale=vsc)[0]
        # the final chunk's first new token, from the TRUE last prompt
        # position
        lg = _gpt._logits(params, h.index_select(1, p_last.long()))[:, 0]
        tok1 = sample_logits_per_row(
            lg, temp, top_k, None if adm_gen is None else [adm_gen])
        tok1 = torch.where(torch.isfinite(lg).all(), tok1,
                           _gpt.NONFINITE_TOKEN)            # poison probe

        # ---- (b) advance every active decode slot one token -----------
        # on the PRE-commit mask: the admitted slot goes live next step
        _decode_iteration(params, caches, st, gens, H, scale, rope, base,
                          max_len)

        # ---- (c) commit the finished admission into slot state --------
        S = st["tok"].shape[0]
        oh = (torch.arange(S, device=buf.device) == slot) & (commit != 0)
        live = (tok1 >= 0) & ~(tok1 == stops).any() & (p_len < limit)
        st["tok"].copy_(torch.where(oh, tok1, st["tok"]))
        st["pos"].copy_(torch.where(oh, p_len, st["pos"]))
        st["active"].copy_(torch.where(oh, live, st["active"]))
        st["temp"].copy_(torch.where(oh, temp, st["temp"]))
        st["topk"].copy_(torch.where(oh, top_k, st["topk"]))
        st["limit"].copy_(torch.where(oh, limit, st["limit"]))
        st["stops"].copy_(torch.where(oh[:, None], stops[None],
                                      st["stops"]))
        if pages is not None:
            st["table"].copy_(torch.where(oh[:, None], pages[None],
                                          st["table"]))

    return step


def _make_horizon_step(cfg, K, max_len):
    """The decode horizon (port of ``_make_horizon_step`` and
    ``_make_horizon_step_paged``): K iterations of the unified step's
    decode body, the block table (when paged) a loop invariant; returns
    the ``(K, S)`` int32 token block."""
    rope, base = cfg.use_rope, cfg.rope_base
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.d_model // H)

    def horizon(params, caches, st, gens):
        return torch.stack([
            _decode_iteration(params, caches, st, gens, H, scale, rope,
                              base, max_len)
            for _ in range(K)])                          # (K, S)

    return horizon


def _make_decode_step(cfg):
    """The monolithic engine's decode step (port of
    ``_make_decode_step``): every slot advances one token at its own
    position, the slot decode blocks writing each slot's K/V at its
    ``pos`` (a free slot writes into its own row, which its next
    occupant's prefill overwrites).  Returns ``(nxt, new_pos)``; no
    finish predicate on the device (the host decides)."""
    rope, base = cfg.use_rope, cfg.rope_base
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.d_model // H)

    def step(params, caches, toks, pos, active, temps, top_ks, gens):
        h = _gpt._embed(params, toks[:, None], pos[:, None], rope)
        for bp, (kc, vc) in zip(params["blocks"], caches):
            h = _gpt._block_decode_slots(bp, h, kc, vc, pos, H, scale, rope,
                                         base)[0]
        logits = _gpt._logits(params, h)[:, 0]             # (S, V)
        samp = sample_logits_per_row(logits, temps, top_ks, gens)
        return (torch.where(active, samp, toks),
                torch.where(active, pos + 1, pos))

    return step


def _make_prefill(cfg):
    """The monolithic engine's prefill (port of ``_make_prefill``): the
    bucket-padded prompt (1, Tb) through every block (causal flash
    attention), its K/V written into row ``[0, Tb)`` of the request's
    slot, and the first new token sampled from the true last prompt
    position ``tp - 1``.  Returns the token, on the device."""
    rope, base = cfg.use_rope, cfg.rope_base
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.d_model // H)

    def prefill(params, caches, prompt, tp, slot, temp, top_k, gen):
        Tb = prompt.shape[1]
        positions = torch.arange(Tb, device=prompt.device)
        h = _gpt._embed(params, prompt, positions, rope)     # (1,Tb,D)
        for bp, (kc, vc) in zip(params["blocks"], caches):
            h, k, v = _gpt._block_prefill(bp, h, H, scale, rope, base)
            kc[slot, :, :Tb] = k[0].to(kc.dtype)
            vc[slot, :, :Tb] = v[0].to(vc.dtype)
        lg = _gpt._logits(params, h[:, tp - 1:tp])[:, 0]    # (1, V)
        return sample_logits(lg, temp, top_k, gen)[0]

    return prefill


class ServingEngine:
    """Multiplex many generation requests through one model::

        eng = ServingEngine(model, n_slots=8)        # model: port GPT
        rid = eng.submit(prompt, max_new_tokens=32, stop_tokens=(eos,))
        results = eng.run()                          # or: while eng.step()
        tokens = results[rid]          # np.int32, stop token included

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain versions of the kernels on the
    CPU.  ``paged``, ``chunked``, ``min_bucket`` and ``admit_lanes``
    keep the JAX names; ported are the chunked engine on pages
    (``paged=True``, the port's default) or slots (``paged=False``) with
    one admission lane, and the monolithic engine (``chunked=False,
    paged=False``; ``min_bucket`` is its smallest prefill bucket).
    ``kv_dtype`` (``"int8"`` quantizes; ``"bfloat16"``/``"float32"``
    override the cache's storage dtype), ``weight_dtype`` (``"int8"``)
    and ``scale_dtype`` (bfloat16 or float32) are the reference's
    quantized-serving arguments (see the module docstring).
    ``preemption=True`` (chunked engine), ``submit(priority=)``,
    :meth:`cancel` and :meth:`statuses` are the reference's, and so are
    the admission controls ``max_queue``, ``step_budget_ms``,
    ``max_slow_steps``, ``submit(deadline_ms=)``, :meth:`evacuate`,
    :meth:`adopt` and the flight recorder (``flight_events``,
    ``flight_retain``, :meth:`postmortem`; see the module docstring).
    ``tracer`` (and :meth:`attach_tracer`) records the reference's
    request spans; ``faults`` (chunked engine) takes a ``FaultPlan``
    (see the module docstring).
    On the card the steps run as CUDA graphs;
    ``_capture=False`` is a check hook that runs them eagerly there (the
    twin a check holds the graphs against), not a setting.
    """

    def __init__(self, model, n_slots: int = 8, max_len: int | None = None,
                 min_bucket: int = _gpt.MIN_PREFILL_BUCKET,
                 chunked: bool = True,
                 chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
                 decode_horizon: int = DEFAULT_DECODE_HORIZON,
                 paged: bool = True,
                 page_tokens: int = DEFAULT_PAGE_TOKENS,
                 kv_pages: int | None = None,
                 prefix_cache: bool = True,
                 admit_lanes: int = 1,
                 prefill_only: bool = False,
                 speculative: bool = False,
                 max_queue: int | None = None,
                 preemption: bool = False,
                 step_budget_ms: float | None = None,
                 max_slow_steps: int = 3,
                 stall_limit: int = DEFAULT_STALL_LIMIT,
                 faults=None,
                 tracer=None,
                 flight_events: int = FlightRecorder.DEFAULT_PER_REQUEST,
                 flight_retain: int = FlightRecorder.DEFAULT_RETAIN,
                 tp_degree: int = 1,
                 kv_dtype=None,
                 weight_dtype=None,
                 scale_dtype=torch.bfloat16,
                 clock=None,
                 device=None,
                 _capture: bool = True):
        self.device = dev = resolve_device(device)
        if int(admit_lanes) != 1:
            _not_ported(f"admit_lanes={admit_lanes}", 11)
        if speculative:
            _not_ported("speculative=True", 11)
        if int(tp_degree) != 1:
            _not_ported(f"tp_degree={tp_degree}", 12)
        if prefill_only:
            _not_ported("prefill_only=True", 12)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.step_budget_s = (None if step_budget_ms is None
                              else float(step_budget_ms) / 1e3)
        self.max_slow_steps = int(max_slow_steps)
        self.chunked, self.paged = bool(chunked), bool(paged)
        # the monolithic baseline has no restore path: it ignores the flag
        self.preemption = bool(preemption) and self.chunked
        if self.paged and not self.chunked:
            raise ValueError("paged=True requires the chunked engine (the "
                             "monolithic baseline keeps the slot layout)")
        # ---- quantized serving ----------------------------------------
        # kv_dtype: a plain float STORAGE override ("bfloat16"/"float32",
        # the drift oracle) or a quantization dtype ("int8"); fp8 raises
        kv_store = kvq = None
        if kv_dtype is not None:
            dt = _precision.resolve_dtype(kv_dtype)
            if dt in (torch.bfloat16, torch.float32):
                kv_store = dt
            else:
                kvq = dt
        self.policy = pol = _precision.Policy(
            kv_dtype=kvq, weight_dtype=weight_dtype,
            scale_dtype=scale_dtype, backend=dev.type)
        if pol.quantized and not self.chunked:
            raise ValueError("quantized serving requires the chunked "
                             "engine (the monolithic baseline stays float)")
        self.model = model
        self.cfg = cfg = model.config
        if max_len is not None and max_len > cfg.max_len:
            raise ValueError(f"max_len {max_len} exceeds model max_len "
                             f"{cfg.max_len}")
        self.max_len = max_len or cfg.max_len
        self.min_bucket = int(min_bucket)
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, "
                             f"got {chunk_tokens}")
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, "
                             f"got {decode_horizon}")
        if stall_limit < 1:
            raise ValueError(f"stall_limit must be >= 1, got {stall_limit}")
        self.chunk_tokens = min(int(chunk_tokens), self.max_len)
        # the horizon belongs to the unified-step engine; the monolithic
        # baseline keeps its per-token host loop
        self.decode_horizon = int(decode_horizon) if self.chunked else 1
        self.stall_limit = int(stall_limit)
        self.params = _to_device(model.decode_params(
            pol.weight_dtype, pol.scale_dtype), dev)
        dtype = kv_store or self.params["tok"].dtype
        H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        if self.paged:
            self.kv = PagedKVCache(cfg.n_layers, n_slots, H,
                                   int(page_tokens), dh, self.max_len,
                                   n_pages=kv_pages, dtype=dtype, device=dev,
                                   prefix_cache=prefix_cache,
                                   kv_dtype=pol.kv_dtype,
                                   scale_dtype=pol.scale_dtype)
            self.page_tokens = self.kv.page_tokens
        else:
            self.kv = SlotKVCache(cfg.n_layers, n_slots, H, self.max_len, dh,
                                  dtype, device=dev, kv_dtype=pol.kv_dtype,
                                  scale_dtype=pol.scale_dtype)
        self.metrics = (ServingMetrics(clock=clock) if clock is not None
                        else ServingMetrics())
        # always on: a few notes a request, what postmortem(rid) reads
        self.flight = FlightRecorder(per_request=flight_events,
                                     retain=flight_retain)
        # opt-in request spans: the given tracer, else the process-global
        # one (read between steps, never inside a captured one); the
        # reference's roofline/MFU gauges under a tracer wait for
        # telemetry/profiling.py (ROADMAP.md queue 1, item 12)
        self.tracer = tracer if tracer is not None else _trace.current()
        if faults is not None and not self.chunked:
            raise ValueError("fault injection requires the chunked "
                             "engine (the seams live in the unified "
                             "step path)")
        self._faults = faults
        if faults is not None:
            faults.bind(tracer=self.tracer, recorder=self.flight)
        self._step_idx = 0
        self._last_hz_occ = None           # last horizon block's fill
        self._any_deadline = False
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self._rid = itertools.count()
        S, C, M = n_slots, self.chunk_tokens, MAX_STOP_TOKENS
        self._slot_req: list[Request | None] = [None] * S
        # host MIRROR of the device active mask (chunked: trailing it by
        # at most one pipelined horizon; monolithic: the authority)
        self._active = np.zeros(S, bool)
        self._lane: _Prefill | None = None
        self._kill: set[int] = set()       # slots to stop on the device
        # the steps' graphs (the card), the labels in order of first use
        self._capture = bool(_capture) and _graphs.captures_on(dev)
        self._gc = _graphs.GraphCache()
        self.trace_log: list[str] = []
        self._qtag = (":paged" if self.paged else "") + (
            ":kv8" if pol.kv_dtype is not None else "") + (
            ":w8" if pol.weight_dtype is not None else "")
        # the engine's generators (see the module docstring)
        self._slot_gens = [torch.Generator(device=dev) for _ in range(S)]
        self._adm_gen = torch.Generator(device=dev)
        if not self.chunked:
            # the monolithic engine's host-resident scheduler state,
            # uploaded every step into the step's static input buffers
            self._tok = np.zeros(S, np.int32)
            self._pos = np.zeros(S, np.int32)
            self._temp = np.zeros(S, np.float32)
            self._topk = np.zeros(S, np.int32)
            self._mono_in = [torch.zeros(S, dtype=dt, device=dev) for dt in (
                torch.int32, torch.int32, torch.bool, torch.float32,
                torch.int32)]
            self._decode_fn = _make_decode_step(cfg)
            self._prefill_fn = _make_prefill(cfg)
            self._state_tensors = self._mono_in + _cache_tensors(
                self.kv.caches)
            return
        Ps = self.kv.pages_per_slot if self.paged else 0
        self._step_fn = _make_unified_step(cfg, C, Ps, self.max_len)
        self._horizon_fn = _make_horizon_step(cfg, self.decode_horizon,
                                              self.max_len)
        # the admission's packed int32 array on the device (the unified
        # step's input buffer), written by one upload an admission step
        self._adm_buf = torch.zeros(C + Ps + M + len(_ADM_SCALARS),
                                    dtype=torch.int32, device=dev)
        # the kill's upload: the slots that stay live (no graph reads it)
        self._keep_buf = torch.ones(S, dtype=torch.bool, device=dev)
        # the device-resident scheduler state: allocated once here (no
        # host copy: zeros/fill run on the device) and only ever updated
        # in place by the step and horizon functions
        self._dstate = {
            "tok": torch.zeros(S, dtype=torch.int32, device=dev),
            "pos": torch.zeros(S, dtype=torch.int32, device=dev),
            "active": torch.zeros(S, dtype=torch.bool, device=dev),
            "temp": torch.zeros(S, dtype=torch.float32, device=dev),
            "topk": torch.zeros(S, dtype=torch.int32, device=dev),
            "limit": torch.zeros(S, dtype=torch.int32, device=dev),
            "stops": torch.full((S, M), -1, dtype=torch.int32, device=dev),
        }
        if self.paged:
            self._dstate["table"] = torch.zeros(
                (S, self.kv.pages_per_slot), dtype=torch.int32, device=dev)
        self._hz_pending: list = []        # dispatched, unemitted blocks
        # the storage the graphs are bound to, checked before a replay
        self._state_tensors = [self._adm_buf] + list(
            self._dstate.values()) + _cache_tensors(self.kv.caches)

    # ---- the steps' graphs -----------------------------------------------
    @property
    def graph_captures(self) -> dict:
        return self._gc.captures

    @property
    def graph_replays(self) -> dict:
        return self._gc.replays

    def _state(self) -> tuple:
        return _graphs.addresses(self._state_tensors)

    def _run(self, kind, label, fn, args, generators=()):
        """``fn(*args)`` as the step ``label``: through its graph on the
        card (the first call eagerly, the second captures with
        ``generators`` registered, then replays; a graph whose state
        storage moved is captured again), eagerly on the CPU or for the
        eager twin.  Returns the step's output (a graph's own buffers on
        a replay)."""
        if label not in self.trace_log:
            self.trace_log.append(label)
        if not self._capture:
            return fn(*args)
        return self._gc.call((kind, label), self.device, fn, args,
                             self._state, generators=generators)

    def _sampled(self) -> bool:
        """Does a request in a slot, or the one being admitted, sample?
        (Selects the ``:sampled`` twin.)"""
        reqs = self._slot_req + ([self._lane.req] if self._lane else [])
        return any(r is not None and r.params.temperature > 0 for r in reqs)

    def _upload(self, dst, arr) -> None:
        """One host array into the device buffer ``dst``: through a
        pinned staging copy that the host does not wait for on the card
        (the pinned block is kept until the copy has run)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    # ---- submission ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               stop_tokens=(), on_token=None, priority: int = 0,
               deadline_ms: float | None = None, on_done=None) -> int:
        """Queue one generation request (higher ``priority`` first, FIFO
        within a priority); returns its rid.  Malformed requests raise
        ``ValueError``.  Overload is not a caller's fault: with
        ``max_queue`` set and the queue full, the lowest-priority,
        newest queued request is shed if this one outranks it, else this
        one is refused; the loser ends ``REJECTED`` (its ``on_done``
        fires) and ``submit`` still returns the rid.  ``deadline_ms`` is
        a completion deadline on the metrics clock, relative to now; a
        request still unfinished after it ends ``EVICTED_DEADLINE``."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.max_len:
            raise ValueError(f"prompt length {prompt.size} exceeds "
                             f"engine max_len {self.max_len}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(f"{prompt.size}+{max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if deadline_ms is not None and not self.chunked:
            raise ValueError("deadlines require the chunked engine (the "
                             "monolithic baseline has no eviction path)")
        if self.paged:
            need = self.kv.pages_needed(prompt.size + max_new_tokens)
            if need > self.kv.usable_pages:
                raise ValueError(
                    f"request needs {need} KV pages but the pool holds "
                    f"{self.kv.usable_pages} — it could never be admitted "
                    f"(raise kv_pages or page_tokens)")
        stops = frozenset(int(t) for t in (stop_tokens or ()))
        # the chunked engine's stop predicate is a fixed-width compare on
        # the device; the monolithic engine checks stops on the host
        if self.chunked and len(stops) > MAX_STOP_TOKENS:
            raise ValueError(f"at most {MAX_STOP_TOKENS} stop tokens per "
                             f"request, got {len(stops)}")
        req = Request(next(self._rid), prompt, int(max_new_tokens),
                      SamplingParams(float(temperature), int(top_k or 0),
                                     int(seed)),
                      stops, on_token, priority=int(priority),
                      on_done=on_done)
        if deadline_ms is not None:
            req.deadline_t = self.metrics.now() + float(deadline_ms) / 1e3
            self._any_deadline = True
        self.requests[req.rid] = req
        t = self.metrics.now()
        self.metrics.record_submit(req.rid, t)
        self.flight.note(
            req.rid, "submit",
            f"prompt={prompt.size} max_new={max_new_tokens} "
            f"priority={req.priority}"
            + (f" deadline_ms={deadline_ms:g}" if deadline_ms else ""),
            t=t)
        if self.tracer is not None:
            self.tracer.instant("queued", t=t, tid=req.rid,
                                pid=_trace.PID_REQUESTS, cat="request")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # shed the lowest-priority (newest among equals) queued
            # request if this one outranks it, else refuse this one
            victim = min(self.queue, key=lambda r: (r.priority, -r.rid))
            if victim.priority < req.priority:
                self.queue.remove(victim)
                self._terminal(victim, RequestStatus.REJECTED,
                               cause="admission overload: shed for "
                                     f"higher-priority rid{req.rid}")
            else:
                self._terminal(req, RequestStatus.REJECTED,
                               cause="admission overload: queue full")
                return req.rid
        self._enqueue(req)
        return req.rid

    def _enqueue(self, req: Request) -> None:
        """Priority-ordered insert: higher priority first, FIFO (by rid)
        within a priority, so all-default priorities keep the FIFO
        schedule and a preempted request (old rid) re-queues ahead of
        later arrivals at its priority."""
        q = self.queue
        key = (-req.priority, req.rid)
        i = len(q)
        while i > 0 and (-q[i - 1].priority, q[i - 1].rid) > key:
            i -= 1
        q.insert(i, req)
        req.status = RequestStatus.QUEUED

    # ---- lifecycle -------------------------------------------------------
    def _terminal(self, req: Request, status: RequestStatus,
                  cause: str | None = None) -> None:
        """Move a request to its terminal status (once; a completion
        after a preemption is PREEMPTED_RESTORED), record it in the
        metrics, close its flight record with ``cause`` and the engine's
        state, and fire ``on_done`` (a raising one is counted, not
        propagated)."""
        if status is RequestStatus.COMPLETED and req.preemptions:
            status = RequestStatus.PREEMPTED_RESTORED
        req.status = status
        req.done = status in (RequestStatus.COMPLETED,
                              RequestStatus.PREEMPTED_RESTORED)
        now = self.metrics.now()
        # a cancelled request leaves the deadline population: the caller
        # abandoned the answer, the engine did not miss it
        had_deadline = (req.deadline_t is not None
                        and status is not RequestStatus.CANCELLED)
        self.metrics.record_terminal(
            status.value, len(req.tokens), req.done,
            req.deadline_t is None or now <= req.deadline_t, had_deadline)
        if cause is None:
            cause = ("completed after preemption/restore"
                     if status is RequestStatus.PREEMPTED_RESTORED
                     else status.value.lower())
        self.flight.close(
            req.rid, status.value, cause, t=now,
            tokens_emitted=len(req.tokens), preemptions=req.preemptions,
            last_horizon_occupancy=self._last_hz_occ,
            kv_bytes_live=self.kv.live_bytes(),
            page_utilization=self.kv.page_utilization(),
            queue_depth=len(self.queue))
        tr = self.tracer
        if tr is not None:
            args = {"status": status.value, "cause": cause,
                    "tokens": len(req.tokens)}
            tr.instant("terminal", t=now, tid=req.rid,
                       pid=_trace.PID_REQUESTS, cat="request", args=args)
            t_sub = self.metrics.submit_time(req.rid)
            if t_sub is not None:
                # one span over the request's whole life, on its lane
                tr.span(f"req{req.rid}", t_sub, now, tid=req.rid,
                        pid=_trace.PID_REQUESTS, cat="request", args=args)
        if self._faults is not None and not req.done:
            # a chaos run keeps every casualty's postmortem on the plan
            self._faults.postmortems.append(self.postmortem(req.rid))
        if req.on_done is not None:
            try:
                req.on_done(req.rid, status.value)
            except Exception:
                self.metrics.record_callback_error()

    def statuses(self) -> dict:
        """``{rid: status string}`` for every request ever submitted."""
        return {r.rid: r.status.value for r in self.requests.values()}

    def cancel(self, rid: int, cause: str | None = None) -> bool:
        """End ``rid`` as ``CANCELLED`` wherever it is: queued,
        mid-prefill, or live in a slot (after draining the pipelined
        horizons, so the mirrors are exact; the slot stops on the device
        before the next step).  Returns False for an unknown rid or one
        already terminal.  ``cause`` names it in the postmortem
        (default ``"cancelled by client"``); a cancel is never a
        deadline miss."""
        req = self.requests.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        cause = cause or "cancelled by client"
        if req in self.queue:
            self.queue.remove(req)
            self._terminal(req, RequestStatus.CANCELLED, cause=cause)
            return True
        if self._lane is not None and self._lane.req is req:
            self._abort_prefill(RequestStatus.CANCELLED, cause=cause)
            return True
        if req in self._slot_req:
            if self.chunked:
                self._drain_horizon()
            if req not in self._slot_req:   # the drained blocks ended it
                return req.status is RequestStatus.CANCELLED
            self._evict_running(self._slot_req.index(req),
                                RequestStatus.CANCELLED, cause=cause)
            return True
        return False

    def postmortem(self, rid: int):
        """The flight-recorder record of ``rid``: terminal status, the
        cause that ended it, its events, and the engine's state at the
        terminal (last horizon occupancy, KV bytes, page utilization,
        queue depth).  None for an unknown or dropped rid."""
        return self.flight.postmortem(rid)

    def publish_metrics(self, registry=None, **labels):
        """:attr:`metrics` into a telemetry ``MetricsRegistry`` (see
        :meth:`ServingMetrics.publish`); returns the registry."""
        return self.metrics.publish(registry, **labels)

    def attach_tracer(self, tracer) -> None:
        """Attach (or with None, detach) a span tracer on a live engine.
        Host-side only: no graph key, no upload and no sync is added;
        the warm graphs keep replaying, now with spans around them.  A
        fault plan's fired faults follow the tracer."""
        self.tracer = tracer
        if self._faults is not None:
            self._faults.bind(tracer=tracer, recorder=self.flight)

    def steady_state_arg_spec(self):
        """The contract of the reference's steady-state upload analysis
        pass."""
        _not_ported("steady_state_arg_spec", 12)

    # ---- evacuate and adopt ------------------------------------------------
    def evacuate(self, cause: str = "replica lost") -> list:
        """Strand every unfinished request of an engine taken as lost,
        for :meth:`adopt` on another: the pending horizon blocks are
        dropped (their tokens are recomputed by the adopter's restore),
        the queue, the admission and the slots are released, and each
        request's flight record closes ``REROUTED`` with ``cause``.
        Returns the stranded requests in rid order; the engine must not
        be stepped again."""
        if not self.chunked:
            raise ValueError("evacuate() requires the chunked engine")
        self._hz_pending.clear()
        stranded = list(self.queue)
        self.queue.clear()
        if self._lane is not None:
            pf, self._lane = self._lane, None
            self.kv.release(pf.slot)
            stranded.append(pf.req)
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                self._slot_req[slot] = None
                self.kv.release(slot)
                stranded.append(req)
        self._active[:] = False
        self._kill.clear()
        stranded.sort(key=lambda r: r.rid)
        t = self.metrics.now()
        for req in stranded:
            self.flight.note(req.rid, "evacuate", cause, t=t)
            self.flight.close(req.rid, "REROUTED", cause, t=t,
                              tokens_emitted=len(req.tokens))
        return stranded

    def adopt(self, req: Request) -> int:
        """Queue a request stranded by another engine's
        :meth:`evacuate` as a fresh one here (new rid, new flight
        record) with its prompt, budget, sampling, callbacks, priority,
        deadline and the tokens it already emitted; with tokens it
        restores through :meth:`_effective`'s replay, so greedy tokens
        equal an uninterrupted run's.  The lost slot's generator state
        is gone: a sampled restore draws from ``manual_seed(seed)``
        again.  Bypasses ``max_queue`` (the request was admitted once
        already).  Returns the new rid."""
        nr = Request(next(self._rid), req.prompt, req.max_new_tokens,
                     req.params, req.stop_tokens, req.on_token,
                     tokens=list(req.tokens), priority=req.priority,
                     deadline_t=req.deadline_t, on_done=req.on_done,
                     preemptions=req.preemptions + bool(req.tokens))
        if nr.deadline_t is not None:
            self._any_deadline = True
        self.requests[nr.rid] = nr
        t = self.metrics.now()
        self.metrics.record_submit(nr.rid, t)
        self.flight.note(
            nr.rid, "adopt",
            f"re-routed after replica loss with {len(nr.tokens)} "
            f"emitted tokens", t=t)
        if self.tracer is not None:
            self.tracer.instant("queued", t=t, tid=nr.rid,
                                pid=_trace.PID_REQUESTS, cat="request")
        self._enqueue(nr)
        return nr.rid

    def _emit(self, req: Request, tok: int, t) -> None:
        req.tokens.append(tok)
        first = len(req.tokens) == 1
        if first:
            self.metrics.record_first_token(req.rid, t)
        else:
            self.metrics.record_token(req.rid, t)
        tr = self.tracer
        if tr is not None:
            if first:
                t_sub = self.metrics.submit_time(req.rid)
                tr.instant("first_token", t=t, tid=req.rid,
                           pid=_trace.PID_REQUESTS, cat="request",
                           args=None if t_sub is None
                           else {"ttft_ms": round((t - t_sub) * 1e3, 3)})
            else:
                tr.instant("token", t=t, tid=req.rid,
                           pid=_trace.PID_REQUESTS, cat="request")
        if first:
            self.flight.note(req.rid, "first_token", f"tok={tok}", t=t)
        if req.on_token is not None and (
                self._faults is None or self._faults.deliver_callback(
                    req.rid, len(req.tokens) - 1)):
            try:
                req.on_token(req.rid, tok)
            except Exception:
                # a consumer's fault must not stop every other stream
                self.metrics.record_callback_error()

    def _filter(self, req: Request, tok: int):
        """``(tok, cause)``: the token as the fault plan delivers it,
        and the injection's cause when the plan poisoned it."""
        if self._faults is None:
            return tok, None
        ftok = self._faults.filter_token(req.rid, len(req.tokens), tok)
        if ftok == tok:
            return tok, None
        return ftok, f"injected fault: nan_logits at token {len(req.tokens)}"

    def _nonfinite(self, slot: int, where: str, cause) -> None:
        """End a slot whose token is the non-finite sentinel.  A real
        one (``cause`` None): the device already dropped the row.  An
        injected one is a host-side fact, the device row still live: it
        ends through the kill, so the slot stops before its rows or
        pages reach a new owner."""
        if cause is None:
            self._fail(slot, where)
        else:
            self._evict_running(slot, RequestStatus.FAILED, cause=cause)

    def _record_kv(self) -> None:
        kv = self.kv
        self.metrics.record_kv(kv.nbytes(), kv.live_bytes(),
                               kv.page_utilization())

    def _free_slot(self, slot: int) -> Request:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        self.kv.release(slot)
        return req

    def _maybe_finish(self, slot: int) -> None:
        """The host half of the finish predicate — the device's
        ``~stop_hit & (new_pos < limit)`` replayed in request terms."""
        req = self._slot_req[slot]
        if (len(req.tokens) >= req.max_new_tokens
                or req.tokens[-1] in req.stop_tokens):
            self._free_slot(slot)
            self.metrics.record_finish(req.rid)
            self._terminal(req, RequestStatus.COMPLETED)

    def _fail(self, slot: int, where: str) -> None:
        """Non-finite logits ``where`` (``"while decoding"``, ``"in
        prefill"``, ``"mid-horizon"``): the device already dropped the
        row from its active mask; release the slot and end the request
        FAILED."""
        req = self._free_slot(slot)
        self.flight.note(req.rid, "evict", f"slot={slot}",
                         t=self.metrics.now())
        self._terminal(req, RequestStatus.FAILED,
                       cause=f"nan watchdog: non-finite logits {where}")

    def _evict_running(self, slot: int, status: RequestStatus,
                       cause: str | None = None) -> None:
        """End a live slot's request on the host now and arm its kill
        (chunked engine): the slot stops on the device before the next
        step, so before any of its rows or pages can be granted again.
        The monolithic engine uploads its host mask every step."""
        req = self._free_slot(slot)
        if self.chunked:
            self._kill.add(slot)
        self.flight.note(req.rid, "evict", f"slot={slot}",
                         t=self.metrics.now())
        self._terminal(req, status, cause=cause)

    def _abort_prefill(self, status: RequestStatus,
                       cause: str | None = None) -> None:
        """Drop the in-flight admission before it went live: no kill,
        since the slot was never committed into the device active mask;
        whatever its chunks wrote, the next owner's prefill overwrites
        before it is attended."""
        pf, self._lane = self._lane, None
        self.kv.release(pf.slot)
        self._terminal(pf.req, status, cause=cause)

    def _apply_kill(self) -> bool:
        """Stop the armed slots on the device: one upload of the mask of
        slots that stay live and an in-place AND into the device active
        mask, on the engine's stream, so it runs after every step
        already issued and before every later one.  Returns whether a
        kill was issued."""
        if not self._kill:
            return False
        keep = np.ones(self.kv.n_slots, bool)
        keep[sorted(self._kill)] = False
        self._kill.clear()
        self._upload(self._keep_buf, keep)
        self._dstate["active"].logical_and_(self._keep_buf)
        self.metrics.record_kill_upload(1)
        return True

    # ---- deadlines ---------------------------------------------------------
    @staticmethod
    def _overdue(req: Request, now: float) -> bool:
        return req.deadline_t is not None and now > req.deadline_t

    def _sweep_deadlines(self) -> None:
        """End every request past its deadline ``EVICTED_DEADLINE``:
        queued, in prefill, or live (its kill armed).  Runs on drained
        mirrors."""
        if not self._any_deadline:
            return
        now = self.metrics.now()

        def cause(r, where):
            return (f"deadline exceeded while {where} "
                    f"(overdue {(now - r.deadline_t) * 1e3:.1f}ms)")

        for req in [r for r in self.queue if self._overdue(r, now)]:
            self.queue.remove(req)
            self._terminal(req, RequestStatus.EVICTED_DEADLINE,
                           cause=cause(req, "queued"))
        pf = self._lane
        if pf is not None and self._overdue(pf.req, now):
            self._abort_prefill(RequestStatus.EVICTED_DEADLINE,
                                cause=cause(pf.req, "in prefill"))
        for slot, req in enumerate(self._slot_req):
            if (req is not None and self._active[slot]
                    and self._overdue(req, now)):
                self._evict_running(slot, RequestStatus.EVICTED_DEADLINE,
                                    cause=cause(req, "decoding"))

    def _deadline_overdue(self) -> bool:
        """The horizon gate's probe: is a queued or live request past
        its deadline?  (It leaves the horizon so the sweep runs on
        drained mirrors.)"""
        now = self.metrics.now()
        return (any(self._overdue(r, now) for r in self.queue)
                or any(r is not None and self._overdue(r, now)
                       for r in self._slot_req))

    # ---- preemption --------------------------------------------------------
    def _preempt_victim(self):
        """The victim: lowest priority, then the most overdue, then the
        most recently admitted (its restore prefill is the shortest).
        ``(key, slot)`` or None."""
        best = None
        now = self.metrics.now() if self._any_deadline else 0.0
        for slot, req in enumerate(self._slot_req):
            if req is None or not self._active[slot]:
                continue
            over = (now - req.deadline_t if req.deadline_t is not None
                    else float("-inf"))
            key = (req.priority, -over, -req.rid)
            if best is None or key < best[0]:
                best = (key, slot)
        return best

    def _preemption_wanted(self) -> bool:
        """Does the queue head outrank a running request it cannot be
        admitted beside?"""
        if (not self.preemption or not self.queue
                or self._lane is not None):
            return False
        v = self._preempt_victim()
        if (v is None
                or self._slot_req[v[1]].priority >= self.queue[0].priority):
            return False
        return not self._admission_possible()

    def _maybe_preempt(self) -> None:
        """Free room for a higher-priority queue head by preempting
        running victims: keep the victim slot's generator state (the
        only device state a restore needs: the K/V is recomputed by the
        restore prefill), release its slot and pages, re-queue it and
        arm its kill.  Runs on drained mirrors."""
        while self._preemption_wanted():
            _, slot = self._preempt_victim()
            req = self._free_slot(slot)
            req.restore_state = self._slot_gens[slot].get_state()
            req.preemptions += 1
            self._kill.add(slot)
            req.status = RequestStatus.PREEMPTED
            self._enqueue(req)              # reads QUEUED while it waits
            self.metrics.record_preempt()
            t = self.metrics.now()
            self.flight.note(
                req.rid, "preempt",
                f"slot={slot} for rid{self.queue[0].rid} "
                f"after {len(req.tokens)} tokens", t=t)
            if self.tracer is not None:
                self.tracer.instant("preempted", t=t, tid=req.rid,
                                    pid=_trace.PID_REQUESTS, cat="request",
                                    args={"slot": slot})

    def _effective(self, req: Request):
        """``(prompt, n_new)`` as the admission sees them: a restore's
        prompt is followed by the tokens already emitted and its budget
        shrinks by them, so the ordinary chunked prefill reproduces the
        uninterrupted run (the limit is unchanged: (tp + k) + (n - k) -
        1 = tp + n - 1)."""
        if req.preemptions and req.tokens:
            return (np.concatenate(
                        [req.prompt, np.asarray(req.tokens, np.int32)]),
                    req.max_new_tokens - len(req.tokens))
        return req.prompt, req.max_new_tokens

    # ---- admission -------------------------------------------------------
    def _admission_possible(self) -> bool:
        """Could an admission start right now?  A free slot; on pages the
        queue HEAD must also fit (queue order is kept)."""
        if not self.queue:
            return False
        if not self.paged:
            return bool(self.kv.free_slots)
        prompt, n_new = self._effective(self.queue[0])
        return self.kv.can_admit(prompt,
                                 min(prompt.size + n_new, self.max_len))

    def _start_admission(self) -> None:
        """Grant the queue head a slot (and on pages its pages, mapping
        cached prefix pages: its prefill then starts at the first
        uncached position).  A restore admits its effective prompt (see
        :meth:`_effective`), so its prompt pages come from the prefix
        index."""
        if self._lane is not None or not self.queue:
            return
        if (self._faults is not None
                and not self._faults.admission_allowed()):
            return                      # injected allocator exhaustion
        req = self.queue[0]
        prompt, n_new = self._effective(req)
        if self.paged:
            adm = self.kv.admit(prompt,
                                min(prompt.size + n_new, self.max_len))
            if adm is None:
                return
            slot, cached = adm
            self.metrics.record_prefix(cached, prompt.size)
        else:
            slot, cached = self.kv.alloc(), 0
            if slot is None:
                return
        self.queue.popleft()
        self._lane = _Prefill(req, slot, cached, prompt, n_new)
        req.status = RequestStatus.RUNNING
        if req.preemptions:
            self.metrics.record_restore()
        t = self.metrics.now()
        self.metrics.record_admitted(req.rid, t=t)
        self.flight.note(
            req.rid, "admitted", f"slot={slot}"
            + (f" cached_prefix={cached}" if cached else "")
            + (f" restore#{req.preemptions}" if req.preemptions else ""),
            t=t)
        if self.tracer is not None:
            self.tracer.instant("admitted", t=t, tid=req.rid,
                                pid=_trace.PID_REQUESTS, cat="request")

    def _lane_chunk(self, pf: _Prefill):
        """Host-side view of the lane's current chunk:
        ``(woff, valid, last, chunk, p_last, limit, stops_row)``."""
        C = self.chunk_tokens
        tp = pf.prompt.size
        # clamp so the C-wide write fits [0, max_len): the final chunk of
        # a near-max_len prompt recomputes a few committed positions
        woff = min(pf.off, self.max_len - C)
        valid = min(tp - woff, C)
        last = pf.off + C >= tp
        chunk = np.zeros(C, np.int32)
        chunk[:valid] = pf.prompt[woff:woff + valid]
        limit = min(tp + pf.n_new - 1, self.max_len - 1)
        stops_row = np.full(MAX_STOP_TOKENS, -1, np.int32)
        for i, s in enumerate(sorted(pf.req.stop_tokens)):
            stops_row[i] = s
        p_last = tp - 1 - woff if last else C - 1
        return woff, valid, last, chunk, p_last, limit, stops_row

    def _admission_args(self):
        """Pack the unified step's admission arguments (the chunk, the
        table row on pages, the stop row and ``_ADM_SCALARS``, the
        temperature by its float32 bit pattern) and upload them into the
        step's input buffer: one upload.  Returns ``(pf, woff, valid,
        last)``."""
        pf = self._lane
        woff, valid, last, chunk, p_last, limit, stops_row = \
            self._lane_chunk(pf)
        # the admitted slot's block-table row, on pages: the chunk
        # scatters and gathers through it; the commit installs it
        row = (self.kv.table_row(pf.slot) if self.paged
               else np.zeros(0, np.int32))
        sp = pf.req.params
        t_bits = int(np.float32(sp.temperature).view(np.int32))
        scalars = np.array([pf.slot, woff, p_last, pf.prompt.size, t_bits,
                            sp.top_k, limit, int(last)], np.int32)
        packed = np.concatenate([chunk, row, stops_row, scalars]).astype(
            np.int32)
        self._upload(self._adm_buf, packed)
        self.metrics.record_upload(1)
        return pf, woff, valid, last

    def _decode_gens(self, sampled: bool):
        """The decode half's generators: every slot's for the sampled
        twin, None for the greedy one (no noise is drawn)."""
        return self._slot_gens if sampled else None

    # ---- steps -----------------------------------------------------------
    def _step_chunked(self) -> bool:
        K = self.decode_horizon
        # steady-state decode: no admission in flight and none could
        # start -> one horizon.  The mirrors trail the device by at most
        # one horizon; a stale positive costs one no-op horizon.  An
        # armed kill, a wanted preemption or an overdue deadline leaves
        # the horizon, so it cannot wait behind an endless stream of them.
        if (K > 1 and self._lane is None and self._active.any()
                and not self._kill
                and not self._admission_possible()
                and not self._preemption_wanted()
                and not (self._any_deadline and self._deadline_overdue())):
            return self._step_horizon()
        # the spans are host time on the metrics clock, around the
        # steps' graphs and never inside them
        tr = self.tracer
        ts0 = self.metrics.now() if tr is not None else 0.0
        self._drain_horizon()                  # mirrors exact from here
        self._sweep_deadlines()
        self._maybe_preempt()
        self._start_admission()
        # before any step that could hand a killed slot's rows or pages
        # to a new owner
        killed = self._apply_kill()
        n_dec = int(self._active.sum())
        if self._lane is None and n_dec and K > 1:
            return self._step_horizon()
        meta = None
        if self._lane is not None:
            meta = self._admission_args()
        total_valid = meta[2] if meta is not None else 0
        self.metrics.record_step(
            self.kv.active_slots, self.kv.n_slots, len(self.queue),
            used_tokens=total_valid + n_dec,
            budget_tokens=self.chunk_tokens + self.kv.n_slots)
        self._record_kv()
        if meta is None and n_dec == 0:
            return killed
        sampled = self._sampled()
        gens = self._decode_gens(sampled)
        tag = self._qtag + (":sampled" if sampled else "")
        if meta is None:
            # decode_horizon 1, nothing to admit: the one-iteration horizon
            block = self._run("horizon", f"horizon:K{K}{tag}",
                              self._horizon_fn,
                              (self.params, self.kv.caches, self._dstate,
                               gens), gens or ())
            row = block[0].cpu().numpy()                # THE step's sync
            self.metrics.record_sync()
        else:
            pf, _, _, last = meta
            if last:
                # the request's draws start at 0 on both generators; a
                # restore's where its old slot's generator stood
                rs = pf.req.restore_state
                for g in (self._adm_gen, self._slot_gens[pf.slot]):
                    if rs is None:
                        g.manual_seed(pf.req.params.seed)
                    else:
                        g.set_state(rs)
            self._run("unified", f"unified:C{self.chunk_tokens}{tag}",
                      self._step_fn,
                      (self.params, self.kv.caches, self._dstate, gens,
                       self._adm_gen if sampled else None, self._adm_buf),
                      gens + [self._adm_gen] if sampled else ())
            row = None
            if n_dec or last:
                row = self._dstate["tok"].cpu().numpy()  # THE step's sync
                self.metrics.record_sync()
        t = self.metrics.now()
        emitted = []
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            tok, cause = self._filter(req, int(row[slot]))
            if tok < 0:             # non-finite logits (real or injected)
                self._nonfinite(slot, "while decoding", cause)
                continue
            self._emit(req, tok, t)
            emitted.append(slot)
        for slot in emitted:
            self._maybe_finish(slot)
        if meta is not None:
            pf, _, _, last = meta
            if last:                    # prompt done: slot goes live
                slot, req = pf.slot, pf.req
                if self.paged:
                    self.kv.register_prefix(slot, req.prompt)
                self._lane = None
                self._slot_req[slot] = req
                self._active[slot] = True
                tok, cause = self._filter(req, int(row[slot]))
                if tok < 0:
                    self._nonfinite(slot, "in prefill", cause)
                else:
                    self._emit(req, tok, self.metrics.now())
                    self._maybe_finish(slot)
            else:
                pf.off += self.chunk_tokens
        if tr is not None:
            t1 = self.metrics.now()
            tr.span("unified_step", ts0, t1, cat="serve",
                    args={"decode_slots": n_dec,
                          "chunk_tokens": total_valid})
            if meta is not None:
                pf, woff, valid, _ = meta
                tr.span("prefill_chunk", ts0, t1, tid=pf.req.rid,
                        pid=_trace.PID_REQUESTS, cat="request",
                        args={"off": int(woff), "tokens": int(valid)})
        return True

    def _step_horizon(self) -> bool:
        """One horizon.  Depth-1 pipeline: this horizon is enqueued
        first, then the PREVIOUS horizon's block is fetched and
        emitted."""
        K = self.decode_horizon
        n_act = int(self._active.sum())
        tr = self.tracer
        ts0 = self.metrics.now() if tr is not None else 0.0
        self.metrics.record_step(self.kv.active_slots, self.kv.n_slots,
                                 len(self.queue), used_tokens=K * n_act,
                                 budget_tokens=K * self.kv.n_slots)
        self._record_kv()
        sampled = self._sampled()
        block = self._run(
            "horizon",
            f"horizon:K{K}{self._qtag}" + (":sampled" if sampled else ""),
            self._horizon_fn,
            (self.params, self.kv.caches, self._dstate,
             self._decode_gens(sampled)),
            self._slot_gens if sampled else ())
        self._hz_pending.append(_to_host_async(block))
        if len(self._hz_pending) > 1:
            self._emit_block(self._hz_pending.pop(0))
        if tr is not None:
            # the enqueue and the previous block's fetch: no sync of its own
            tr.span("decode_horizon", ts0, self.metrics.now(), cat="serve",
                    args={"K": K, "active": n_act})
        return True

    def _drain_horizon(self) -> None:
        """Fetch + emit every pipelined block; afterwards the host
        mirrors equal the device state."""
        while self._hz_pending:
            self._emit_block(self._hz_pending.pop(0))

    def _emit_block(self, pending) -> None:
        """Replay one fetched ``(K, S)`` block against the host mirrors:
        emit each iteration's token for the slots the mirror says were
        live, then apply the device's finish predicate."""
        host, event = pending
        if event is not None:
            event.synchronize()
        blk = host.numpy()                          # 1 sync per K
        self.metrics.record_sync()
        K, S = blk.shape
        t = self.metrics.now()
        emitted = 0
        for k in range(K):
            ok = []
            # a slot ended earlier in the block has left the mirror
            for slot in np.flatnonzero(self._active):
                req = self._slot_req[slot]
                tok, cause = self._filter(req, int(blk[k, slot]))
                if tok < 0:         # non-finite logits mid-horizon
                    self._nonfinite(slot, "mid-horizon", cause)
                    continue
                self._emit(req, tok, t)
                ok.append(slot)
            emitted += len(ok)
            for slot in ok:
                self._maybe_finish(slot)
        self.metrics.record_horizon(emitted, K, S)
        self._last_hz_occ = round(emitted / (K * S), 4)

    # ---- monolithic path (the baseline, chunked=False) ---------------------
    def _admit(self) -> int:
        """FIFO admission: prefill queued requests into free slots, one
        whole bucket-padded prompt a call, one sync each (the first
        token: the TTFT point)."""
        n = 0
        while self.queue and self.kv.free_slots:
            req = self.queue.popleft()
            slot = self.kv.alloc()
            tp = req.prompt.size
            Tb = _gpt.bucket_length(tp, self.max_len, self.min_bucket)
            padded = np.zeros((1, Tb), np.int32)
            padded[0, :tp] = req.prompt
            # the slot's generator: the prefill takes draw 0, the decode
            # steps (every slot draws) the next ones
            sp, gen = req.params, self._slot_gens[slot]
            gen.manual_seed(sp.seed)
            req.status = RequestStatus.RUNNING
            self.metrics.record_admitted(req.rid)
            tok = self._prefill_fn(
                self.params, self.kv.caches,
                torch.from_numpy(padded).to(self.device),
                tp, slot, sp.temperature, sp.top_k, gen)
            self.metrics.record_upload(1)
            tok = int(tok)                              # THE sync
            self.metrics.record_sync()
            self._slot_req[slot] = req
            self._tok[slot] = tok
            self._pos[slot] = tp
            self._active[slot] = True
            self._temp[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._emit(req, tok, self.metrics.now())
            self._maybe_finish(slot)
            n += 1
        return n

    def _step_monolithic(self) -> bool:
        """Admit what fits, then advance every slot one token: the host
        state goes up as five arrays, the tokens come back in one
        fetch."""
        tr = self.tracer
        ts0 = self.metrics.now() if tr is not None else 0.0
        admitted = self._admit()
        n_active = self.kv.active_slots
        self.metrics.record_step(n_active, self.kv.n_slots, len(self.queue))
        self._record_kv()
        if n_active == 0:
            return admitted > 0
        arrays = (self._tok, self._pos, self._active, self._temp,
                  self._topk)
        for buf, a in zip(self._mono_in, arrays):
            self._upload(buf, a)
        self.metrics.record_upload(len(arrays))
        sampled = self._sampled()
        nxt, _ = self._run(
            "decode", "decode" + (":sampled" if sampled else ""),
            self._decode_fn,
            (self.params, self.kv.caches, *self._mono_in,
             self._decode_gens(sampled)),
            self._slot_gens if sampled else ())
        nxt = nxt.cpu().numpy().copy()                  # THE step's sync
        self.metrics.record_sync()
        t = self.metrics.now()
        was_active = np.flatnonzero(self._active)
        self._pos[was_active] += 1
        self._tok = nxt
        for slot in was_active:
            self._emit(self._slot_req[slot], int(nxt[slot]), t)
        for slot in was_active:
            self._maybe_finish(slot)
        if tr is not None:
            tr.span("mono_step", ts0, self.metrics.now(), cat="serve",
                    args={"decode_slots": int(len(was_active)),
                          "admitted": admitted})
        return True

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration; False when there was nothing to do.
        Never raises for a per-request problem: those end in a terminal
        status.  With ``step_budget_ms`` a step over the budget (on the
        metrics clock) strikes the in-flight admission, the one piece of
        per-request work a step can be wedged on; after more than
        ``max_slow_steps`` strikes it ends FAILED."""
        t0 = self.metrics.now()
        if self._faults is not None:
            self._faults.on_step(self._step_idx)
        self._step_idx += 1
        ok = self._step_chunked() if self.chunked \
            else self._step_monolithic()
        if (self.step_budget_s is not None
                and self.metrics.now() - t0 > self.step_budget_s):
            self.metrics.record_slow_step()
            pf = self._lane
            if pf is not None:
                pf.req.slow_strikes += 1
                if pf.req.slow_strikes > self.max_slow_steps:
                    self._abort_prefill(
                        RequestStatus.FAILED,
                        cause=f"stall watchdog: {pf.req.slow_strikes}"
                              f" steps over the "
                              f"{self.step_budget_s * 1e3:g}ms budget")
        return ok

    @property
    def inflight_admissions(self) -> int:
        """Admissions carrying a prefill (0 or 1: one lane)."""
        return int(self._lane is not None)

    def _progress_sig(self):
        return (self.metrics.total_tokens, len(self.queue),
                self.kv.active_slots, self.metrics.completed,
                self.metrics.terminal_count,
                self._lane.off if self._lane is not None else -1,
                self._faults.attempts if self._faults is not None else 0)

    def run(self, max_steps: int | None = None) -> dict:
        """Drive :meth:`step` until the queue and all slots drain (or
        ``max_steps``); returns :meth:`results`.  Raises
        :class:`EngineStalledError` after ``stall_limit`` steps with no
        observable progress, having first closed the flight record of
        every unfinished request with the stall as its cause."""
        steps = stagnant = 0
        sig = None
        while self.queue or self.kv.active_slots or self._lane is not None:
            self.step()
            steps += 1
            cur = self._progress_sig()
            if cur != sig:
                stagnant, sig = 0, cur
            else:
                stagnant += 1
                if stagnant >= self.stall_limit:
                    msg = (f"no scheduler progress in {stagnant} steps "
                           f"(queue={len(self.queue)}, "
                           f"active={self.kv.active_slots})")
                    for req in self.requests.values():
                        if req.status not in TERMINAL_STATUSES:
                            self.flight.note(req.rid, "stall", msg)
                            self.flight.close(
                                req.rid, req.status.value,
                                f"stall watchdog: {msg}",
                                tokens_emitted=len(req.tokens),
                                preemptions=req.preemptions,
                                last_horizon_occupancy=self._last_hz_occ)
                    raise EngineStalledError(msg)
            if max_steps is not None and steps >= max_steps:
                break
        return self.results()

    def drain(self, max_steps: int | None = None) -> dict:
        """:meth:`run` under another name, as the reference's."""
        return self.run(max_steps)

    def results(self) -> dict:
        """``{rid: np.int32 tokens}`` for every completed request."""
        return {r.rid: np.asarray(r.tokens, np.int32)
                for r in self.requests.values() if r.done}


def _cache_tensors(caches) -> list:
    """The cache tensors of every layer, in order."""
    return [t for layer in caches for t in layer]


def _to_device(tree, dev):
    """The decode-param tree with every tensor on ``dev`` (no copy for
    tensors already there)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def _to_host_async(block):
    """Queue a copy of a device token block to host memory behind the
    kernels that produce it; returns ``(host_tensor, event)`` — wait on
    the event before reading (None on the CPU, where the block is
    already host memory)."""
    if block.device.type != "cuda":
        return block.clone(), None      # a graph's output is rewritten
    host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
    host.copy_(block, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event
