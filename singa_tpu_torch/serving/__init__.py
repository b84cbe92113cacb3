"""Serving of the port (counterpart: ``singa_tpu/serving``): the
continuous-batching engine (chunked over slots or pages, or monolithic
over slots) with its KV caches, sampling and metrics, and the fault
plans its seams take (``ServingEngine(faults=)``)."""

from .engine import (DEFAULT_CHUNK_TOKENS, DEFAULT_DECODE_HORIZON,
                     MAX_STOP_TOKENS, EngineStalledError, Request,
                     RequestStatus, ServingEngine, TERMINAL_STATUSES)
from .faults import (DropCallback, ExhaustAllocator, FaultPlan,
                     LatencySpike, NaNLogits, ReplicaLoss, ReplicaStall)
from .kv_cache import DEFAULT_PAGE_TOKENS, PagedKVCache, SlotKVCache
from .metrics import ServingMetrics
from .sampling import SamplingParams, sample_logits, sample_logits_per_row

__all__ = ["ServingEngine", "Request", "RequestStatus", "TERMINAL_STATUSES",
           "EngineStalledError", "SlotKVCache", "PagedKVCache",
           "ServingMetrics",
           "SamplingParams", "sample_logits", "sample_logits_per_row",
           "FaultPlan", "ExhaustAllocator", "NaNLogits", "LatencySpike",
           "DropCallback", "ReplicaLoss", "ReplicaStall",
           "DEFAULT_CHUNK_TOKENS", "DEFAULT_DECODE_HORIZON",
           "DEFAULT_PAGE_TOKENS", "MAX_STOP_TOKENS"]
