"""Serving of the port (counterpart: ``singa_tpu/serving``): the chunked,
paged continuous-batching engine with its KV cache, sampling and
metrics."""

from .engine import (DEFAULT_CHUNK_TOKENS, DEFAULT_DECODE_HORIZON,
                     MAX_STOP_TOKENS, EngineStalledError, Request,
                     RequestStatus, ServingEngine)
from .kv_cache import DEFAULT_PAGE_TOKENS, PagedKVCache
from .metrics import ServingMetrics
from .sampling import SamplingParams, sample_logits, sample_logits_per_row

__all__ = ["ServingEngine", "Request", "RequestStatus",
           "EngineStalledError", "PagedKVCache", "ServingMetrics",
           "SamplingParams", "sample_logits", "sample_logits_per_row",
           "DEFAULT_CHUNK_TOKENS", "DEFAULT_DECODE_HORIZON",
           "DEFAULT_PAGE_TOKENS", "MAX_STOP_TOKENS"]
