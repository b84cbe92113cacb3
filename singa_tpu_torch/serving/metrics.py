"""Serving metrics: TTFT, inter-token latency, throughput, occupancy,
KV and prefix gauges, host<->device crossings, and the robustness
accounting: terminal statuses, preemptions, restores, slow steps,
callback errors, goodput and the deadline-miss rate.
Counterpart: ``singa_tpu/serving/metrics.py`` (the speculative, lane
and tenant accounting arrive with their slices).

Pure host-side accounting: the engine calls ``record_*`` where it
touches the host anyway.  ``snapshot()`` returns a flat JSON-ready dict
and ``publish()`` writes it into a :class:`MetricsRegistry`.
"""

from __future__ import annotations

import time

__all__ = ["ServingMetrics"]


def _pctl(xs, q):
    """Nearest-rank percentile; empty input yields 0.0."""
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


class ServingMetrics:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        self.submitted = 0
        self.completed = 0
        self.total_tokens = 0
        self._submit_t = {}           # rid -> submit time
        self._last_tok_t = {}         # rid -> last token time
        self._ttft = []               # seconds
        self._itl = []                # seconds, per token gap
        self._queue_wait = []         # seconds, submit -> admission
        self._admit_t = {}            # rid -> FIRST admission time
        self._prefill_time = []       # seconds, first admission -> token
        self._occupancy = []          # active/n_slots per step
        self._queue_depth = []        # queued requests per step
        self._budget_occ = []         # (prefill+decode toks)/budget per step
        self.host_syncs = 0           # device->host fetches (blocking)
        self.host_uploads = 0         # host->device copies
        self.host_kill_uploads = 0    # of which: kill masks
        self.preemptions = 0
        self.restores = 0
        self.slow_steps = 0           # steps over the wall-clock budget
        self.callback_errors = 0      # raising on_token/on_done callbacks
        self.goodput_tokens = 0       # tokens of in-deadline completions
        self._deadline_total = 0      # terminals that carried a deadline
        self._deadline_missed = 0
        self._hz_emitted = []         # tokens emitted per horizon block
        self._hz_capacity = []        # K * n_slots per horizon block
        self._kv_committed = 0        # bytes pinned by the page pool
        self._kv_live_peak = 0        # peak live bytes over the run
        self._page_util = []          # live fraction per step
        self._prefix_hit_tokens = 0
        self._prefix_query_tokens = 0
        self.status_counts = {}       # terminal status string -> count
        self._t0 = None               # first submit
        self._t_last = None           # last recorded event
        self._pub_idx = {"ttft": 0, "itl": 0}   # publish() watermarks

    def now(self) -> float:
        return self._clock()

    def submit_time(self, rid):
        """Submit time of ``rid`` (None if unknown): the tracer anchors
        a request's lifetime span and its TTFT argument on it."""
        return self._submit_t.get(rid)

    # ---- event hooks (engine calls these) -----------------------------
    def record_submit(self, rid, t=None) -> None:
        t = self._clock() if t is None else t
        self.submitted += 1
        self._submit_t[rid] = t
        if self._t0 is None:
            self._t0 = t
        self._t_last = t

    def record_admitted(self, rid, t=None) -> None:
        """``rid`` won the admission lane: one queue-wait sample, for its
        first admission only (a restore re-admits a request whose queue
        wait already happened)."""
        if rid in self._admit_t:
            return
        t = self._clock() if t is None else t
        self._admit_t[rid] = t
        self._queue_wait.append(t - self._submit_t.get(rid, t))
        self._t_last = t

    def record_first_token(self, rid, t=None) -> None:
        t = self._clock() if t is None else t
        self._ttft.append(t - self._submit_t.get(rid, t))
        if rid in self._admit_t:
            self._prefill_time.append(t - self._admit_t[rid])
        self._last_tok_t[rid] = t
        self.total_tokens += 1
        self._t_last = t

    def record_token(self, rid, t=None) -> None:
        t = self._clock() if t is None else t
        prev = self._last_tok_t.get(rid)
        if prev is not None:
            self._itl.append(t - prev)
        self._last_tok_t[rid] = t
        self.total_tokens += 1
        self._t_last = t

    def record_finish(self, rid, t=None) -> None:
        self.completed += 1
        self._t_last = self._clock() if t is None else t

    def record_terminal(self, status: str, n_tokens: int, done: bool,
                        in_deadline: bool, had_deadline: bool) -> None:
        """A request reached its terminal status.  Goodput counts the
        tokens of completions that met their deadline (no deadline is
        always met); the deadline-miss rate is over the terminals that
        carried a deadline.  (The reference's ``rid=`` keys its tenant
        accounting, which this port does not have yet.)"""
        self.status_counts[status] = self.status_counts.get(status, 0) + 1
        if had_deadline:
            self._deadline_total += 1
            if not (done and in_deadline):
                self._deadline_missed += 1
        if done and in_deadline:
            self.goodput_tokens += n_tokens
        self._t_last = self._clock()

    @property
    def terminal_count(self) -> int:
        return sum(self.status_counts.values())

    def record_step(self, active: int, n_slots: int, queued: int,
                    used_tokens: int | None = None,
                    budget_tokens: int | None = None) -> None:
        self._occupancy.append(active / n_slots if n_slots else 0.0)
        self._queue_depth.append(queued)
        if used_tokens is not None and budget_tokens:
            self._budget_occ.append(used_tokens / budget_tokens)

    def record_sync(self, n: int = 1) -> None:
        """The engine fetched device data to the host (a blocking
        round trip)."""
        self.host_syncs += n

    def record_upload(self, n: int = 1) -> None:
        """The engine copied ``n`` host arrays to the device (admission
        only; steady-state decode keeps this at 0)."""
        self.host_uploads += n

    def record_kill_upload(self, n: int = 1) -> None:
        """A cancel, a deadline eviction or a preemption shipped a kill
        mask: counted in
        ``host_uploads`` too, and apart, so a steady-state zero-upload
        probe can discount events the host started."""
        self.host_uploads += n
        self.host_kill_uploads += n

    def record_preempt(self) -> None:
        self.preemptions += 1

    def record_restore(self) -> None:
        self.restores += 1

    def record_slow_step(self) -> None:
        self.slow_steps += 1

    def record_callback_error(self) -> None:
        self.callback_errors += 1

    def record_kv(self, committed: int, live: int, util: float) -> None:
        self._kv_committed = committed
        self._kv_live_peak = max(self._kv_live_peak, live)
        self._page_util.append(util)

    def record_prefix(self, cached_tokens: int, prompt_tokens: int) -> None:
        self._prefix_hit_tokens += cached_tokens
        self._prefix_query_tokens += prompt_tokens

    def record_horizon(self, emitted: int, K: int, n_slots: int) -> None:
        self._hz_emitted.append(emitted)
        self._hz_capacity.append(K * n_slots)

    # ---- aggregate view ------------------------------------------------
    def snapshot(self) -> dict:
        ms = 1e3
        elapsed = (self._t_last - self._t0) \
            if (self._t0 is not None and self._t_last is not None
                and self._t_last > self._t0) else 0.0
        occ, qd = self._occupancy, self._queue_depth
        ttft, itl, qw = self._ttft, self._itl, self._queue_wait
        pft = self._prefill_time

        def avg(xs):
            return sum(xs) / len(xs) if xs else 0.0

        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "total_tokens": self.total_tokens,
            "tokens_per_s": round(self.total_tokens / elapsed, 1)
            if elapsed else 0.0,
            "ttft_mean_ms": round(ms * avg(ttft), 3),
            "ttft_p50_ms": round(ms * _pctl(ttft, 0.5), 3),
            "ttft_p99_ms": round(ms * _pctl(ttft, 0.99), 3),
            "ttft_max_ms": round(ms * max(ttft), 3) if ttft else 0.0,
            "queue_wait_p50_ms": round(ms * _pctl(qw, 0.5), 3),
            "queue_wait_p99_ms": round(ms * _pctl(qw, 0.99), 3),
            "prefill_time_p50_ms": round(ms * _pctl(pft, 0.5), 3),
            "prefill_time_p99_ms": round(ms * _pctl(pft, 0.99), 3),
            "itl_mean_ms": round(ms * avg(itl), 3),
            "itl_p50_ms": round(ms * _pctl(itl, 0.5), 3),
            "itl_p99_ms": round(ms * _pctl(itl, 0.99), 3),
            "itl_max_ms": round(ms * max(itl), 3) if itl else 0.0,
            "mean_occupancy": round(avg(occ), 4),
            "mean_token_budget_occupancy": round(avg(self._budget_occ), 4),
            "mean_queue_depth": round(avg(qd), 2),
            "steps": len(occ),
            "host_syncs": self.host_syncs,
            "host_uploads": self.host_uploads,
            "host_syncs_per_token":
            round(self.host_syncs / self.total_tokens, 4)
            if self.total_tokens else 0.0,
            "uploads_per_token":
            round(self.host_uploads / self.total_tokens, 4)
            if self.total_tokens else 0.0,
            "mean_horizon_occupancy":
            round(sum(self._hz_emitted) / sum(self._hz_capacity), 4)
            if sum(self._hz_capacity) else 0.0,
            "horizon_blocks": len(self._hz_capacity),
            "kv_bytes_committed": self._kv_committed,
            "kv_bytes_live": self._kv_live_peak,      # peak over the run
            "page_utilization": round(avg(self._page_util), 4),
            "prefix_cache_hit_rate":
            round(self._prefix_hit_tokens / self._prefix_query_tokens, 4)
            if self._prefix_query_tokens else 0.0,
            "host_kill_uploads": self.host_kill_uploads,
            "rejected_count": self.status_counts.get("REJECTED", 0),
            "failed_count": self.status_counts.get("FAILED", 0),
            "evicted_deadline_count":
            self.status_counts.get("EVICTED_DEADLINE", 0),
            "cancelled_count": self.status_counts.get("CANCELLED", 0),
            "preempted_restored_count":
            self.status_counts.get("PREEMPTED_RESTORED", 0),
            "preemption_count": self.preemptions,
            "restore_count": self.restores,
            "slow_steps": self.slow_steps,
            "callback_errors": self.callback_errors,
            "goodput_tokens": self.goodput_tokens,
            "goodput_tokens_per_s": round(self.goodput_tokens / elapsed, 1)
            if elapsed else 0.0,
            "deadline_requests": self._deadline_total,
            "deadline_miss_rate":
            round(self._deadline_missed / self._deadline_total, 4)
            if self._deadline_total else 0.0,
        }

    # ---- telemetry bridge ------------------------------------------------
    def publish(self, registry=None, **labels):
        """Publish into a :class:`~singa_tpu_torch.telemetry.MetricsRegistry`
        (the process default when None): every numeric ``snapshot()``
        field as a ``serving_<field>`` gauge, the terminal statuses as
        ``serving_terminal_requests{status=...}``, and the TTFT and ITL
        samples into the ``serving_ttft_ms`` / ``serving_itl_ms``
        histograms.  The histograms are watermarked, so a scrape loop
        that publishes again never observes a sample twice.  Returns
        the registry."""
        from ..telemetry.registry import default_registry
        reg = default_registry() if registry is None else registry
        for name, value in self.snapshot().items():
            if isinstance(value, (int, float)):
                reg.gauge("serving_" + name, **labels).set(value)
        for status, n in self.status_counts.items():
            reg.gauge("serving_terminal_requests",
                      status=status, **labels).set(n)
        for key, samples in (("ttft", self._ttft), ("itl", self._itl)):
            hist = reg.histogram(f"serving_{key}_ms", **labels)
            for v in samples[self._pub_idx[key]:]:
                hist.observe(v * 1e3)
            self._pub_idx[key] = len(samples)
        return reg
