"""Flight recorder of the port: a bounded per-request event history
kept past the request's end.  Counterpart:
``singa_tpu/telemetry/flight.py``, whose records, bounds and queries it
keeps: the same notes and closes give the same records.

``ServingMetrics`` answers "how is the engine doing"; the recorder
answers "what happened to request 17".  While a request is live the
engine appends ``(t, kind, detail)`` notes to a bounded deque of its
own; at the terminal transition it *closes* the request, freezing the
notes with the terminal status, the string naming the cause and a state
snapshot (tokens emitted, preemptions, last horizon occupancy, KV and
page state, queue depth).  Closed records outlive the request's slot
and pages in a bounded store (the oldest dropped first), so a
postmortem outlives the request object itself.

Always on: a handful of tuple appends a request (not a token), and no
device work.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Per-request event rings and retained postmortems.

    ``per_request`` bounds the notes kept for a live request; ``retain``
    bounds how many closed records are kept before the oldest is
    dropped (counted in :attr:`dropped_records`).  They default to 64
    and 512; the reference also reads them from the environment, which
    this port leaves to the caller's arguments.
    """

    DEFAULT_PER_REQUEST = 64
    DEFAULT_RETAIN = 512

    def __init__(self, per_request: int = DEFAULT_PER_REQUEST,
                 retain: int = DEFAULT_RETAIN):
        if per_request < 1 or retain < 1:
            raise ValueError("per_request and retain must be >= 1")
        self.per_request = int(per_request)
        self.retain = int(retain)
        self._live: Dict[object, deque] = {}
        self._closed: "OrderedDict[object, dict]" = OrderedDict()
        self.dropped_records = 0   # closed records the retain bound dropped

    # ---- recording -------------------------------------------------------
    def note(self, rid, kind: str, detail: str = "",
             t: Optional[float] = None) -> None:
        """Append an event to ``rid``'s live history (no-op after its
        close)."""
        if rid in self._closed:
            return
        ring = self._live.get(rid)
        if ring is None:
            ring = self._live[rid] = deque(maxlen=self.per_request)
        ring.append((time.perf_counter() if t is None else t, kind, detail))

    def close(self, rid, status: str, cause: str,
              t: Optional[float] = None, **state) -> None:
        """Freeze ``rid``'s history with its terminal status and cause;
        the ``state`` pairs are stored on the record as given.  Closing
        a closed rid is a no-op, so a late sweep cannot overwrite the
        first cause."""
        if rid in self._closed:
            return
        ring = self._live.pop(rid, None)
        self._closed[rid] = {
            "rid": rid,
            "status": status,
            "cause": cause,
            "t_close": time.perf_counter() if t is None else t,
            "events": _events(ring),
            **state,
        }
        while len(self._closed) > self.retain:
            self._closed.popitem(last=False)
            self.dropped_records += 1

    # ---- queries ---------------------------------------------------------
    def postmortem(self, rid) -> Optional[dict]:
        """The closed record of ``rid``; for a live rid a partial record
        with ``status: "LIVE"``; None for an unknown or dropped rid."""
        rec = self._closed.get(rid)
        if rec is not None:
            return rec
        ring = self._live.get(rid)
        if ring is None:
            return None
        return {"rid": rid, "status": "LIVE", "cause": None,
                "events": _events(ring)}

    def postmortems(self) -> List[dict]:
        """Every retained closed record, oldest first."""
        return list(self._closed.values())

    def live_rids(self) -> List[object]:
        return list(self._live)

    def __len__(self) -> int:
        return len(self._closed)


def _events(ring) -> List[dict]:
    return [] if ring is None else [
        {"t": t, "kind": kind, "detail": detail} for t, kind, detail in ring]
