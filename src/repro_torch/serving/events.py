"""Discrete-event core: a priority queue keyed on simulation time.

No per-frame ticking — every state change in the serving runtime (a frame
sampled on a device, a byte landing at the server, the GPU freeing up, a
delta arriving at an edge) is an `Event` popped in time order. Ties are
broken by insertion sequence, so runs are bit-for-bit deterministic
regardless of how many events share a timestamp.

Fleet-scale addenda:

* **Cohort events** — `client` may be an ``np.ndarray`` of client ids, in
  which case the event stands for ``len(client)`` logical per-client events
  that share a (time, kind). The queue's ``pushed``/``popped`` ledgers count
  *logical* events (``Event.n``), so ``events_processed`` in the engine's
  results is identical whether a schedule was driven per-object or by
  cohorts; the heap itself holds one entry per cohort, which is where the
  fleet path's throughput comes from.
* `push_many` — bulk insert with one heapify when the batch is large
  relative to the heap (heap *layout* may differ from repeated `push`, but
  pop order cannot: (time, seq) is a total order).
* `pop_batch` — drain every event sharing the minimum timestamp, returned
  in seq (push) order, exactly the order repeated `pop` would yield.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any


def _multiplicity(client: Any) -> int:
    """Logical event count: cohort arrays count each member."""
    if client is None or isinstance(client, int):
        return 1
    try:  # np.ndarray (or any sized cohort container)
        return len(client)
    except TypeError:
        return 1


@dataclass(frozen=True)
class Event:
    time: float
    seq: int  # insertion order; the FIFO tie-break at equal times
    kind: str
    client: Any = None  # int | None | np.ndarray cohort of client ids
    payload: Any = None
    n: int = 1  # logical multiplicity (len(client) for cohorts)


class EventQueue:
    """Min-heap of events ordered by (time, seq).

    ``pushed``/``popped`` count logical events: a cohort event weighs
    ``Event.n``, so schedule accounting is representation-independent.
    """

    def __init__(self):
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self.pushed = 0
        self.popped = 0

    def push(self, time: float, kind: str, client: Any = None,
             payload: Any = None) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   client=client, payload=payload,
                   n=_multiplicity(client))
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq += 1
        self.pushed += ev.n
        return ev

    def push_many(self, items) -> list[Event]:
        """Bulk insert of ``(time, kind, client, payload)`` tuples.

        Seqs are assigned in iteration order (same tie-break as repeated
        `push`). When the batch is large relative to the existing heap a
        single extend+heapify replaces per-item sift-ups; either way the
        (time, seq) total order makes pop order identical.
        """
        evs = []
        for time, kind, client, payload in items:
            ev = Event(time=float(time), seq=self._seq, kind=kind,
                       client=client, payload=payload,
                       n=_multiplicity(client))
            self._seq += 1
            self.pushed += ev.n
            evs.append(ev)
        if not evs:
            return evs
        # heapify is O(heap); k pushes are O(k log heap) — pick the cheaper
        if len(evs) * max(len(self._heap), 1).bit_length() < \
                len(self._heap) + len(evs):
            for ev in evs:
                heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        else:
            self._heap.extend((ev.time, ev.seq, ev) for ev in evs)
            heapq.heapify(self._heap)
        return evs

    def pop(self) -> Event:
        _, _, ev = heapq.heappop(self._heap)
        self.popped += ev.n
        return ev

    def pop_batch(self) -> list[Event]:
        """Pop every event at the minimum timestamp, in seq order — the
        exact sequence repeated `pop` would produce for that timestamp."""
        if not self._heap:
            return []
        t0 = self._heap[0][0]
        out = []
        while self._heap and self._heap[0][0] == t0:
            _, _, ev = heapq.heappop(self._heap)
            self.popped += ev.n
            out.append(ev)
        return out

    def peek_time(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
