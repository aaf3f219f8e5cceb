"""Admission-order seam of the serving loop -- the port's copy of
``skypilot_tpu/infer/scheduler.py``.  The weighted-fair QoS scheduler, the
priority classes and the default tenant are in ``infer/qos.py``.

The serving loop drains its client queue into a ``Scheduler`` and admits
in the order it yields:

    loop drains request_queue -> Scheduler.push()
    loop asks Scheduler.pop() for the next request to admit
    preempted / parked work re-enters via Scheduler.requeue()

Validation, cancellation and deadlines stay in the engine; the scheduler
decides only which queued request is next.  push/pop/requeue run on the
serving-loop thread; backlog()/stats() may be called from any thread
(the server's /stats), so every scheduler carries its own lock and never
calls back into the engine.
"""
import collections
import threading
from typing import TYPE_CHECKING, Any, Dict, Optional

from skypilot_tpu_torch.analysis import sanitizers

if TYPE_CHECKING:                     # import cycle guard: engine.py
    from skypilot_tpu_torch.infer.engine import Request  # pragma: no cover


class Scheduler:
    """Interface: which queued request does the engine admit next?"""

    def push(self, req: 'Request') -> None:
        """A request arrived (drained off the client queue)."""
        raise NotImplementedError

    def pop(self) -> Optional['Request']:
        """Next request to admit, or None when nothing is queued."""
        raise NotImplementedError

    def requeue(self, req: 'Request') -> None:
        """Give back a request the engine could not (or chose not to)
        run yet.  Must make the request eligible again without
        re-charging its queueing cost."""
        raise NotImplementedError

    def backlog(self) -> int:
        """Queued requests (feeds the engine's arrivals hint)."""
        raise NotImplementedError

    def waiting(self, priority: str) -> int:
        """Queued requests of the given priority class (0 for
        schedulers without class lanes)."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError


class FifoScheduler(Scheduler):
    """Strict arrival order, one lane, no classes."""

    def __init__(self) -> None:
        self._q: collections.deque = collections.deque()  # guarded-by: _lock
        self._lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.scheduler.fifo._lock')

    def push(self, req: 'Request') -> None:
        with self._lock:
            self._q.append(req)

    def pop(self) -> Optional['Request']:
        with self._lock:
            return self._q.popleft() if self._q else None

    def requeue(self, req: 'Request') -> None:
        with self._lock:
            self._q.appendleft(req)

    def backlog(self) -> int:
        return len(self._q)

    def waiting(self, priority: str) -> int:
        return 0                      # no class lanes in FIFO

    def stats(self) -> Dict[str, Any]:
        return {'policy': 'fifo', 'depth': {'all': len(self._q)}}
