"""Engine-side QoS -- the port's copy of ``skypilot_tpu/infer/qos.py``:
priority classes, per-tenant weighted-fair queueing, and the service-rate
estimator behind deadline-driven admission shedding.

- **Priority classes**: ``interactive`` strictly ahead of ``batch``.
  Interactive arrivals also preempt part-prefilled batch work at
  chunked-prefill boundaries (engine ``_maybe_preempt_for``): the parked
  prompt's paged blocks stay refcounted in the radix tree, so resuming is
  a suffix-only prefill.
- **Weighted-fair queueing** within a class, virtual-time WFQ keyed on
  ``Request.tenant_id``.  Each tenant's lane is FIFO; an entry carries the
  virtual finish tag ``max(V, lane_tail) + cost/weight``; pop takes the
  smallest tag across lanes and advances the class clock V to it.  Cost
  is the request's token work (prompt + max_new), so fairness is in
  service share, not request count.
- **Deadline shedding**: ``ServiceEstimator`` keeps an EWMA of the
  observed per-request service rate (tokens/s, prompt + output, fed by
  every clean finish).  At dequeue the engine rejects work whose elapsed
  queue time plus projected service time cannot meet its ``deadline_s``:
  a typed rejection (finish_reason 'deadline', error_class 'shed').

No wall clocks in here: WFQ time is virtual (work-based) and the
estimator is fed durations by the engine.  The WFQ lock is a plain
``threading.Lock``; the JAX package wraps its lock in a lock-order
sanitizer, which the port does not have yet (ROADMAP.md A10).
"""
import collections
import threading
from typing import Any, Dict, Optional, TYPE_CHECKING

from skypilot_tpu_torch.analysis import sanitizers
from skypilot_tpu_torch.infer.scheduler import Scheduler

if TYPE_CHECKING:                     # import cycle guard: engine.py
    from skypilot_tpu_torch.infer.engine import Request  # pragma: no cover

# Strict-priority order, highest first.  classify() maps unknown /
# unset priorities to the FIRST class so a plain request is never
# accidentally demoted; the server validates the field at the edge.
PRIORITY_CLASSES = ('interactive', 'batch')

# Tenant key for requests without a tenant_id: they all share ONE
# default lane (weight 1.0) rather than bypassing fairness.
DEFAULT_TENANT = '_default'


def classify(req: 'Request') -> str:
    """Priority class of a request ('interactive' unless explicitly
    'batch' — see PRIORITY_CLASSES)."""
    p = getattr(req, 'priority', None)
    return p if p in PRIORITY_CLASSES else PRIORITY_CLASSES[0]


class ServiceEstimator:
    """EWMA of the engine's observed service rate, in tokens/second
    per request (prompt + generated, end to end including queueing at
    the device).  Deliberately coarse: the shedding bound wants a
    stable order-of-magnitude answer, not a per-shape model.  Returns
    None until it has seen at least one completion — with no signal
    the engine never sheds on projection (only on already-expired
    deadlines)."""

    def __init__(self, alpha: float = 0.3) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f'alpha must be in (0, 1] (got {alpha})')
        self._alpha = alpha
        self._rate: Optional[float] = None   # tokens / second

    def observe(self, tokens: int, seconds: float) -> None:
        """Feed one completed request's token work and wall duration."""
        if tokens <= 0 or seconds <= 0.0:
            return
        r = tokens / seconds
        self._rate = r if self._rate is None else (
            self._alpha * r + (1.0 - self._alpha) * self._rate)

    def rate(self) -> Optional[float]:
        return self._rate

    def projected_s(self, tokens: int) -> Optional[float]:
        """Projected service seconds for `tokens` of work, or None
        when no completion has been observed yet."""
        if self._rate is None or self._rate <= 0.0 or tokens <= 0:
            return None
        return tokens / self._rate


class _Lane:
    """One tenant's FIFO lane inside a class: (finish_tag, req) deque
    plus the tail finish tag future pushes chain behind."""
    __slots__ = ('entries', 'tail')

    def __init__(self) -> None:
        self.entries: collections.deque = collections.deque()
        self.tail = 0.0


class WfqScheduler(Scheduler):
    """Strict priority across PRIORITY_CLASSES; virtual-time WFQ over
    tenant lanes within each class.  Plugs into the engine behind the
    `infer/scheduler.py` seam (`InferConfig.qos = True`)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 cost_fn=None) -> None:
        ws = dict(weights or {})
        for t, w in ws.items():
            if not (isinstance(w, (int, float)) and w > 0):
                raise ValueError(
                    f'tenant weight must be > 0 (tenant {t!r}: {w!r})')
        self._weights = ws
        # Cost of a request in virtual-time units; the engine passes
        # its token-work measure (prompt + resolved max_new).
        self._cost_fn = cost_fn or (
            lambda r: len(r.tokens) + (r.max_new_tokens or 1))
        # Per-class: virtual clock + tenant lanes.  All guarded — pop
        # runs on the loop thread while stats()/backlog() may be read
        # from the HTTP threads.
        self._vtime: Dict[str, float] = {  # guarded-by: _lock
            c: 0.0 for c in PRIORITY_CLASSES}
        self._lanes: Dict[str, Dict[str, _Lane]] = {  # guarded-by: _lock
            c: {} for c in PRIORITY_CLASSES}
        self._depth = 0  # guarded-by: _lock
        # Work admitted through pop(), in cost units per tenant —
        # the fairness tests measure share against this.
        self.served: Dict[str, float] = {}  # guarded-by: _lock
        self._lock = sanitizers.instrument_lock(
            threading.Lock(), 'infer.qos.wfq._lock')

    def _tenant(self, req: 'Request') -> str:
        t = getattr(req, 'tenant_id', None)
        return t if t else DEFAULT_TENANT

    def weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, 1.0))

    def push(self, req: 'Request') -> None:
        cls, tenant = classify(req), self._tenant(req)
        cost = float(self._cost_fn(req))
        with self._lock:
            lane = self._lanes[cls].setdefault(tenant, _Lane())
            tag = max(self._vtime[cls], lane.tail) \
                + cost / self.weight(tenant)
            lane.tail = tag
            lane.entries.append((tag, req))
            self._depth += 1

    def pop(self) -> Optional['Request']:
        with self._lock:
            for cls in PRIORITY_CLASSES:
                lanes = self._lanes[cls]
                best = None
                for tenant, lane in lanes.items():
                    if lane.entries and (
                            best is None or
                            lane.entries[0][0] < lanes[best].entries[0][0]):
                        best = tenant
                if best is None:
                    continue
                tag, req = lanes[best].entries.popleft()
                self._vtime[cls] = max(self._vtime[cls], tag)
                self._depth -= 1
                self.served[best] = self.served.get(best, 0.0) \
                    + float(self._cost_fn(req))
                return req
            return None

    def _over_share(self, tenant: str) -> float:
        """Weight-normalised service already consumed: the fairness
        measure shed ordering ranks by."""
        return self.served.get(tenant, 0.0) / self.weight(tenant)

    def shed_victim(self, prefer_over: Optional[str] = None,
                    doomed=None) -> Optional['Request']:
        """Deadline-shedding victim selection: when the projection bound says work must be dropped, drop the
        MOST-over-fair-share tenant's most recent deadline-bearing row
        — batch class before interactive, lane tail before lane head —
        instead of whatever FIFO/WFQ pop order happens to surface
        (which punishes the under-share tenant at the head).

        Only requests carrying a deadline_s are eligible (no-deadline
        work is never shed), and `doomed(req)` — when given — must
        also confirm the candidate cannot meet its own deadline, so
        fairness never sacrifices a row that would have made it.  With
        `prefer_over` set, only tenants STRICTLY more over-share than
        that tenant qualify; None then means "shed the caller's own
        request instead".  The removed request is returned un-charged
        (its push() cost stands; shedding is not service)."""
        with self._lock:
            floor = (self._over_share(prefer_over)
                     if prefer_over is not None else None)
            best = None        # (share, cls_idx, pos_in_lane)
            for cls_idx, cls in enumerate(reversed(PRIORITY_CLASSES)):
                for tenant, lane in self._lanes[cls].items():
                    if not lane.entries:
                        continue
                    share = self._over_share(tenant)
                    if floor is not None and share <= floor:
                        continue
                    for pos in range(len(lane.entries) - 1, -1, -1):
                        req = lane.entries[pos][1]
                        if getattr(req, 'deadline_s', None) is None:
                            continue
                        if doomed is not None and not doomed(req):
                            continue
                        cand = (share, -cls_idx, pos)
                        if best is None or cand > best[0]:
                            best = (cand, cls, tenant, pos)
                        break      # most recent eligible in this lane
            if best is None:
                return None
            _, cls, tenant, pos = best
            lane = self._lanes[cls][tenant]
            _, victim = lane.entries[pos]
            del lane.entries[pos]
            self._depth -= 1
            return victim

    def requeue(self, req: 'Request') -> None:
        """Preempted work re-enters at the FRONT of its lane with the
        class's current virtual time: immediately eligible again, and
        not re-charged — its cost was spent at push()."""
        cls, tenant = classify(req), self._tenant(req)
        with self._lock:
            lane = self._lanes[cls].setdefault(tenant, _Lane())
            lane.entries.appendleft((self._vtime[cls], req))
            self._depth += 1

    def backlog(self) -> int:
        return self._depth

    def waiting(self, priority: str) -> int:
        with self._lock:
            return sum(len(lane.entries)
                       for lane in self._lanes.get(priority, {}).values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            depth = {cls: sum(len(lane.entries)
                              for lane in self._lanes[cls].values())
                     for cls in PRIORITY_CLASSES}
            tenants: Dict[str, Dict[str, Any]] = {}
            for cls in PRIORITY_CLASSES:
                for tenant, lane in self._lanes[cls].items():
                    t = tenants.setdefault(
                        tenant, {'queued': 0,
                                 'weight': self.weight(tenant),
                                 'served_cost': self.served.get(
                                     tenant, 0.0)})
                    t['queued'] += len(lane.entries)
            for tenant, cost in self.served.items():
                tenants.setdefault(
                    tenant, {'queued': 0, 'weight': self.weight(tenant),
                             'served_cost': cost})
            return {'policy': 'wfq', 'depth': depth, 'tenants': tenants}
