"""Deterministic fault injection for the serving engine -- the port's copy
of ``skypilot_tpu/infer/faults.py`` (same sites, specs and firing rule, so
one plan fires identically against either engine).

The serving data plane degrades per request, never per process, and
proving that takes *reproducible* failures.  This module gives the engine
named injection sites it consults through one attribute check:

    plan = FaultPlan(seed=7, specs=[
        FaultSpec(site='decode_step', hits=(2,), slot=1),
    ])
    engine.arm_faults(plan)

Design rules:

- **Zero overhead unarmed.**  Every site costs exactly one
  ``self._faults is None`` check when no plan is armed; no RNG draw,
  no counter, no lock.
- **Fully reproducible armed.**  Firing is a pure function of the
  plan's seed and the per-site consult sequence.  ``hits`` fires on
  exact 1-based consult indices; ``prob`` draws one Bernoulli per
  consult from a per-spec ``numpy`` Generator seeded from
  ``(seed, spec index)`` -- so two runs with the same plan and the same
  request stream fire identically, and specs never perturb each
  other's streams.
- **Attribution is part of the fault.**  A raised :class:`InjectedFault`
  can carry the slot(s) it claims to have injured; the engine's
  containment path uses that to fail only those requests.  Faults
  without attribution exercise the quarantine-the-batch fallback.

Sites the port's engine consults:

==================  =====================================================
``prefill``         top of ``_start_batch``, before the prefill dispatch
``decode_step``     top of ``_step``, before the decode-window dispatch
``chunk_round``     top of ``_chunk_round`` while a prompt is being
                    prefilled in chunks, before the chunk dispatch
``nonfinite_logits``  after the decode window's host unpack -- a firing
                    spec overwrites one lane's logprobs with NaN to
                    exercise the non-finite guard
``stall``           top of each serving-loop iteration -- a firing spec
                    sleeps ``stall_s`` to exercise stall detection
``serve_loop``      top of serving-loop iterations that have active
                    slots -- a firing spec raises OUTSIDE every
                    contained region, killing the loop thread to
                    exercise the supervisor (conditioning on active
                    work makes "hit 1" deterministic with respect to
                    request state instead of racing the idle spin)
==================  =====================================================

``block_alloc`` is consulted by the paged pool's admission check
(``_can_admit_blocks``): a firing spec answers "no room", so the request
takes the deferral path; a dense engine never consults it.
``replica_kill``, ``net_degrade`` and ``lb_kill`` are consulted by chaos
harnesses around the process, never by the engine.

Injected dispatch faults are raised on the host, before the dispatch, so
the cache the survivors decode from is untouched.  A *real* device
failure is the unattributed case: the engine quarantines the batch and
zeroes the cache.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SITES = (
    'prefill',
    'decode_step',
    'chunk_round',
    'block_alloc',
    'nonfinite_logits',
    'stall',
    'serve_loop',
    'replica_kill',
    'net_degrade',
    'lb_kill',
)


class InjectedFault(RuntimeError):
    """Raised by the engine at a fault site the armed plan fired on.

    ``slots`` is the injected attribution: the engine slot indices the
    fault claims to have injured (None = unattributed, which makes the
    containment path quarantine every active slot).
    """

    def __init__(self, message: str, site: str,
                 slots: Optional[Sequence[int]] = None):
        super().__init__(message)
        self.site = site
        self.slots = None if slots is None else [int(s) for s in slots]


@dataclasses.dataclass
class FaultSpec:
    """One deterministic failure rule at a named site.

    site       one of :data:`SITES`.
    hits       1-based consult indices of the site at which this spec
               fires (e.g. ``(2,)`` = the second time the engine
               consults the site).  Exact and reproducible.
    prob       when ``hits`` is None: per-consult Bernoulli firing
               probability, drawn from the spec's own seeded stream.
    max_fires  stop firing after this many fires (None = unlimited;
               ``hits`` specs are naturally bounded by ``len(hits)``).
    slot       attribution: the engine slot this fault claims to have
               injured (None = unattributed → batch quarantine).
    stall_s    for the ``stall`` site: how long the loop sleeps.
    delay_s    for the ``net_degrade`` site: base added latency per
               relayed chunk (gray failure, not a crash).
    jitter_s   for the ``net_degrade`` site: uniform ±jitter around
               ``delay_s``, drawn from the consulting harness's own
               seeded stream (spec streams stay consult-aligned).
    blackhole  for the ``net_degrade`` site: a firing consult swallows
               the chunk instead of delaying it (lossy path).
    message    human-readable tag carried into the raised error.
    """

    site: str
    hits: Optional[Tuple[int, ...]] = None
    prob: float = 0.0
    max_fires: Optional[int] = None
    slot: Optional[int] = None
    stall_s: float = 0.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    blackhole: bool = False
    message: str = 'injected fault'

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f'unknown fault site {self.site!r}; valid sites: {SITES}')
        if self.hits is not None:
            self.hits = tuple(int(h) for h in self.hits)
            if any(h < 1 for h in self.hits):
                raise ValueError('hits are 1-based consult indices (>= 1)')
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f'prob must be in [0, 1] (got {self.prob})')
        if self.hits is None and self.prob == 0.0:
            raise ValueError('spec can never fire: give hits or prob > 0')
        if self.delay_s < 0.0 or self.jitter_s < 0.0:
            raise ValueError('delay_s/jitter_s must be >= 0')
        if self.jitter_s > self.delay_s and self.jitter_s > 0.0:
            raise ValueError('jitter_s must not exceed delay_s '
                             '(delay - jitter would go negative)')
        if ((self.delay_s > 0.0 or self.blackhole)
                and self.site != 'net_degrade'):
            raise ValueError(
                'delay_s/blackhole only apply to the net_degrade site')


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules the engine consults.

    Thread-safe: the serving loop and other threads may consult
    concurrently.  ``consults``/``fired`` expose per-site counters for
    tests.
    """

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs)
        self._lock = threading.Lock()
        self.consults: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        # Per-spec state: independent RNG stream (so spec ordering and
        # other sites' consult volume never shift a spec's draws) and
        # a fire counter for max_fires.
        self._rngs = [np.random.default_rng((self.seed, i))
                      for i in range(len(self.specs))]
        self._fires = [0] * len(self.specs)
        self._by_site: Dict[str, List[int]] = {}
        for i, sp in enumerate(self.specs):
            self._by_site.setdefault(sp.site, []).append(i)

    def check(self, site: str) -> Optional[FaultSpec]:
        """One consult of ``site``; returns the firing spec, else None.

        Every consult advances the site's counter and (for prob specs
        at this site) their RNG streams, whether or not anything fires
        — firing is a pure function of the consult sequence.
        """
        with self._lock:
            n = self.consults.get(site, 0) + 1
            self.consults[site] = n
            hit: Optional[FaultSpec] = None
            for i in self._by_site.get(site, ()):
                sp = self.specs[i]
                if sp.hits is not None:
                    fires = n in sp.hits
                else:
                    # Always draw: keeps the stream aligned to the
                    # consult index even when max_fires already tripped.
                    fires = float(self._rngs[i].random()) < sp.prob
                if (sp.max_fires is not None
                        and self._fires[i] >= sp.max_fires):
                    fires = False
                if fires and hit is None:
                    self._fires[i] += 1
                    self.fired[site] = self.fired.get(site, 0) + 1
                    hit = sp
            return hit

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {'consults': dict(self.consults),
                    'fired': dict(self.fired)}
