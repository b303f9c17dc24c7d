"""Engine telemetry pieces the plan compiler needs.

* :class:`Histogram` — bounded-memory sample histogram with exact totals
  (``CacheStats`` records compile times in one).
* :class:`VectorizationProfile` — computed once per compiled plan from
  :mod:`repro_torch.core.metrics`: ALO (average lane occupancy, the AVL
  analogue), ORR (op-reduction ratio, the IRR analogue), structural
  arithmetic intensity, and the fraction of amplitude traffic taking the
  diagonal/permutation fast path.

The registry, span tracer and served-activity aggregation belong to the
serving stack and are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from repro_torch.core.metrics import circuit_cost


class Histogram:
    """Bounded-memory sample histogram with exact totals.

    ``count``/``sum``/``min``/``max`` are exact over every recorded sample;
    percentiles are computed over a fixed-capacity ring of the most recent
    ``capacity`` samples, so a long-running serve holds O(capacity) memory
    no matter how many samples it records.  Thread-safe: one lock guards the
    ring and the totals, so concurrent recorders never lose a sample count.
    """

    __slots__ = ("name", "capacity", "_ring", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, capacity: int = 4096, name: str = ""):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self._ring = np.empty(capacity, np.float64)  #: guarded-by: _lock
        self._count = 0                              #: guarded-by: _lock
        self._sum = 0.0                              #: guarded-by: _lock
        self._min = np.inf                           #: guarded-by: _lock
        self._max = -np.inf                          #: guarded-by: _lock
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._count % self.capacity] = v
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def __len__(self) -> int:
        """Total samples ever recorded (NOT the retained window size)."""
        with self._lock:
            return self._count

    @property
    def count(self) -> int:
        return len(self)

    def window(self) -> np.ndarray:
        """Copy of the retained samples (at most ``capacity``, newest last
        wrap order — order is irrelevant for percentiles)."""
        with self._lock:
            return self._ring[:min(self._count, self.capacity)].copy()

    def percentile(self, q: float) -> float:
        w = self.window()
        if not len(w):
            raise ValueError(f"histogram {self.name!r} is empty")
        return float(np.percentile(w, q))

    def summary(self) -> dict:
        """count/mean/p50/p95/p99/max in the recorded unit; empty dict when
        no samples (callers decide how to report idleness — fabricating a
        0.0 percentile is the bug the scheduler already fixed once)."""
        with self._lock:
            n = self._count
            if not n:
                return {}
            w = self._ring[:min(n, self.capacity)].copy()
            total, mx = self._sum, self._max
        p50, p95, p99 = np.percentile(w, [50, 95, 99])
        return {"count": n, "mean": total / n, "p50": float(p50),
                "p95": float(p95), "p99": float(p99), "max": float(mx)}

    def __repr__(self) -> str:
        return (f"Histogram({self.name or 'unnamed'}, count={self.count}, "
                f"capacity={self.capacity})")


# -- vectorization-activity observability --------------------------------------

@dataclasses.dataclass(frozen=True)
class VectorizationProfile:
    """Structural vectorization profile of one compiled plan.

    Computed once at plan-compile time from :mod:`repro_torch.core.metrics` —
    the serving-side analogues of the paper's PMU metrics (§VII-A):
    ``alo`` mirrors AVL (average active vector length), ``orr`` mirrors
    IRR (instruction reduction ratio), ``ai`` is the structural arithmetic
    intensity, and ``fast_amp_frac`` is the fraction of amplitude traffic
    (item applications weighted by touched amplitudes) taking the
    diagonal/permutation matmul-free fast path.
    """

    alo: float                    # average active lanes per vector op
    lanes: int                    # the target's vector lanes (ALO ceiling)
    orr: float                    # naive scalar ops / VLA vector ops
    ai: float                     # structural flops per HBM byte
    flops_per_amp_actual: float
    flops_per_amp_generic: float
    flops_saved_frac: float
    fast_amp_frac: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def vectorization_profile(plan, gates: Sequence,
                          target) -> VectorizationProfile:
    """Profile one compiled plan: costs from the paper's structural model
    (:func:`repro_torch.core.metrics.circuit_cost` over the original gate list)
    plus per-item fast-path coverage from the plan's lowered items."""
    n = plan.n
    cost_gen = circuit_cost(gates, n, target, specialized=False)
    cost = circuit_cost(gates, n, target, specialized=plan.specialize)
    fl = plan.flops_per_amp()
    total = fast = 0.0
    for item in plan.items:
        if item.kind == "result":
            continue   # reduction epilogue, not gate amplitude traffic
        amps = float(1 << n) / (1 << len(item.controls))
        total += amps
        if item.kind in ("diag", "perm"):
            fast += amps
    return VectorizationProfile(
        alo=float(cost.active_lanes),
        lanes=int(target.lanes),
        orr=(cost_gen.flops / 2.0) / max(cost.vector_ops, 1.0),
        ai=float(cost.ai),
        flops_per_amp_actual=fl["flops_per_amp_actual"],
        flops_per_amp_generic=fl["flops_per_amp_generic"],
        flops_saved_frac=fl["flops_saved_frac"],
        fast_amp_frac=fast / total if total else 0.0,
    )
