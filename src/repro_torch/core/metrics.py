"""Structural vectorization-activity metrics (paper §VII-A analogues).

The paper defines AVL (average active vector length) and IRR (instruction
reduction ratio) from ARM PMU events.  These are their structural
equivalents, computed from the circuit alone:

* ALO (average lane occupancy) — AVL analogue: active lanes per vector op.
* ORR (op-reduction ratio)     — IRR analogue: scalar-equivalent ops of the
  naive program over the VLA program's vector ops.
* AI                            — structural flops per streamed byte.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.gates import Gate
from repro_torch.core.target import Target


@dataclasses.dataclass
class GateCost:
    """Structural cost of applying one (fused) gate to an n-qubit state."""
    flops: float
    hbm_bytes: float
    vector_ops: float
    active_lanes: float

    @property
    def ai(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def gate_cost(g: Gate, n: int, target: Target,
              specialized: bool = False) -> GateCost:
    """Structural cost model.  ``specialized=True`` accounts for the
    engine's gate-class lowering: diagonal/permutation (monomial) gates
    apply as a 6-flop phase rotation per touched amplitude instead of the
    generic dense matvec (the permutation gather is memory traffic, not
    flops).  The default keeps the paper's generic model."""
    k = g.k
    groups = 1 << (n - k - len(g.controls))
    d = 1 << k
    touched = groups * d
    cls = g.gate_class
    row_budget = max(2, n - target.lane_qubits)
    if cls == "diagonal":
        fast = not g.controls or g.k + len(g.controls) <= row_budget
    else:
        fast = cls == "permutation" and not g.controls
    if specialized and fast:
        flops = touched * 6.0
    else:
        flops = groups * 2.0 * d * (4 * d - 2)
    # streamed bytes: touched amplitudes read+written once (re+im fp32)
    hbm_bytes = touched * 2 * 4 * 2.0
    v = target.lanes
    vector_ops = flops / (2.0 * v)          # 1 FMA-lane-op = 2 flops/lane
    return GateCost(flops=flops, hbm_bytes=hbm_bytes, vector_ops=vector_ops,
                    active_lanes=float(min(v, 1 << n)))


def circuit_cost(gates: Sequence[Gate], n: int, target: Target,
                 specialized: bool = False) -> GateCost:
    total_f = total_b = total_v = 0.0
    act = 0.0
    for g in gates:
        c = gate_cost(g, n, target, specialized=specialized)
        total_f += c.flops
        total_b += c.hbm_bytes
        total_v += c.vector_ops
        act += c.active_lanes * c.vector_ops
    return GateCost(flops=total_f, hbm_bytes=total_b, vector_ops=total_v,
                    active_lanes=act / max(total_v, 1.0))


def op_reduction_ratio(naive_gates: Sequence[Gate],
                       vla_gates: Sequence[Gate], n: int,
                       target: Target) -> float:
    """ORR: scalar-equivalent op count of the naive program over the VLA
    program's vector-op count (the paper's IRR, computed structurally)."""
    naive = circuit_cost(naive_gates, n, target)
    vla = circuit_cost(vla_gates, n, target)
    naive_scalar_ops = naive.flops / 2.0          # scalar FMA = 2 flops
    return naive_scalar_ops / max(vla.vector_ops, 1.0)


def roofline_time(flops: float, hbm_bytes: float, target: Target,
                  use_mxu: bool = False) -> dict:
    """Roofline projection of one circuit on one target."""
    peak = target.peak_flops_bf16 if use_mxu else target.peak_flops_f32
    t_c = flops / peak
    t_m = hbm_bytes / target.hbm_bw
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "bound": "compute" if t_c > t_m else "memory",
        "time_s": max(t_c, t_m),
    }
