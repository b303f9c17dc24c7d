"""Gate fusion — arithmetic-intensity adaptation (paper §IV-D).

Vertical fusion multiplies adjacent gates acting on the same qubit set (always
profitable — fewer state sweeps, same unitary size).  Horizontal fusion
tensor-expands gates on disjoint qubits into one unitary of up to ``2**f``
dimensions, raising arithmetic intensity at the cost of a bigger VMEM-resident
matrix.  ``choose_f`` picks ``f`` from the target's machine balance and VMEM
budget — the paper's "make AI close to the machine balance" rule, and the knob
its Fig-10 sensitivity study sweeps.

The AI model reproduces the paper's formula and an idealized streaming model:

* ``ai_paper(f, num_vals)`` = 2(3·2^{2f} + 2^f(2^f−1)) / (numVals · 2^{f+3})
* ``ai_stream(f)``          = 2^{f-1}  flops/byte
  (per amplitude: 2^f complex MACs = 8·2^f real flops over 16 streamed bytes)

Validation against the paper (tests/test_fusion.py): plugging the ARM
platforms' balance points into ``choose_f`` returns f=3–4 on Grace, f=3 on
Graviton, f=2–3 on A64FX — exactly the optima the paper measures.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from repro_torch.core.gates import Gate, expand_unitary, gate_class
from repro_torch.core.target import Target


def ai_paper(f: int, num_vals: int) -> float:
    return 2.0 * (3 * (1 << (2 * f)) + (1 << f) * ((1 << f) - 1)) / (
        num_vals * (1 << (f + 3)))


def ai_stream(f: int) -> float:
    return float(1 << (f - 1))


def choose_f(target: Target, max_f: int = 7, dtype_bytes: int = 4,
             use_mxu: bool = False) -> int:
    """Largest f whose streamed AI stays at/under machine balance and whose
    unitary + state block fit the VMEM budget."""
    balance = (target.machine_balance_bf16 if use_mxu
               else target.machine_balance_f32)
    best = 2
    for f in range(2, max_f + 1):
        u_bytes = 2 * dtype_bytes * (1 << f) ** 2          # re+im planes
        blk_bytes = 2 * dtype_bytes * (1 << f) * max(target.lanes, 1) * 8
        if u_bytes + blk_bytes > target.vmem_bytes // 4:
            break
        best = f
        if ai_stream(f) >= balance:
            break
    return best


@dataclasses.dataclass
class _Cluster:
    qubits: tuple[int, ...]            # sorted
    members: list[int]                 # indices into the preprocessed gate list
    controls: tuple[int, ...] = ()
    cls: str = "general"               # composed structural class
    special: bool = False              # class-aware mode: matmul-free cluster
    has_diag: bool = False             # any member classified diagonal


def _combine_cls(a: str, b: str) -> str:
    """Class algebra under matrix product: diag·diag stays diagonal, any mix
    of diagonal/permutation is monomial ("permutation"), general absorbs."""
    if "general" in (a, b):
        return "general"
    if a == b == "diagonal":
        return "diagonal"
    return "permutation"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One fused-gate cluster, in terms of preprocessed gate indices.

    ``members`` index the list returned alongside by :func:`cluster_gates`,
    in application order (earliest first).  Consumers that need the fused
    unitary as a function of gate matrices (e.g. the engine's parameterized
    plan compiler) re-derive it from the members; :func:`realize_cluster`
    gives the concrete numpy unitary.

    ``cls`` is the composed structural class of the members (for controlled
    clusters: of the target matrices).  It is conservative — a "permutation"
    (monomial) cluster whose net index permutation turns out to be the
    identity (e.g. QAOA's CNOT·RZ·CNOT blocks) is refined to diagonal by the
    plan compiler at lowering time.
    """

    qubits: tuple[int, ...]            # sorted union of member targets
    controls: tuple[int, ...] = ()
    members: tuple[int, ...] = ()
    cls: str = "general"


def _normalize(g: Gate) -> Gate:
    """Reorder targets ascending (canonical form for fusion bookkeeping)."""
    if list(g.qubits) == sorted(g.qubits):
        return g
    q_sorted = tuple(sorted(g.qubits))
    m = expand_unitary(g.qubits, g.matrix, q_sorted)
    return Gate(q_sorted, m, controls=g.controls, name=g.name)


@functools.lru_cache(maxsize=4096)
def _control_maps(span: int, tpos: tuple[int, ...], cmask: int,
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static index maps for control absorption (mirrors ``_embed_maps``).

    Returns ``(sel, a_in, rows)``: the control-satisfied columns of the
    ``2**span`` space, the target-subspace index each selects from the gate
    matrix, and ``rows[a_out, c]`` — the full-space row that matrix entry
    ``[a_out, a_in[c]]`` lands in for column ``sel[c]``.
    """
    idx = np.arange(1 << span, dtype=np.int64)
    sel = idx[(idx & cmask) == cmask]
    a_in = np.zeros_like(sel)
    tmask = 0
    for bi, p in enumerate(tpos):
        a_in |= ((sel >> p) & 1) << bi
        tmask |= 1 << p
    a_out = np.arange(1 << len(tpos), dtype=np.int64)
    spread = np.zeros_like(a_out)
    for bi, p in enumerate(tpos):
        spread |= ((a_out >> bi) & 1) << p
    rows = (sel & ~tmask)[None, :] | spread[:, None]
    return sel, a_in, rows


def _expand_controls(g: Gate, max_expand: int) -> Gate:
    """Absorb small control sets into an explicit unitary (enables fusion).

    Pure numpy index arithmetic over cached structural maps — no Python
    loop over matrix entries, so re-compiles of controlled-gate-heavy
    structures (QFT's cphase ladder, QAOA's CNOT pairs) stay cheap.
    """
    if not g.controls or g.k + len(g.controls) > max_expand:
        return g
    full = tuple(sorted(g.qubits + g.controls))
    pos = {q: i for i, q in enumerate(full)}
    cmask = 0
    for c in g.controls:
        cmask |= 1 << pos[c]
    sel, a_in, rows = _control_maps(len(full), tuple(pos[q] for q in g.qubits),
                                    cmask)
    out = np.eye(1 << len(full), dtype=np.complex64)
    out[:, sel] = 0
    out[rows, np.broadcast_to(sel, rows.shape)] = g.matrix[:, a_in]
    return Gate(full, out, name=f"x{g.name}")


def cluster_gates(gates: Sequence[Gate], f: int,
                  expand_controls_up_to: int = 2,
                  diag_f: int | None = None,
                  classes: Sequence[str | None] | None = None,
                  ) -> tuple[list[Gate], list[ClusterSpec]]:
    """Greedy vertical + horizontal clustering (Qsim-style) with degree ``f``.

    Returns ``(prep, clusters)`` where ``prep`` is the preprocessed gate list
    (controls absorbed into explicit unitaries when the span fits in
    ``expand_controls_up_to`` qubits, targets reordered ascending), aligned
    1:1 with the input, and ``clusters`` reference ``prep`` by index.  This is
    the reusable structural half of fusion: it depends only on gate *kinds and
    wiring*, never on matrix values, so one clustering serves every parameter
    binding of a circuit template.

    Class-aware mode (``diag_f`` set): control-free diagonal/permutation
    gates cluster only with each other, and those clusters may grow up to
    ``diag_f`` qubits instead of ``f`` — a diagonal/monomial cluster composes
    into a length-``2**w`` phase vector (plus a static index map), never a
    dense matrix, so widening it raises fusion reduction *without* raising
    flops.  Callers derive ``diag_f`` from the canonical row-budget rule
    (:func:`repro_torch.core.target.row_budget` via
    :func:`repro_torch.engine.plan.resolve_diag_f`) — this function never computes
    the cap itself, so clustering and lowering cannot disagree about it.
    ``classes`` optionally overrides the per-gate structural class
    (aligned with ``gates``; ``None`` entries fall back to classifying the
    preprocessed matrix) — the engine uses it to mark parameterized rotations
    whose class is angle-independent (rz/phase: diagonal) or angle-dependent
    (rx/ry: general, whatever the dummy binding looks like).

    Controlled gates whose span exceeds the expansion budget (e.g. Grover's
    multi-controlled Z) stay controlled and act as fusion barriers on their
    qubits.
    """
    prep: list[Gate] = []
    clusters: list[_Cluster] = []
    last_touch: dict[int, int] = {}     # qubit -> cluster index

    for idx, g0 in enumerate(gates):
        g = _expand_controls(g0, expand_controls_up_to)
        g = _normalize(g)
        prep.append(g)
        gi = len(prep) - 1
        if diag_f is None and classes is None:
            cls = "general"          # generic mode never reads the class
        else:
            cls = classes[idx] if classes is not None and classes[idx] else None
            if cls is None:
                cls = gate_class(g.matrix)
        special = diag_f is not None and not g.controls and cls != "general"
        touched = set(g.qubits) | set(g.controls)
        dep = max((last_touch.get(q, -1) for q in touched), default=-1)
        placed = False
        if g.controls:
            # controlled gate: only vertical fusion with an identical cluster
            if (dep >= 0 and clusters[dep].controls == g.controls
                    and clusters[dep].qubits == g.qubits
                    and all(last_touch.get(q, -1) == dep for q in touched)):
                clusters[dep].members.append(gi)
                clusters[dep].cls = _combine_cls(clusters[dep].cls, cls)
                clusters[dep].has_diag = (clusters[dep].has_diag
                                          or cls == "diagonal")
                placed = True
        else:
            # try the dependency cluster first, then the most recent cluster
            for ci in dict.fromkeys([dep, len(clusters) - 1]):
                if ci < 0 or ci >= len(clusters) or clusters[ci].controls:
                    continue
                c = clusters[ci]
                # class-aware mode mixing rules:
                # * a special gate may ride a general cluster it does not
                #   widen (vertical fusion is free: no extra flops, one
                #   fewer sweep — Grover's X layer over the diffusion Hs);
                # * a general gate may absorb a *narrow* special cluster
                #   (downgrade to dense, restoring the generic clustering
                #   when classes interleave — no extra sweeps vs generic);
                # * otherwise classes never mix.
                downgrade = False
                if diag_f is not None and c.special != special:
                    if special and set(g.qubits) <= set(c.qubits):
                        pass                       # free rider
                    elif not special and c.special:
                        downgrade = True           # width-checked below
                    else:
                        continue
                # widening past f is reserved for diagonal content: a phase
                # vector costs O(2**w) memory and no matmul, while a pure
                # permutation cluster gains nothing from extra width
                if diag_f is not None and c.special and not downgrade and (
                        cls == "diagonal" or c.has_diag):
                    cap = diag_f
                else:
                    cap = f
                cand = tuple(sorted(set(c.qubits) | set(g.qubits)))
                if len(cand) > cap:
                    continue
                # all of g's qubits must not be touched by any later cluster
                if any(last_touch.get(q, -1) > ci for q in touched):
                    continue
                # growing the cluster must not skip later clusters touching
                # the new qubits
                new_qs = set(cand) - set(c.qubits)
                if any(last_touch.get(q, -1) > ci for q in new_qs):
                    continue
                c.qubits = cand
                c.members.append(gi)
                c.cls = _combine_cls(c.cls, cls)
                c.has_diag = c.has_diag or cls == "diagonal"
                if downgrade:
                    c.special = False
                for q in touched:
                    last_touch[q] = ci
                placed = True
                break
        if not placed:
            clusters.append(_Cluster(tuple(sorted(g.qubits)), [gi],
                                     controls=g.controls, cls=cls,
                                     special=special,
                                     has_diag=cls == "diagonal"))
            ci = len(clusters) - 1
            for q in touched:
                last_touch[q] = ci

    specs = [ClusterSpec(qubits=c.qubits, controls=c.controls,
                         members=tuple(c.members), cls=c.cls)
             for c in clusters]
    return prep, specs


def realize_cluster(spec: ClusterSpec, prep: Sequence[Gate]) -> Gate:
    """Fold a cluster's member matrices into one concrete fused ``Gate``."""
    members = [prep[i] for i in spec.members]
    if spec.controls:
        m = members[0].matrix
        for later in members[1:]:
            m = (later.matrix @ m).astype(np.complex64)
        return Gate(members[0].qubits, m, controls=spec.controls,
                    name=f"fused{len(members)}")
    out = np.eye(1 << len(spec.qubits), dtype=np.complex64)
    for g in members:
        out = expand_unitary(g.qubits, g.matrix, spec.qubits) @ out
    return Gate(spec.qubits, out.astype(np.complex64),
                name=f"fused{len(members)}")


def fuse_circuit(gates: Sequence[Gate], f: int,
                 expand_controls_up_to: int = 2) -> list[Gate]:
    """Greedy vertical + horizontal fusion with degree ``f``.

    Clustering (:func:`cluster_gates`) decides *which* gates merge; this
    realizes each cluster into a concrete fused unitary.
    """
    prep, specs = cluster_gates(gates, f, expand_controls_up_to)
    return [realize_cluster(s, prep) for s in specs]
