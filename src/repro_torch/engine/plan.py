"""Plan compiler + cache: one fused program per circuit structure.

``compile_plan`` runs fusion clustering once per :class:`CircuitTemplate`
structure and lowers the fused gate sequence into a list of
:class:`PlanItem` s for the chosen backend (dense / planar / cuda).
Parameterized rotations are spliced into their fused clusters as batched
torch matrices — constant member gates are folded into numpy constants at
compile time, so the per-binding work is a handful of 2x2-sized complex
products before each fused gate application.

The program runs eagerly over a batch: the state carries a leading batch
axis ``[B, 2, R, V]`` (``[B, 2**n]`` complex on the dense backend), and each
item's unitary / phase planes are built per binding with the same leading
axis (extent 1 for a constant item, which the kernels broadcast).  On the
``cuda`` backend every ``dense`` item is one launch of the fused-gate kernel
and every ``diag`` / ``perm`` item one launch of the diagonal/permutation
kernel (each wrapper runs its plain version for a CPU state); ``planar``
runs those plain versions on any device, and ``dense`` is the complex64
gate-by-gate oracle.

``PlanCache`` memoizes compiled plans by structure hash and execution
config: a parameter sweep of B structurally identical circuits costs one
fusion pass.  Plans are device-agnostic: device copies of an item's
constants are made at first use on a device and kept with the item.

A *result-mode* plan (``compile_plan(..., result=ResultSpec)``) appends
``channel`` items and a terminal ``result`` item to the gate items;
``run_result`` / ``run_batch_result_raw`` run the gate prefix through the
same steps as ``run_batch_raw`` (one launch per item over the batch), then
the noise channels and the epilogue — shot sampling or the Pauli-observable
reductions — and hand back payloads instead of states.  Randomness comes
from per-row generators seeded from the row's ``(request key,
trajectory)``, never from batch position, and the channel and epilogue
steps reduce each row on its own, so a row's draws do not depend on the
batch around it.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import apply as A
from repro_torch.core import measure as ME
from repro_torch.core import statevec as SV
from repro_torch.core.circuits import Circuit
from repro_torch.core.fusion import choose_f, cluster_gates, realize_cluster
from repro_torch.core.gates import (Gate, expand_unitary, gate_class,
                                    monomial_decompose)
from repro_torch.core.target import Target, row_budget
from repro_torch.engine import results as RS
from repro_torch.engine.telemetry import Histogram, vectorization_profile
from repro_torch.engine.template import (PARAM_KINDS, CircuitTemplate,
                                         TemplateOp, template_of)
from repro_torch.kernels.apply_gate import ops as K
from repro_torch.kernels.apply_gate import ref as R
from repro_torch.kernels.expectation import ops as E

BACKENDS = ("dense", "planar", "cuda")

# Structural class of a parameterized op, valid for *every* angle — the dummy
# binding used for clustering sees rx(0) = I, which would misclassify rx as
# diagonal, so the class must come from the op kind, not the bound matrix.
PARAM_OP_CLASS = {"rz": "diagonal", "phase": "diagonal",
                  "rx": "general", "ry": "general"}

# Diagonal param kinds are pure phases exp(i * theta * c[bit]): rz_m is
# diag(e^{-i theta/2}, e^{+i theta/2}), phase_m is diag(1, e^{i phi}).  The
# specialized lowering turns each such member into a static per-row angle
# coefficient vector, so a binding costs one axpy per rotation plus a single
# cos/sin — no matrix construction.
DIAG_PARAM_COEFF = {"rz": (-0.5, 0.5), "phase": (0.0, 1.0)}

# Index maps over a cluster space of at most this many bits are memoized.
# Wider ones (diagonal clusters reach n - lane_qubits bits) are recomputed:
# one map per member gate at 2**w int64 entries would otherwise hold tens of
# GB at n = 30.
_CACHED_MAP_BITS = 16

# Salts of the result-mode program's random streams (the JAX package's): a
# row's channel stream i and its shot stream are seeded from
# ``mix64(request key, trajectory, salt)``.
_CHANNEL_SALT = 0x00C0FFEE  # + channel index
_SHOT_SALT = 0x5A17
_TINY32 = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=4096)
def _embed_maps(sub_qubits: tuple[int, ...], full_qubits: tuple[int, ...],
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static gather maps embedding a small unitary into a cluster space.

    For ``u`` on ``sub_qubits`` inside ``full_qubits`` the expanded matrix is
    ``where(mask, u[sr, sc], 0)`` — ``expand_unitary`` as one batched gather.
    """
    pos = {q: i for i, q in enumerate(full_qubits)}
    sub_pos = np.array([pos[q] for q in sub_qubits], np.int64)
    rest_pos = np.array([i for i in range(len(full_qubits))
                         if i not in set(sub_pos.tolist())], np.int64)
    idx = np.arange(1 << len(full_qubits), dtype=np.int64)

    def gather_bits(positions):
        out = np.zeros_like(idx)
        for bi, p in enumerate(positions):
            out |= ((idx >> p) & 1) << bi
        return out

    sub = gather_bits(sub_pos)
    rest = gather_bits(rest_pos)
    mask = rest[:, None] == rest[None, :]
    sr = np.ascontiguousarray(np.broadcast_to(sub[:, None], mask.shape))
    sc = np.ascontiguousarray(np.broadcast_to(sub[None, :], mask.shape))
    return mask, sr, sc


def _param_matrix(op: TemplateOp, params: torch.Tensor) -> torch.Tensor:
    """c64[B, 2, 2] rotation of ``op`` for each row of ``params`` [B, P]."""
    return PARAM_KINDS[op.kind].torch_fn(op.scale * params[:, op.param])


def _compute_sub_index_map(sub_qubits: tuple[int, ...],
                           full_qubits: tuple[int, ...]) -> np.ndarray:
    pos = {q: i for i, q in enumerate(full_qubits)}
    idx = np.arange(1 << len(full_qubits), dtype=np.int64)
    out = np.zeros_like(idx)
    for bi, q in enumerate(sub_qubits):
        out |= ((idx >> pos[q]) & 1) << bi
    return out


_cached_sub_index_map = functools.lru_cache(maxsize=4096)(
    _compute_sub_index_map)


def _sub_index_map(sub_qubits: tuple[int, ...], full_qubits: tuple[int, ...],
                   ) -> np.ndarray:
    """int64[2**w]: the sub-space index formed by ``sub_qubits``' bits at
    each index of the ``full_qubits`` cluster space (callers never write to
    it)."""
    if len(full_qubits) <= _CACHED_MAP_BITS:
        return _cached_sub_index_map(sub_qubits, full_qubits)
    return _compute_sub_index_map(sub_qubits, full_qubits)


def _member_monomial(g: Gate, full_qubits: tuple[int, ...],
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Lift a diagonal/monomial member gate into cluster space as
    ``(P, phi)`` with ``out[x] = phi[x] * in[P[x]]``."""
    perm_s, phase_s = monomial_decompose(g.matrix)
    sub = _sub_index_map(g.qubits, full_qubits)
    pos = {q: i for i, q in enumerate(full_qubits)}
    mask = 0
    for q in g.qubits:
        mask |= 1 << pos[q]
    x = np.arange(1 << len(full_qubits), dtype=np.int64)
    src = perm_s[sub]                       # sub-space source per cluster index
    scat = np.zeros_like(x)
    for bi, q in enumerate(g.qubits):
        scat |= ((src >> bi) & 1) << pos[q]
    return (x & ~mask) | scat, phase_s[sub]


def _apply_member_diagonal(const: np.ndarray, g: Gate,
                           full_qubits: tuple[int, ...]) -> np.ndarray:
    """``phi_M * const`` for a diagonal member ``M`` (``P_M`` is the
    identity), with ``phi_M`` broadcast from the member's ``2**k`` diagonal
    over the cluster space instead of gathered through a ``2**w`` index
    map.  Elementwise the same products as ``_member_monomial``'s
    ``phi_m * const[p_m]``, so the result is bitwise equal."""
    w = len(full_qubits)
    k = g.k
    pos = {q: i for i, q in enumerate(full_qubits)}
    # axis a of the member's (2,)*k diagonal holds its bit k-1-a; axis j of
    # the cluster's (2,)*w view holds cluster bit w-1-j
    axes = [w - 1 - pos[g.qubits[k - 1 - a]] for a in range(k)]
    diag = np.transpose(np.diagonal(g.matrix).reshape((2,) * k),
                        np.argsort(axes))
    shape = [1] * w
    for j in axes:
        shape[j] = 2
    return (diag.reshape(shape) * const.reshape((2,) * w)
            ).astype(np.complex64).reshape(-1)


_IDENTITY_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class PlanItem:
    """One fused gate application inside the compiled program.

    ``kind`` selects the lowering:

    * ``"dense"`` — generic ``2**w x 2**w`` complex matvec (4 real matmuls),
      built from ``factors``.
    * ``"diag"``  — elementwise phase rotation by ``phase_planes(params)``
      (6 real flops/amp, no matmul).  Controls, if any, were folded into the
      phase vector, so ``controls`` is empty.
    * ``"perm"``  — static index-map gather ``perm`` over the cluster space,
      optionally followed by the phase rotation (monomial clusters).
    * ``"channel"`` — one Kraus noise channel, executed by stochastic
      trajectory unraveling: one branch per row is drawn with the
      probability of its squared norm and renormalized (result-mode plans
      only).
    * ``"result"`` — the terminal epilogue item carrying the
      :class:`~repro_torch.engine.results.ResultSpec`: shot sampling or the
      observable reductions after the last gate, so non-statevector
      payloads never hand the state back (paper §IV).

    Methods taking ``params`` expect a float32 ``[B, P]`` tensor and return
    tensors with a leading axis of extent B (or 1 for constants) on its
    device.
    """

    qubits: tuple[int, ...]
    controls: tuple[int, ...]
    factors: tuple = ()             # ("const", ndarray) | ("param", op, maps)
    kind: str = "dense"             # dense | diag | perm | channel | result
    perm: np.ndarray | None = None  # int32[2**w], kind == "perm" only
    phases: tuple = ()              # ("const", vec) | ("param", op, coeff)
    generic_flops: float | None = None  # flops/amp of the dense alternative
    kraus: tuple = ()               # complex64 operators, kind == "channel"
    result: object = None           # ResultSpec, kind == "result" only
    # device copies of the constants above, made at first use on a device
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @property
    def is_constant(self) -> bool:
        return (all(f[0] == "const" for f in self.factors)
                and all(p[0] == "const" for p in self.phases))

    def _on(self, device: torch.device, key, make: Callable):
        per_dev = self._dev.setdefault(device, {})
        t = per_dev.get(key)
        if t is None:
            t = per_dev[key] = make()
        return t

    def held_bytes(self) -> dict[str, int]:
        """Bytes of the device copies this item holds, per device."""
        out: dict[str, int] = {}
        for dev, per_dev in self._dev.items():
            ts = [t for v in per_dev.values() if v is not None
                  for t in (v if isinstance(v, tuple) else (v,))]
            out[str(dev)] = sum(t.numel() * t.element_size() for t in ts)
        return out

    def unitary(self, params: torch.Tensor) -> torch.Tensor:
        """Fused c64[B|1, 2**w, 2**w] unitary for each binding."""
        dev = params.device
        u = None
        for i, f in enumerate(self.factors):
            if f[0] == "const":
                e = self._on(dev, ("factor", i), lambda f=f: torch.as_tensor(
                    np.asarray(f[1], np.complex64), device=dev)[None])
            else:
                _, op, maps = f
                mask, sr, sc = self._on(dev, ("maps", i), lambda maps=maps: tuple(
                    torch.as_tensor(m, device=dev) for m in maps))
                m2 = _param_matrix(op, params)
                e = torch.where(mask, m2[:, sr, sc],
                                torch.zeros((), dtype=torch.complex64,
                                            device=dev))
            u = e if u is None else torch.matmul(e, u)
        return u

    def unitary_planes(self, params: torch.Tensor,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Contiguous f32 (re, im) planes of :meth:`unitary`; a constant
        item's planes are made once per device."""
        if self.is_constant:
            def make():
                u = self.unitary(params[:0])
                return u.real.contiguous(), u.imag.contiguous()
            return self._on(params.device, "planes", make)
        u = self.unitary(params)
        return u.real.contiguous(), u.imag.contiguous()

    def _phase_angle(self, params: torch.Tensor) -> torch.Tensor | None:
        """f32[B, 2**w] accumulated rotation angle of the parameterized
        phase terms: one scalar-times-static-coefficient-vector axpy per
        term."""
        ang = None
        for i, p in enumerate(self.phases):
            if p[0] != "param":
                continue
            _, op, coeff = p
            c = self._on(params.device, ("coeff", i),
                         lambda coeff=coeff: torch.as_tensor(
                             coeff, device=params.device))
            a = params[:, op.param:op.param + 1] * c[None]
            ang = a if ang is None else ang + a
        return ang

    def _np_const_phase(self) -> np.ndarray | None:
        """Product of the constant phase entries (numpy), or None."""
        v = None
        for p in self.phases:
            if p[0] == "const":
                v = p[1] if v is None else (v * p[1]).astype(np.complex64)
        return v

    def phase_planes(self, params: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 (re, im) planes ``[B|1, 2**w]`` of the phase vector —
        cos/sin directly, no complex intermediates."""
        dev = params.device

        def const_planes():
            const = self._np_const_phase()
            if const is None:
                return None
            return (torch.as_tensor(np.real(const).astype(np.float32),
                                    device=dev)[None],
                    torch.as_tensor(np.imag(const).astype(np.float32),
                                    device=dev)[None])

        const = self._on(dev, "const_phase", const_planes) \
            if any(p[0] == "const" for p in self.phases) else None
        ang = self._phase_angle(params)
        if ang is None:
            return const
        c, s = torch.cos(ang), torch.sin(ang)
        if const is None:
            return c, s
        cr, ci = const
        return c * cr - s * ci, c * ci + s * cr

    def perm_tensor(self, device: torch.device) -> torch.Tensor:
        """int32 ``perm`` on ``device`` (kind == "perm" only)."""
        return self._on(device, "perm", lambda: torch.as_tensor(
            np.asarray(self.perm, np.int32), device=device))

    def kraus_planes(self, device: torch.device,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 (re, im) planes ``[K, 2**w, 2**w]`` of the Kraus operators on
        ``device`` (kind == "channel" only)."""
        def make():
            ks = np.stack(self.kraus)
            return (torch.as_tensor(ks.real.astype(np.float32), device=device),
                    torch.as_tensor(ks.imag.astype(np.float32), device=device))
        return self._on(device, "kraus", make)


def _lower_controlled_diag(g: Gate) -> PlanItem:
    """Lower a controlled cluster with a diagonal target into one phase
    vector over the full span (targets + controls): the full operator is
    diagonal — identity except where every control bit is set."""
    span = tuple(sorted(g.qubits + g.controls))
    pos = {q: i for i, q in enumerate(span)}
    cmask = 0
    for c in g.controls:
        cmask |= 1 << pos[c]
    idx = np.arange(1 << len(span), dtype=np.int64)
    sel = (idx & cmask) == cmask
    sub = _sub_index_map(g.qubits, span)
    phase = np.ones(1 << len(span), np.complex64)
    phase[sel] = np.diagonal(g.matrix)[sub[sel]]
    # the dense alternative is an 8*2^k matvec on the control-satisfied
    # 2^-c fraction of amplitudes
    generic = 8.0 * (1 << g.k) / (1 << len(g.controls))
    return PlanItem(span, (), kind="diag", phases=(("const", phase),),
                    generic_flops=generic)


def _lower_special(spec, prep: Sequence[Gate],
                   ops: Sequence[TemplateOp]) -> PlanItem | None:
    """Lower a diagonal/monomial cluster to a static index map + phase
    vector — the matmul-free fast path.

    The accumulated transform of the members applied so far is
    ``out[x] = phi[x] * in[pi[x]]``.  Applying the next member ``M = (P_M,
    phi_M)`` composes as ``phi' = phi_M * phi[P_M]``, ``pi' = pi[P_M]``;
    parameterized members (rz/phase) are purely diagonal, so their traced
    phase joins as one more factor.  If the net permutation is the identity
    the cluster is *refined* to a pure diagonal (QAOA's CNOT·RZ·CNOT
    blocks); if the whole transform is the identity the item is elided.
    """
    w = len(spec.qubits)
    pi = np.arange(1 << w, dtype=np.int64)
    const = np.ones(1 << w, np.complex64)
    params: list = []                # [op, coeff_vec f32] — mutable coeff
    for i in spec.members:
        op = ops[i]
        g = prep[i]
        if op.kind == "fixed" and gate_class(g.matrix) == "diagonal":
            const = _apply_member_diagonal(const, g, spec.qubits)
        elif op.kind == "fixed":
            p_m, phi_m = _member_monomial(g, spec.qubits)
            const = (phi_m * const[p_m]).astype(np.complex64)
            for t in params:
                t[1] = t[1][p_m]
            pi = pi[p_m]
        else:
            if op.kind not in DIAG_PARAM_COEFF:
                raise AssertionError(
                    f"non-diagonal param op {op.kind!r} in special cluster")
            c0, c1 = DIAG_PARAM_COEFF[op.kind]
            bits = _sub_index_map(op.qubits, spec.qubits)
            coeff = (op.scale * np.where(bits == 1, c1, c0)).astype(np.float32)
            params.append([op, coeff])
    phases: list = []
    if np.abs(const - 1.0).max() > _IDENTITY_ATOL:
        phases.append(("const", const))
    phases += _merge_param_coeffs(params)
    is_id_perm = bool(np.array_equal(pi, np.arange(1 << w)))
    if is_id_perm and not phases:
        return None                        # identity cluster (e.g. CNOT·CNOT)
    generic = 8.0 * (1 << w)               # the dense matvec this replaces
    if is_id_perm:
        return PlanItem(spec.qubits, (), kind="diag", phases=tuple(phases),
                        generic_flops=generic)
    return PlanItem(spec.qubits, (), kind="perm", perm=pi.astype(np.int32),
                    phases=tuple(phases), generic_flops=generic)


def _merge_param_coeffs(terms) -> list:
    """Fold ``(op, coeff_vec)`` phase terms per distinct parameter index:
    ``exp(i p c1) exp(i p c2) = exp(i p (c1 + c2))`` — one axpy per
    *distinct* parameter, not per gate."""
    merged: dict[int, list] = {}
    for op, coeff in terms:
        if op.param in merged:
            merged[op.param][1] = merged[op.param][1] + coeff
        else:
            merged[op.param] = [op, coeff]
    return [("param", op, coeff) for op, coeff in merged.values()]


def _merge_diag_items(run: list[PlanItem]) -> PlanItem:
    """Compose a run of consecutive diagonal items into one item over the
    union of their qubits: constants multiply, angle-coefficient vectors
    add (re-merged per distinct parameter)."""
    qubits = tuple(sorted(set().union(*[set(it.qubits) for it in run])))
    const = np.ones(1 << len(qubits), np.complex64)
    has_const = False
    terms: list = []
    for it in run:
        sub = _sub_index_map(it.qubits, qubits)
        for p in it.phases:
            if p[0] == "const":
                const = (const * p[1][sub]).astype(np.complex64)
                has_const = True
            else:
                _, op, coeff = p
                terms.append((op, coeff[sub].astype(np.float32)))
    phases: list = []
    if has_const:
        phases.append(("const", const))
    phases += _merge_param_coeffs(terms)
    generic = sum(it.generic_flops or 8.0 * (1 << len(it.qubits))
                  for it in run)
    return PlanItem(qubits, (), kind="diag", phases=tuple(phases),
                    generic_flops=generic)


def _coalesce_diag_runs(items: list[PlanItem]) -> list[PlanItem]:
    """Merge adjacent diagonal items (they commute and compose elementwise)
    into single full-width rotations — one state sweep for a QAOA cost
    stack.  Used by the planar backend, whose diagonal application is pure
    elementwise arithmetic at any width; the cuda backend keeps one kernel
    launch per item, so its item list matches the JAX package's pallas
    backend item for item."""
    out: list[PlanItem] = []
    run: list[PlanItem] = []

    def flush():
        if run:
            out.append(run[0] if len(run) == 1 else _merge_diag_items(run))
            run.clear()

    for item in items:
        if item.kind == "diag":
            run.append(item)
            continue
        flush()
        out.append(item)
    flush()
    return out


def _lower_cluster(spec, prep: Sequence[Gate], ops: Sequence[TemplateOp],
                   diag_cap: int | None = None) -> PlanItem | None:
    """Fold a cluster into a plan item: the matmul-free diag/perm fast path
    when the cluster's class allows it (``diag_cap`` set = specialization
    on), else constant factors with param gates spliced in."""
    if spec.controls:
        # controlled clusters never contain parameterized members (param ops
        # are control-free, so clustering keeps them out) — fold in numpy.
        for i in spec.members:
            if ops[i].kind != "fixed":
                raise AssertionError("parameterized op in controlled cluster")
        g = realize_cluster(spec, prep)
        if (diag_cap is not None and spec.cls == "diagonal"
                and g.k + len(g.controls) <= diag_cap):
            return _lower_controlled_diag(g)
        return PlanItem(g.qubits, g.controls, (("const", g.matrix),))

    if diag_cap is not None and spec.cls in ("diagonal", "permutation"):
        return _lower_special(spec, prep, ops)

    factors: list = []
    acc: np.ndarray | None = None
    for i in spec.members:
        op = ops[i]
        g = prep[i]
        if op.kind == "fixed":
            e = expand_unitary(g.qubits, g.matrix, spec.qubits)
            acc = e if acc is None else (e @ acc).astype(np.complex64)
        else:
            if acc is not None:
                factors.append(("const", acc))
                acc = None
            factors.append(
                ("param", op, _embed_maps(op.qubits, spec.qubits)))
    if acc is not None or not factors:
        factors.append(("const", acc if acc is not None
                        else np.eye(1 << len(spec.qubits), dtype=np.complex64)))
    return PlanItem(spec.qubits, (), tuple(factors))


def _lower_single(op: TemplateOp, g: Gate) -> PlanItem:
    """Lower one unfused gate (dense baseline / fuse=False paths)."""
    if op.kind == "fixed":
        return PlanItem(g.qubits, g.controls, (("const", g.matrix),))
    k = len(op.qubits)
    ident = tuple(range(k))
    return PlanItem(op.qubits, op.controls,
                    (("param", op, _embed_maps(ident, ident)),))


@dataclasses.dataclass
class CompiledPlan:
    """A fused execution program for one template structure."""

    template: CircuitTemplate
    backend: str
    target: Target
    f: int
    items: list[PlanItem]
    specialize: bool = True
    # non-None for result-mode plans: the spec the terminal "result" item
    # carries, duplicated here so execution paths never walk the item list
    result: "RS.ResultSpec | None" = None
    compile_seconds: float = 0.0
    # static vectorization profile (ALO/ORR/AI/fast-path coverage), computed
    # once by compile_plan via repro_torch.engine.telemetry
    profile: "object | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    cache_stats: "CacheStats | None" = dataclasses.field(
        default=None, repr=False)
    #: guarded-by: _plock
    _steps: list | None = dataclasses.field(default=None, repr=False)
    #: guarded-by: _plock
    _result_steps: tuple | None = dataclasses.field(default=None, repr=False)
    _plock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.template.n

    @property
    def num_params(self) -> int:
        return self.template.num_params

    # -- per-class stats ------------------------------------------------------
    def class_counts(self) -> dict:
        """Fused-gate counts by lowering class (diag/perm items are the
        matmul-free fast paths; dense items take the generic matvec)."""
        counts = {"diagonal": 0, "permutation": 0, "general": 0,
                  "channel": 0, "result": 0}
        for item in self.items:
            counts[{"diag": "diagonal", "perm": "permutation",
                    "channel": "channel", "result": "result"}.get(
                item.kind, "general")] += 1
        return counts

    def held_bytes(self) -> dict[str, int]:
        """Bytes of the items' device copies (unitaries, phase planes, index
        maps), per device.  They live as long as the plan does."""
        out: dict[str, int] = {}
        for item in self.items:
            for dev, nb in item.held_bytes().items():
                out[dev] = out.get(dev, 0) + nb
        return out

    def flops_per_amp(self) -> dict:
        """Estimated real flops per state amplitude: actual (per-class
        lowering) vs generic (each item as the dense matvec it replaces,
        weighted by the control-satisfied ``2**-c`` fraction)."""
        generic = actual = 0.0
        for item in self.items:
            if item.kind == "result":
                continue          # reduction epilogue, not a gate lowering
            if item.kind == "channel":
                # every Kraus branch pays a dense matvec; there is no
                # cheaper generic alternative to compare against
                g = item.generic_flops if item.generic_flops is not None \
                    else 8.0 * (1 << len(item.qubits)) * len(item.kraus)
                generic += g
                actual += g
                continue
            dense = (8.0 * (1 << len(item.qubits))
                     / (1 << len(item.controls)))
            g = item.generic_flops if item.generic_flops is not None else dense
            generic += g
            if item.kind in ("diag", "perm"):
                # phase-free permutations are pure memory traffic
                actual += 6.0 if item.phases else 0.0
            else:
                actual += dense
        return {"flops_per_amp_generic": generic,
                "flops_per_amp_actual": actual,
                "flops_saved_frac": 1.0 - actual / generic if generic else 0.0}

    def with_backend(self, backend: str) -> "CompiledPlan":
        """The same compiled items run by ``backend``'s steps, without a
        second compile: ``planar`` runs a ``cuda`` plan's items with the
        plain versions (and ``cuda`` a ``planar`` plan's with the kernels).
        The new plan builds its own steps; it shares only the items."""
        if {backend, self.backend} - {"planar", "cuda"}:
            raise ValueError(f"{self.template.name}: cannot run a "
                             f"{self.backend!r} plan's items on {backend!r}; "
                             f"only planar and cuda share an item list")
        return CompiledPlan(template=self.template, backend=backend,
                            target=self.target, f=self.f, items=self.items,
                            specialize=self.specialize, result=self.result,
                            compile_seconds=self.compile_seconds,
                            profile=self.profile)

    # -- program construction -------------------------------------------------
    def _step(self, item: PlanItem):
        """The per-item function ``(state, params) -> state`` for this
        plan's backend."""
        n = self.n
        if item.kind in ("diag", "perm"):
            return self._special_step(item)
        if self.backend == "dense":
            def step(psi, params):
                return A.apply_gate_dense(psi, n, item.qubits,
                                          item.unitary(params), item.controls)
            return step
        fn = R.apply_fused_gate_ref if self.backend == "planar" \
            else K.apply_fused_gate
        v = self.target.lane_qubits

        def step(data, params):
            u_re, u_im = item.unitary_planes(params)
            return fn(data, n, v, item.qubits, u_re, u_im, item.controls)
        return step

    def _special_step(self, item: PlanItem):
        """Matmul-free lowering of a diag/perm item: one launch of the
        diagonal/permutation kernel on ``cuda`` (its plain version for a CPU
        state), the plain version itself on ``planar``.  The dense backend
        never builds special items: ``resolve_f`` pins it to f=0, keeping
        it the unspecialized naive baseline / oracle."""
        if self.backend == "dense":
            raise AssertionError(
                "dense plans are never specialized (resolve_f forces f=0 "
                "for the naive baseline)")
        fn = R.apply_phase_gate_ref if self.backend == "planar" \
            else K.apply_phase_gate
        n = self.n
        v = self.target.lane_qubits
        has_phase = bool(item.phases)

        def step(data, params):
            p_re, p_im = item.phase_planes(params) if has_phase else (None,
                                                                      None)
            perm = (item.perm_tensor(data.device) if item.perm is not None
                    else None)
            return fn(data, n, v, item.qubits, p_re, p_im, perm=perm)
        return step

    def _gate_items(self) -> list[PlanItem]:
        """The circuit part of the item list (channel/result items run only
        in the result-mode program)."""
        return [it for it in self.items if it.kind in ("dense", "diag",
                                                       "perm")]

    def _program_steps(self) -> list:
        """The ideal-circuit program: one step per gate item (for a
        result-mode plan, its gate prefix)."""
        with self._plock:
            if self._steps is None:
                if self.backend not in BACKENDS:
                    raise ValueError(f"unknown backend {self.backend!r}")
                self._steps = [self._step(item)
                               for item in self._gate_items()]
            return self._steps

    def _params_matrix(self, params, rows: int | None,
                       device: torch.device) -> torch.Tensor:
        if params is None:
            params = np.zeros((rows or 1, self.num_params), np.float32)
        pm = torch.as_tensor(params, dtype=torch.float32, device=device)
        if rows == 1:
            pm = pm.reshape(1, -1)
        if pm.dim() != 2 or pm.shape[1] != self.num_params:
            raise ValueError(f"{self.template.name}: expected "
                             f"{self.num_params} parameters per row, got "
                             f"shape {tuple(pm.shape)}")
        return pm

    def _initial_data(self, initial: SV.State | None,
                      device: torch.device) -> torch.Tensor:
        if self.backend == "dense":
            if initial is not None:
                return initial.to_dense().to(device)
            psi = torch.zeros(1 << self.n, dtype=torch.complex64,
                              device=device)
            psi[0] = 1.0
            return psi
        if initial is not None:
            # the program is lowered for this plan's lane tiling; a state laid
            # out for another target must be re-tiled by the caller first
            if initial.v != self.target.lane_qubits:
                raise ValueError(
                    f"initial state lane tiling v={initial.v} does not match "
                    f"plan target {self.target.name} "
                    f"(v={self.target.lane_qubits}); convert via "
                    f"from_dense(state.to_dense(), n, target)")
            return initial.data.to(device)
        return SV.zero_state(self.n, self.target, device=device).data

    def _wrap(self, data: torch.Tensor) -> SV.State:
        if self.backend == "dense":
            return SV.from_dense(data, self.n, self.target,
                                 device=data.device)
        return SV.State(data=data, n=self.n, v=self.target.lane_qubits)

    def _execute(self, data: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
        for step in self._program_steps():
            data = step(data, pm)
        return data

    @staticmethod
    def _device(initial: SV.State | None, device) -> torch.device:
        if device is not None:
            return SV.resolve_device(device)
        if initial is not None:
            return initial.device
        return SV.resolve_device("cuda")

    # -- execution ------------------------------------------------------------
    def run(self, params=None, initial: SV.State | None = None,
            device=None) -> SV.State:
        """Execute for one parameter vector (a batch of one).  ``device``
        defaults to the initial state's, else CUDA."""
        dev = self._device(initial, device)
        pm = self._params_matrix(params, 1, dev)
        data0 = self._initial_data(initial, dev)
        return self._wrap(self._execute(data0[None], pm)[0])

    def run_batch_raw(self, params_matrix, initial: SV.State | None = None,
                      device=None,
                      initial_batch: torch.Tensor | None = None,
                      ) -> torch.Tensor:
        """Run a ``[B, P]`` parameter matrix; returns the stacked state data
        with a leading batch axis (``[B, 2, R, V]``, or ``[B, 2**n]``
        complex on the dense backend).  ``initial_batch`` gives each row
        its own initial state data (that stacked layout)."""
        if initial_batch is not None:
            dev = initial_batch.device
            pm = self._params_matrix(params_matrix, None, dev)
            if initial_batch.shape[0] != pm.shape[0]:
                raise ValueError(f"{self.template.name}: {pm.shape[0]} "
                                 f"parameter rows for "
                                 f"{initial_batch.shape[0]} initial states")
            return self._execute(initial_batch.contiguous(), pm)
        dev = self._device(initial, device)
        pm = self._params_matrix(params_matrix, None, dev)
        return self._execute(self._batched_initial(initial, dev,
                                                   pm.shape[0]), pm)

    def _batched_initial(self, initial: SV.State | None, dev: torch.device,
                         b: int) -> torch.Tensor:
        d = self._initial_data(initial, dev)
        return d.unsqueeze(0).expand((b,) + tuple(d.shape)).contiguous()

    def run_batch(self, params_matrix, initial: SV.State | None = None,
                  device=None) -> list[SV.State]:
        return self.wrap_batch(self.run_batch_raw(params_matrix,
                                                  initial=initial,
                                                  device=device))

    def wrap_batch(self, raw: torch.Tensor,
                   count: int | None = None) -> list[SV.State]:
        """Wrap the first ``count`` rows (all, by default) of a stacked
        ``run_batch_raw`` output into per-circuit states."""
        count = raw.shape[0] if count is None else count
        return [self._wrap(raw[b]) for b in range(count)]

    # -- result-mode execution ------------------------------------------------
    def _row_probs(self, row: torch.Tensor) -> torch.Tensor:
        """|amp|^2 in dense basis order, from one row of this backend's
        layout."""
        if self.backend == "dense":
            return row.real * row.real + row.imag * row.imag
        flat = row.reshape(2, -1)
        return flat[0] * flat[0] + flat[1] * flat[1]

    def _row_inner(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """f32[B] Re <a_b|b_b>, one row at a time."""
        if self.backend == "dense":
            return torch.stack([torch.vdot(a[i], b[i]).real
                                for i in range(a.shape[0])]).float()
        return ME.inner_re(a, b)

    def _matrix_apply(self, qubits: tuple[int, ...]):
        """``(data, re, im) -> data`` applying a ``2**w x 2**w`` matrix —
        unitary or not — given as f32 planes ``[1|B, 2**w, 2**w]`` on
        ``qubits``: the fused-gate kernel on ``cuda`` (its plain version for
        a CPU state), the plain version on ``planar``."""
        n, v = self.n, self.target.lane_qubits
        if self.backend == "dense":
            return lambda psi, re, im: A.apply_gate_dense(
                psi, n, qubits, torch.complex(re, im))
        fn = R.apply_fused_gate_ref if self.backend == "planar" \
            else K.apply_fused_gate
        return lambda data, re, im: fn(data, n, v, qubits, re, im)

    def _channel_step(self, item: PlanItem):
        """Trajectory-unraveling step ``(state, generators) -> state``.

        Branch by branch, applies each Kraus operator and takes each row's
        squared norm, keeping one branch state at a time; then draws one
        branch per row with the probability of its norm (a float64 uniform
        from the row's generator against the running sum of the norms) and
        applies every row's ``K_i / sqrt(norm_i)`` in one more launch with a
        per-row matrix.  That is the JAX package's stack-all-branches
        scheme (unbiased for any observable: E[<P>] = tr(P sum_i K_i rho
        K_i^dagger)) in two states of memory instead of K + 1.
        """
        apply = self._matrix_apply(item.qubits)

        def step(data, gens):
            kr, ki = item.kraus_planes(data.device)
            norms = []
            for i in range(kr.shape[0]):
                branch = apply(data, kr[i:i + 1], ki[i:i + 1])
                norms.append(self._row_inner(branch, branch).double())
                del branch
            # running sums, one elementwise add per branch: a row's bits do
            # not depend on the batch around it
            cums = [norms[0]]
            for nm in norms[1:]:
                cums.append(cums[-1] + nm)
            u = torch.cat([torch.rand(1, dtype=torch.float64, generator=g,
                                      device=data.device) for g in gens])
            thresh = u * torch.clamp(cums[-1], min=_TINY32)
            # the first branch whose running sum exceeds the threshold: a
            # zero-norm branch is never drawn while another has mass
            idx = torch.zeros_like(u, dtype=torch.long)
            for c in cums[:-1]:
                idx += (c <= thresh).long()
            chosen = torch.stack(norms, dim=1).gather(1, idx[:, None])
            scale = torch.rsqrt(torch.clamp(chosen, min=_TINY32)).float()
            scale = scale[:, :, None]
            return apply(data, kr[idx] * scale, ki[idx] * scale)
        return step

    def _observable_step(self, obs: tuple):
        """Reduction ``(state) -> f32[B]`` for one canonical Pauli string.

        ``cuda`` routes the single-qubit-Z case through the ``<Z_q>``
        kernel (the paper's §IV reduction) and applies every other string
        factor by factor with the fused-gate kernel before the inner
        product; ``planar`` and ``dense`` keep their plain versions."""
        n, v = self.n, self.target.lane_qubits
        if self.backend == "cuda" and len(obs) == 1 and obs[0][1] == "Z":
            qubit = obs[0][0]
            return lambda data: E.expectation_z(data, n, v, qubit)
        factors = [(self._matrix_apply((q,)), p) for q, p in obs]

        def step(data):
            pd = data
            for apply, p in factors:
                ur, ui = ME.pauli_planes(p, data.device)
                pd = apply(pd, ur, ui)
            return self._row_inner(data, pd)
        return step

    def _epilogue_step(self, spec: RS.ResultSpec):
        """Result epilogue ``(state, rowkeys) -> payload [B, ...]``."""
        if spec.mode == RS.MODE_SHOTS:
            shots = spec.shots

            def epi(data, rowkeys):
                return torch.stack([
                    ME.sample_probs(self._row_probs(data[b]), shots,
                                    ME.mix64(key, traj, _SHOT_SALT))
                    for b, (key, traj) in enumerate(rowkeys)])
            return epi
        # expectation / noisy: one reduction per observable
        steps = [self._observable_step(obs) for obs in spec.observables]

        def epi(data, rowkeys):
            return torch.stack([s(data) for s in steps], dim=1).float()
        return epi

    def _result_program(self) -> tuple:
        """(channel steps, epilogue) of a result-mode plan; its gate prefix
        is :meth:`_program_steps`, the steps ``run_batch_raw`` runs."""
        with self._plock:
            if self._result_steps is None:
                if self.result is None:
                    raise ValueError(f"{self.template.name}: plan has no "
                                     f"result spec; use run/run_batch_raw")
                if self.backend not in BACKENDS:
                    raise ValueError(f"unknown backend {self.backend!r}")
                self._result_steps = (
                    [self._channel_step(it) for it in self.items
                     if it.kind == "channel"],
                    self._epilogue_step(self.result))
            return self._result_steps

    def _execute_result(self, data: torch.Tensor, pm: torch.Tensor,
                        rowkeys: list[tuple[int, int]]) -> torch.Tensor:
        """The gate prefix over the batch, exactly as ``run_batch_raw`` runs
        it (one launch per item), then each channel and the epilogue.  A
        row's randomness derives only from its ``(request key,
        trajectory)``: channel stream i and the shot stream are generators
        seeded with ``mix64(key, trajectory, salt)``."""
        chans, epi = self._result_program()
        data = self._execute(data, pm)
        for i, ch in enumerate(chans):
            data = ch(data, [ME.generator(
                ME.mix64(key, traj, _CHANNEL_SALT + i), data.device)
                for key, traj in rowkeys])
        return epi(data, rowkeys)

    @staticmethod
    def _rowkeys(rowkeys, b: int, name: str) -> list[tuple[int, int]]:
        rk = np.asarray(rowkeys, np.int64)
        if rk.shape != (b, 2):
            raise ValueError(f"{name}: rowkeys must be [{b}, 2], got "
                             f"{tuple(rk.shape)}")
        if rk.size and (rk.min() < 0 or rk.max() >= 1 << 32):
            raise ValueError(f"{name}: rowkeys must be uint32")
        return [(int(k), int(t)) for k, t in rk]

    def run_result(self, params=None, rowkey=(0, 0),
                   initial: SV.State | None = None,
                   device=None) -> torch.Tensor:
        """Execute one row of a result-mode plan (shots: int32[k];
        expectation/noisy: f32[num_observables] for one trajectory)."""
        dev = self._device(initial, device)
        pm = self._params_matrix(params, 1, dev)
        rk = self._rowkeys(np.reshape(rowkey, (1, 2)), 1, self.template.name)
        return self._execute_result(self._batched_initial(initial, dev, 1),
                                    pm, rk)[0]

    def run_batch_result_raw(self, params_matrix, rowkeys,
                             initial: SV.State | None = None,
                             device=None) -> torch.Tensor:
        """Run the result program over ``[B, P]`` params and ``[B, 2]``
        rowkeys (request key, trajectory index; uint32); returns the stacked
        payloads with a leading batch axis."""
        dev = self._device(initial, device)
        pm = self._params_matrix(params_matrix, None, dev)
        rk = self._rowkeys(rowkeys, pm.shape[0], self.template.name)
        return self._execute_result(
            self._batched_initial(initial, dev, pm.shape[0]), pm, rk)



def resolve_f(f: int | None, target: Target, n: int, fuse: bool,
              backend: str) -> int:
    """Effective fusion degree: 0 when fusion is off (dense baseline), else
    auto-chosen from the target's machine balance and capped by the state's
    row budget (:func:`repro_torch.core.target.row_budget`)."""
    if not fuse or backend == "dense":
        return 0
    f_res = f if f is not None else choose_f(target)
    return max(2, min(f_res, n, row_budget(n, target)))


def resolve_diag_f(f_eff: int, target: Target, n: int) -> int:
    """Width cap for diagonal/monomial clusters: the full row budget
    (never below the general degree ``f_eff``).  A diagonal cluster
    composes into a ``2**w`` phase *vector*, not a ``4**w`` matrix, so
    widening it costs O(2**w) memory and no extra flops per amplitude."""
    return max(f_eff, 2, row_budget(n, target))


def compile_plan(template: CircuitTemplate, *, backend: str, target: Target,
                 f: int | None = None, fuse: bool = True,
                 specialize: bool = True, result=None,
                 clock: Callable[[], float] = time.perf_counter,
                 ) -> CompiledPlan:
    """Cluster once, lower once: build the fused program for one structure.

    ``specialize`` enables gate-class-aware lowering: diagonal and
    permutation (monomial) clusters bypass the dense matvec for phase-vector
    / index-map fast paths, and diagonal runs may fuse up to
    :func:`resolve_diag_f` qubits wide.  The dense no-fusion baseline
    (``f_eff == 0``) is never specialized — it stays the naive oracle.

    ``result`` (a :class:`~repro_torch.engine.results.ResultSpec`) compiles
    a *result-mode* plan: noise channels lower to ``"channel"`` items after
    the gate items, and a terminal ``"result"`` item carries the epilogue
    (shot sampling / observable reduction), run through
    :meth:`CompiledPlan.run_result` / ``run_batch_result_raw``.  The
    statevector spec is normalized away here, so a default-mode request
    compiles the same plan as a spec-less one.
    ``clock`` injects the timebase for ``compile_seconds``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    t0 = clock()
    dummy = template.bind(np.zeros(template.num_params))
    ops = template.ops
    f_eff = resolve_f(f, target, template.n, fuse, backend)
    specialize = bool(specialize and f_eff)
    if f_eff:
        diag_f = resolve_diag_f(f_eff, target, template.n) \
            if specialize else None
        classes = ([PARAM_OP_CLASS.get(op.kind) for op in ops]
                   if specialize else None)
        prep, specs = cluster_gates(dummy.gates, f_eff, diag_f=diag_f,
                                    classes=classes)
        items = [it for s in specs
                 if (it := _lower_cluster(s, prep, ops,
                                          diag_cap=diag_f)) is not None]
        if specialize and backend == "planar":
            items = _coalesce_diag_runs(items)
    else:
        items = [_lower_single(op, g) for op, g in zip(ops, dummy.gates)]
    if result is not None and result.mode == RS.MODE_STATEVECTOR:
        result = None
    if result is not None:
        result.validate_for(template)
        # channels apply after the ideal circuit (post-circuit noise); the
        # epilogue item is terminal
        for ch in result.channels:
            items.append(PlanItem(
                qubits=ch.qubits, controls=(), kind="channel", kraus=ch.kraus,
                generic_flops=8.0 * (1 << len(ch.qubits)) * len(ch.kraus)))
        items.append(PlanItem(qubits=(), controls=(), kind="result",
                              result=result))
    plan = CompiledPlan(template=template, backend=backend, target=target,
                        f=f_eff, items=items, specialize=specialize,
                        result=result)
    plan.profile = vectorization_profile(plan, dummy.gates, target)
    plan.compile_seconds = clock() - t0
    return plan


@dataclasses.dataclass
class CacheStats:
    """Plan-cache counters, safe under concurrent callers (mutations go
    through :meth:`bump` under an internal lock)."""

    hits: int = 0                #: guarded-by: _lock
    misses: int = 0              #: guarded-by: _lock
    compiles: int = 0            #: guarded-by: _lock
    evictions: int = 0           #: guarded-by: _lock
    #: guarded-by: _lock
    compile_seconds: float = 0.0  # total wall time spent in compile_plan

    def __post_init__(self):
        self._lock = threading.Lock()
        # bounded per-compile sample window for the percentile attribution;
        # the compile_seconds total above stays exact over every compile
        self._compile_hist = Histogram(1024, name="compile_seconds")

    def bump(self, name: str, k: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + k)

    def record_compile(self, seconds: float) -> None:
        """Attribute one compile_plan invocation's wall time."""
        with self._lock:
            self.compile_seconds += seconds
        self._compile_hist.record(seconds)

    def compile_summary(self) -> dict:
        """Total + percentile compile-time attribution; empty before the
        first compile."""
        s = self._compile_hist.summary()
        if not s:
            return {}
        with self._lock:
            total = self.compile_seconds
        return {"seconds_total": total, "count": s["count"],
                "seconds_mean": s["mean"], "seconds_p50": s["p50"],
                "seconds_p95": s["p95"], "seconds_max": s["max"]}

    def as_dict(self) -> dict:
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)}


class PlanCache:
    """LRU cache of compiled plans keyed by structure hash + exec config.

    Thread-safe: lookups, inserts, and evictions hold one reentrant lock,
    so concurrent callers resolving the same structure get exactly one
    compile.  Compiles run inside the lock deliberately.

    A cached plan keeps its items' device copies of their constants (a
    wide diagonal item holds ``8 * 2**w`` bytes of phase planes) until it
    is evicted or the cache cleared; :meth:`held_bytes` reports them.  The
    cache is bounded by plan count only.
    """

    def __init__(self, max_plans: int = 256):
        self.max_plans = max_plans
        self._plans: collections.OrderedDict = collections.OrderedDict()  #: guarded-by: _lock
        self._lock = threading.RLock()
        self.stats = CacheStats()

    @staticmethod
    def plan_key(template: CircuitTemplate, *, backend: str, target: Target,
                 f: int | None, fuse: bool,
                 specialize: bool = True, result=None) -> tuple:
        """Cache key: structure hash + everything that changes the
        lowering.  A result spec adds its structural component only
        (mode, shots, observables, channel constants): the per-request key
        and the unraveling row count never fragment the cache."""
        f_eff = resolve_f(f, target, template.n, fuse, backend)
        return (template.structure_key(), backend, target.name, f_eff,
                bool(specialize and f_eff),
                result.plan_key() if result is not None else None)

    def get_or_compile(self, template: CircuitTemplate | Circuit, *,
                       backend: str, target: Target, f: int | None = None,
                       fuse: bool = True, specialize: bool = True,
                       result=None) -> CompiledPlan:
        if isinstance(template, Circuit):
            template = template_of(template)
        key = self.plan_key(template, backend=backend, target=target, f=f,
                            fuse=fuse, specialize=specialize, result=result)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.stats.bump("hits")
                self._plans.move_to_end(key)
                return plan
            self.stats.bump("misses")
            plan = compile_plan(template, backend=backend, target=target,
                                f=f, fuse=fuse, specialize=specialize,
                                result=result)
            plan.cache_stats = self.stats
            self.stats.bump("compiles")
            self.stats.record_compile(plan.compile_seconds)
            self._plans[key] = plan
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
                self.stats.bump("evictions")
        return plan

    def class_counts(self) -> dict:
        """Aggregate fused-gate counts by lowering class over cached plans."""
        counts = {"diagonal": 0, "permutation": 0, "general": 0,
                  "channel": 0, "result": 0}
        with self._lock:
            plans = list(self._plans.values())
        for plan in plans:
            for cls, c in plan.class_counts().items():
                counts[cls] += c
        return counts

    def held_bytes(self) -> dict[str, int]:
        """Bytes of device copies held by the cached plans, per device."""
        out: dict[str, int] = {}
        with self._lock:
            plans = list(self._plans.values())
        for plan in plans:
            for dev, nb in plan.held_bytes().items():
                out[dev] = out.get(dev, 0) + nb
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.stats = CacheStats()


# module-level default, shared across Simulator instances
GLOBAL_PLAN_CACHE = PlanCache()
