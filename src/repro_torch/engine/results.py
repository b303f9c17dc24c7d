"""Result modes: what the engine hands back for one served request.

The serving engine historically had exactly one workload — full state
vectors.  Production simulators expose more (Qsim's ``sample`` and
``ExpectationValue``), and the paper's §IV streams the expectation
reduction instead of storing final states back to memory.  A
:class:`ResultSpec` captures the request-side choice:

* ``statevector`` — the default; the request resolves to a
  :class:`~repro_torch.core.statevec.State` (unchanged behavior).
* ``shots`` — ``k`` basis-state samples drawn by inverse-CDF sampling
  after the last plan item.  The per-request ``key`` seeds each row's own
  random stream, so shot results are bitwise reproducible regardless of
  which other requests co-batch.
* ``expectation`` — one real number per Pauli-string observable,
  reduced on-device; the full state is never materialized in the
  returned payload.
* ``noisy`` — Kraus channels applied after the circuit via stochastic
  trajectory unraveling.  Each request expands into ``unravelings``
  rows of the batch axis; the caller averages the per-trajectory
  expectation values back into one payload.

The spec is *per-request* and deliberately not part of the circuit
template: ``plan_key()`` exposes the structural component that changes
the compiled program (mode, shot count, observables, channel
constants), while the per-request PRNG ``key`` and the ``unravelings``
row count ride on the request and never fragment the plan cache.

This module is numpy-only and mirrors the JAX package's
``engine/results.py`` definition for definition: ``plan_key`` and
``NoiseChannel.structure_key`` give the same values in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Sequence

import numpy as np

MODE_STATEVECTOR = "statevector"
MODE_SHOTS = "shots"
MODE_EXPECTATION = "expectation"
MODE_NOISY = "noisy"
MODES = (MODE_STATEVECTOR, MODE_SHOTS, MODE_EXPECTATION, MODE_NOISY)

_PAULIS = ("X", "Y", "Z")


def _normalize_observable(obs) -> tuple[tuple[int, str], ...]:
    """Canonical Pauli string: sorted ``((qubit, 'X'|'Y'|'Z'), ...)``.

    Accepts a mapping ``{qubit: pauli}`` or a sequence of pairs; qubit
    order and pauli case never change the canonical form, so two
    spellings of one observable share a plan key.
    """
    pairs = obs.items() if isinstance(obs, Mapping) else obs
    out = []
    seen = set()
    for q, p in pairs:
        q = int(q)
        p = str(p).upper()
        if p not in _PAULIS:
            raise ValueError(f"observable pauli must be X/Y/Z, got {p!r}")
        if q < 0:
            raise ValueError(f"observable qubit must be >= 0, got {q}")
        if q in seen:
            raise ValueError(f"observable repeats qubit {q}")
        seen.add(q)
        out.append((q, p))
    if not out:
        raise ValueError("an observable needs at least one (qubit, pauli)")
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class NoiseChannel:
    """One Kraus channel ``rho -> sum_i K_i rho K_i^dagger``.

    ``kraus`` holds the operators as complex64 arrays over the channel's
    ``qubits`` span.  Construction normalizes shapes/dtypes only; the
    completeness condition ``sum_i K_i^dagger K_i = I`` is not checked
    (the plan-IR verifier that checks it is not ported yet).
    """

    qubits: tuple[int, ...]
    kraus: tuple[np.ndarray, ...]
    name: str = "kraus"

    def __post_init__(self):
        qubits = tuple(int(q) for q in self.qubits)
        if not qubits or any(q < 0 for q in qubits):
            raise ValueError(f"channel qubits must be non-empty and >= 0, "
                             f"got {qubits}")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"channel repeats a qubit: {qubits}")
        dim = 1 << len(qubits)
        ks = []
        for k in self.kraus:
            arr = np.asarray(k, np.complex64)
            if arr.shape != (dim, dim):
                raise ValueError(
                    f"channel {self.name!r}: Kraus operator shape "
                    f"{arr.shape} != ({dim}, {dim}) for {len(qubits)} qubits")
            arr.setflags(write=False)
            ks.append(arr)
        if not ks:
            raise ValueError(f"channel {self.name!r} needs >= 1 Kraus "
                             f"operator")
        object.__setattr__(self, "qubits", qubits)
        object.__setattr__(self, "kraus", tuple(ks))

    def structure_key(self) -> str:
        """Content hash over the qubit span and the operator constants —
        two channels with equal Kraus data share compiled plans."""
        h = hashlib.sha1()
        h.update(repr((self.name, self.qubits)).encode())
        for k in self.kraus:
            h.update(np.ascontiguousarray(k).tobytes())
        return h.hexdigest()


def depolarizing(qubit: int, p: float) -> NoiseChannel:
    """Single-qubit depolarizing channel with error probability ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"depolarizing probability must be in [0, 1], "
                         f"got {p}")
    i = np.eye(2, dtype=np.complex64)
    x = np.array([[0, 1], [1, 0]], np.complex64)
    y = np.array([[0, -1j], [1j, 0]], np.complex64)
    z = np.array([[1, 0], [0, -1]], np.complex64)
    s = np.sqrt(p / 3.0).astype(np.float64)
    return NoiseChannel(qubits=(qubit,),
                        kraus=(np.sqrt(1.0 - p) * i, s * x, s * y, s * z),
                        name="depolarizing")


def bit_flip(qubit: int, p: float) -> NoiseChannel:
    """Single-qubit bit-flip (Pauli-X) channel with flip probability ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"bit-flip probability must be in [0, 1], got {p}")
    i = np.eye(2, dtype=np.complex64)
    x = np.array([[0, 1], [1, 0]], np.complex64)
    return NoiseChannel(qubits=(qubit,),
                        kraus=(np.sqrt(1.0 - p) * i, np.sqrt(p) * x),
                        name="bit_flip")


def phase_flip(qubit: int, p: float) -> NoiseChannel:
    """Single-qubit phase-flip (Pauli-Z) channel with flip probability ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"phase-flip probability must be in [0, 1], got {p}")
    i = np.eye(2, dtype=np.complex64)
    z = np.array([[1, 0], [0, -1]], np.complex64)
    return NoiseChannel(qubits=(qubit,),
                        kraus=(np.sqrt(1.0 - p) * i, np.sqrt(p) * z),
                        name="phase_flip")


def amplitude_damping(qubit: int, gamma: float) -> NoiseChannel:
    """Single-qubit amplitude damping with decay probability ``gamma`` —
    a genuinely non-Pauli channel, exercising the general-Kraus path."""
    if not 0.0 <= gamma <= 1.0:
        raise ValueError(f"damping gamma must be in [0, 1], got {gamma}")
    k0 = np.array([[1, 0], [0, np.sqrt(1.0 - gamma)]], np.complex64)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], np.complex64)
    return NoiseChannel(qubits=(qubit,), kraus=(k0, k1),
                        name="amplitude_damping")


@dataclasses.dataclass(frozen=True)
class ResultSpec:
    """Per-request result mode, threaded executor -> plan.

    Build one with the classmethod constructors (:meth:`sample`,
    :meth:`expectation`, :meth:`noisy`); the zero-argument default is the
    statevector mode the engine always served.
    """

    mode: str = MODE_STATEVECTOR
    shots: int = 0                   # basis-state samples (shots mode)
    key: int = 0                     # per-request PRNG seed (shots/noisy)
    observables: tuple = ()          # tuple of canonical Pauli strings
    channels: tuple = ()             # NoiseChannel tuple (noisy mode)
    unravelings: int = 1             # trajectory rows per request (noisy)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown result mode {self.mode!r}; "
                             f"expected one of {MODES}")
        object.__setattr__(self, "observables",
                           tuple(_normalize_observable(o)
                                 for o in self.observables))
        object.__setattr__(self, "channels", tuple(self.channels))
        object.__setattr__(self, "key", int(self.key))
        if self.key < 0 or self.key >= (1 << 32):
            raise ValueError(f"result key must be a uint32, got {self.key}")
        for ch in self.channels:
            if not isinstance(ch, NoiseChannel):
                raise TypeError(f"channels must be NoiseChannel, "
                                f"got {type(ch).__name__}")
        if self.mode == MODE_SHOTS and self.shots <= 0:
            raise ValueError(f"shots mode needs shots > 0, got {self.shots}")
        if self.mode in (MODE_EXPECTATION, MODE_NOISY) and not self.observables:
            raise ValueError(f"{self.mode} mode needs >= 1 observable")
        if self.mode == MODE_NOISY:
            if not self.channels:
                raise ValueError("noisy mode needs >= 1 noise channel")
            if self.unravelings <= 0:
                raise ValueError(f"noisy mode needs unravelings > 0, "
                                 f"got {self.unravelings}")
        if self.mode != MODE_NOISY and self.channels:
            raise ValueError(f"channels are only valid in noisy mode, "
                             f"got mode={self.mode!r}")
        if self.mode != MODE_SHOTS and self.shots:
            raise ValueError(f"shots are only valid in shots mode, "
                             f"got mode={self.mode!r}")

    # -- constructors ---------------------------------------------------------
    @classmethod
    def statevector(cls) -> "ResultSpec":
        return cls()

    @classmethod
    def sample(cls, shots: int, key: int = 0) -> "ResultSpec":
        return cls(mode=MODE_SHOTS, shots=shots, key=key)

    @classmethod
    def expectation(cls, observables: Sequence) -> "ResultSpec":
        return cls(mode=MODE_EXPECTATION, observables=tuple(observables))

    @classmethod
    def noisy(cls, channels: Sequence[NoiseChannel], observables: Sequence,
              unravelings: int = 8, key: int = 0) -> "ResultSpec":
        return cls(mode=MODE_NOISY, channels=tuple(channels),
                   observables=tuple(observables), unravelings=unravelings,
                   key=key)

    # -- engine-facing structure ---------------------------------------------
    @property
    def rows(self) -> int:
        """Batch rows one request occupies (trajectory expansion)."""
        return self.unravelings if self.mode == MODE_NOISY else 1

    @property
    def needs_key(self) -> bool:
        """True when the result program consumes per-row random streams."""
        return self.mode in (MODE_SHOTS, MODE_NOISY)

    def plan_key(self) -> tuple | None:
        """Structural cache-key component: everything that changes the
        *compiled program* — and nothing that doesn't.  The per-request
        PRNG ``key`` enters the program as a per-row input and the
        ``unravelings`` count only scales the row expansion, so neither
        fragments the plan cache (requests differing only in those
        co-batch)."""
        if self.mode == MODE_STATEVECTOR:
            return None
        return (self.mode, self.shots, self.observables,
                tuple(ch.structure_key() for ch in self.channels))

    def class_key_component(self) -> tuple | None:
        """Result component of a *shape-class* key (shape-class routing
        is not ported yet; kept so the key matches the JAX package's).

        Deliberately identical to :meth:`plan_key`: channel Kraus values and
        observable coefficients enter the epilogue as baked constants shared
        by every class member, so the class key must pin them exactly as the
        plan key does — only gate-item constants are erased by
        canonicalization.  Kept as a separate method so the two keys can
        diverge (e.g. erasing observable coefficients into row inputs)
        without overloading the plan-cache key.
        """
        return self.plan_key()

    def validate_for(self, template) -> None:
        """Bounds-check observable/channel qubits against the template
        (the JAX package's ``CircuitTemplate.validate_qubits``, with its
        messages)."""
        for obs in self.observables:
            _validate_qubits(template, (q for q, _ in obs),
                             "observable qubit")
        for ch in self.channels:
            _validate_qubits(template, ch.qubits, "channel qubit")


def _validate_qubits(template, qubits, what: str) -> None:
    for q in qubits:
        if not 0 <= int(q) < template.n:
            raise ValueError(f"{template.name}: {what} {q} out of range "
                             f"for n={template.n}")
