"""Parameterized circuit template IR.

A :class:`CircuitTemplate` splits a circuit into its *static structure*
(gate kinds, target/control wiring, fixed unitaries) and a flat parameter
vector.  Everything that depends only on structure — fusion clustering,
lowering, constant upload — is paid once per template and reused across
every parameter binding (a QAOA/VQE sweep, repeated serving traffic).

Two op kinds exist:

* ``fixed``     — a concrete unitary, identical across bindings.
* rotation kinds (``rx`` ``ry`` ``rz`` ``phase``) — single-qubit,
  control-free gates whose matrix is an analytic function of one entry of the
  parameter vector (``angle = scale * params[param]``).

``bind(params)`` materializes a concrete :class:`~repro_torch.core.circuits.Circuit`
(the sequential-execution reference); ``structure_key()`` is the plan-cache
key, byte-identical to the JAX package's for the same template.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import gates as G
from repro_torch.core.circuits import Circuit

# angle -> 2x2 unitary, numpy (for bind) and batched torch (for plan
# programs).  The torch forms take f32[B] angles and return c64[B, 2, 2],
# written as combinations of constant Paulis/projectors.
_P0 = np.diag([1, 0]).astype(np.complex64)
_P1 = np.diag([0, 1]).astype(np.complex64)


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, device=like.device)


def _cos_sin_combo(t: torch.Tensor, pauli: np.ndarray) -> torch.Tensor:
    """cos(t/2) I - i sin(t/2) P, batched over ``t``."""
    c = torch.cos(t / 2).to(torch.complex64)[:, None, None]
    s = torch.sin(t / 2).to(torch.complex64)[:, None, None]
    return c * _const(G.I2, t) - 1j * s * _const(pauli, t)


def _rx_t(t: torch.Tensor) -> torch.Tensor:
    return _cos_sin_combo(t, G.X_M)


def _ry_t(t: torch.Tensor) -> torch.Tensor:
    return _cos_sin_combo(t, G.Y_M)


def _rz_t(t: torch.Tensor) -> torch.Tensor:
    return _cos_sin_combo(t, G.Z_M)


def _phase_t(t: torch.Tensor) -> torch.Tensor:
    e = torch.exp(1j * t.to(torch.complex64))[:, None, None]
    return _const(_P0, t) + e * _const(_P1, t)


@dataclasses.dataclass(frozen=True)
class ParamKind:
    np_fn: Callable[[float], np.ndarray]
    torch_fn: Callable[[torch.Tensor], torch.Tensor]


PARAM_KINDS: dict[str, ParamKind] = {
    "rx": ParamKind(G.rx_m, _rx_t),
    "ry": ParamKind(G.ry_m, _ry_t),
    "rz": ParamKind(G.rz_m, _rz_t),
    "phase": ParamKind(G.phase_m, _phase_t),
}


@dataclasses.dataclass(frozen=True)
class TemplateOp:
    kind: str                              # "fixed" | PARAM_KINDS key
    qubits: tuple[int, ...]
    controls: tuple[int, ...] = ()
    param: int | None = None               # parameter-vector index
    scale: float = 1.0                     # angle = scale * params[param]
    matrix: np.ndarray | None = None       # fixed ops only
    name: str = "g"

    def __post_init__(self):
        if self.kind == "fixed":
            if self.matrix is None or self.param is not None:
                raise ValueError("fixed op needs a matrix and no param")
        else:
            if self.kind not in PARAM_KINDS:
                raise ValueError(f"unknown parameterized kind {self.kind!r}")
            if self.param is None or self.matrix is not None:
                raise ValueError(f"{self.kind} op needs a param index only")
            if len(self.qubits) != 1 or self.controls:
                raise ValueError(
                    "parameterized ops must be single-qubit and control-free")

    def gate(self, params: np.ndarray) -> G.Gate:
        if self.kind == "fixed":
            return G.Gate(self.qubits, self.matrix, controls=self.controls,
                          name=self.name)
        m = PARAM_KINDS[self.kind].np_fn(self.scale * float(params[self.param]))
        return G.Gate(self.qubits, m, name=self.name)


def fixed_op(g: G.Gate) -> TemplateOp:
    return TemplateOp("fixed", g.qubits, controls=g.controls, matrix=g.matrix,
                      name=g.name)


@dataclasses.dataclass(frozen=True)
class CircuitTemplate:
    n: int
    ops: tuple[TemplateOp, ...]
    num_params: int
    name: str = "template"

    def __post_init__(self):
        for op in self.ops:
            if op.param is not None and not 0 <= op.param < self.num_params:
                raise ValueError(
                    f"op {op.name}: param index {op.param} out of range "
                    f"for {self.num_params} parameters")

    @property
    def num_ops(self) -> int:
        return len(self.ops)

    def bind(self, params: Sequence[float] | np.ndarray) -> Circuit:
        """Materialize a concrete circuit for one parameter vector."""
        params = np.asarray(params, np.float64).reshape(-1)
        if params.shape[0] != self.num_params:
            raise ValueError(
                f"{self.name}: expected {self.num_params} parameters, "
                f"got {params.shape[0]}")
        return Circuit(self.n, [op.gate(params) for op in self.ops],
                       name=self.name)

    def structure_key(self) -> str:
        """Hash of everything except the parameter values."""
        cached = self.__dict__.get("_structure_key")
        if cached is not None:
            return cached
        h = hashlib.sha1()
        h.update(f"n={self.n};p={self.num_params};".encode())
        for op in self.ops:
            h.update(
                f"{op.kind}|{op.qubits}|{op.controls}|{op.param}|{op.scale};"
                .encode())
            if op.matrix is not None:
                h.update(np.ascontiguousarray(op.matrix, np.complex64)
                         .tobytes())
        key = h.hexdigest()
        object.__setattr__(self, "_structure_key", key)
        return key


def template_of(circuit: Circuit) -> CircuitTemplate:
    """Wrap a concrete circuit as an all-fixed, zero-parameter template."""
    return CircuitTemplate(circuit.n, tuple(fixed_op(g) for g in circuit.gates),
                           num_params=0, name=circuit.name)


# -- parameterized workload builders ------------------------------------------
#
# These mirror the concrete builders in ``repro_torch.core.circuits`` (qaoa /
# hardware_efficient): ``template.bind(params)`` produces gate-for-gate the
# same circuit the concrete builder would.

def _ring_edges(n: int) -> tuple[tuple[int, int], ...]:
    if n < 2:
        raise ValueError(f"qaoa needs at least 2 qubits, got n={n}")
    return tuple((i, (i + 1) % n) for i in range(n)) if n > 2 else ((0, 1),)


def qaoa_template(n: int, p: int,
                  edges: Sequence[tuple[int, int]] | None = None,
                  ) -> CircuitTemplate:
    """Depth-``p`` MaxCut QAOA ansatz on ``edges`` (default: ring graph).

    Parameter layout: ``[gamma_0..gamma_{p-1}, beta_0..beta_{p-1}]``.  Each
    ZZ interaction is compiled as CNOT · RZ(2*gamma) · CNOT so the only
    parameterized ops are single-qubit rotations.
    """
    edges = tuple(edges) if edges is not None else _ring_edges(n)
    ops: list[TemplateOp] = [fixed_op(G.h(q)) for q in range(n)]
    for layer in range(p):
        for a, b in edges:
            ops.append(fixed_op(G.cnot(a, b)))
            ops.append(TemplateOp("rz", (b,), param=layer, scale=2.0,
                                  name="rz"))
            ops.append(fixed_op(G.cnot(a, b)))
        for q in range(n):
            ops.append(TemplateOp("rx", (q,), param=p + layer, scale=2.0,
                                  name="rx"))
    return CircuitTemplate(n, tuple(ops), num_params=2 * p,
                           name=f"qaoa{n}p{p}")


def hea_template(n: int, layers: int) -> CircuitTemplate:
    """Hardware-efficient ansatz: per layer RY+RZ on every qubit, then a
    linear CNOT entangler.  Parameter layout: ``2 * n`` angles per layer,
    qubit-major (``ry`` then ``rz``)."""
    ops: list[TemplateOp] = []
    idx = 0
    for _ in range(layers):
        for q in range(n):
            ops.append(TemplateOp("ry", (q,), param=idx, name="ry"))
            ops.append(TemplateOp("rz", (q,), param=idx + 1, name="rz"))
            idx += 2
        for q in range(n - 1):
            ops.append(fixed_op(G.cnot(q, q + 1)))
    return CircuitTemplate(n, tuple(ops), num_params=idx,
                           name=f"hea{n}x{layers}")
