"""The paper's five benchmark circuits + the synthetic fusion-tuning circuit.

QFT, Grover, GHZ, QRC (Google random-circuit sampling) and QV (IBM quantum
volume), built exactly as described in §VI, plus the synthetic benchmark of
§VII-B (1-qubit gates on high qubits only, no controlled gates) used to find
the machine-balance-optimal fusion degree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import gates as G


@dataclasses.dataclass
class Circuit:
    n: int
    gates: list[G.Gate]
    name: str = "circuit"

    @property
    def num_gates(self) -> int:
        return len(self.gates)

    def gate_ops_on_qubit(self, q: int) -> int:
        """Number of gate operations touching qubit q (Table III metric)."""
        return sum(1 for g in self.gates if q in g.qubits or q in g.controls)


def qft(n: int) -> Circuit:
    """Quantum Fourier Transform: H + controlled phase rotations + swaps."""
    gs: list[G.Gate] = []
    for i in reversed(range(n)):
        gs.append(G.h(i))
        for j in range(i):
            # controlled rotation by pi / 2^(i-j)
            gs.append(G.cphase(j, i, math.pi / (1 << (i - j))))
    for i in range(n // 2):
        gs.append(G.swap(i, n - 1 - i))
    return Circuit(n, gs, name=f"qft{n}")


def ghz(n: int) -> Circuit:
    """H on qubit 0 followed by a CNOT chain."""
    gs = [G.h(0)]
    for i in range(1, n):
        gs.append(G.cnot(i - 1, i))
    return Circuit(n, gs, name=f"ghz{n}")


def grover(n: int, marked: int | None = None, iterations: int = 1) -> Circuit:
    """Grover search: oracle (phase flip on |marked>) + diffusion operator."""
    if marked is None:
        marked = (1 << n) - 1
    gs: list[G.Gate] = [G.h(q) for q in range(n)]
    for _ in range(iterations):
        # oracle: flip phase of |marked> via X-conjugated multi-controlled Z
        zeros = [q for q in range(n) if not (marked >> q) & 1]
        gs += [G.x(q) for q in zeros]
        gs.append(G.mcz(tuple(range(n - 1)), n - 1))
        gs += [G.x(q) for q in zeros]
        # diffusion: H^n X^n MCZ X^n H^n
        gs += [G.h(q) for q in range(n)]
        gs += [G.x(q) for q in range(n)]
        gs.append(G.mcz(tuple(range(n - 1)), n - 1))
        gs += [G.x(q) for q in range(n)]
        gs += [G.h(q) for q in range(n)]
    return Circuit(n, gs, name=f"grover{n}")


def qrc(n: int, depth: int = 64, seed: int = 7) -> Circuit:
    """Random-circuit sampling: random sqrt-rotations + staggered CZ layers."""
    rng = np.random.default_rng(seed)
    gs: list[G.Gate] = [G.h(q) for q in range(n)]
    rots = (G.rx, G.ry, G.rz)
    for d in range(depth):
        for q in range(n):
            rot = rots[rng.integers(0, 3)]
            gs.append(rot(q, float(rng.uniform(0, 2 * math.pi))))
        start = d % 2
        for q in range(start, n - 1, 2):
            gs.append(G.cz(q, q + 1))
    return Circuit(n, gs, name=f"qrc{n}d{depth}")


def qv(n: int, depth: int | None = None, seed: int = 11) -> Circuit:
    """Quantum volume: per layer, random qubit pairing + random SU(4)s."""
    depth = depth if depth is not None else n
    rng = np.random.default_rng(seed)
    gs: list[G.Gate] = []
    for _ in range(depth):
        perm = rng.permutation(n)
        for i in range(0, n - 1, 2):
            gs.append(G.su4(int(perm[i]), int(perm[i + 1]), rng))
    return Circuit(n, gs, name=f"qv{n}")


def qaoa(n: int, gammas: Sequence[float], betas: Sequence[float],
         edges: Sequence[tuple[int, int]] | None = None) -> Circuit:
    """MaxCut QAOA ansatz (default: ring graph), one (gamma, beta) per layer.

    ZZ interactions compile to CNOT · RZ(2*gamma) · CNOT, so every
    parameter enters through a single-qubit rotation — the form
    ``repro_torch.engine.template.qaoa_template`` reproduces structurally.
    """
    if len(gammas) != len(betas):
        raise ValueError("need one gamma and one beta per layer")
    if n < 2:
        raise ValueError(f"qaoa needs at least 2 qubits, got n={n}")
    if edges is None:
        edges = [(i, (i + 1) % n) for i in range(n)] if n > 2 else [(0, 1)]
    gs: list[G.Gate] = [G.h(q) for q in range(n)]
    for gamma, beta in zip(gammas, betas):
        for a, b in edges:
            gs.append(G.cnot(a, b))
            gs.append(G.rz(b, 2.0 * float(gamma)))
            gs.append(G.cnot(a, b))
        for q in range(n):
            gs.append(G.rx(q, 2.0 * float(beta)))
    return Circuit(n, gs, name=f"qaoa{n}p{len(gammas)}")


def hardware_efficient(n: int, thetas: Sequence[float]) -> Circuit:
    """Hardware-efficient ansatz: per layer RY+RZ on every qubit (qubit-major
    angle order) followed by a linear CNOT entangler.  ``len(thetas)`` must be
    a multiple of ``2 * n``; the layer count is inferred."""
    if n > 1 and (len(thetas) == 0 or len(thetas) % (2 * n) != 0):
        raise ValueError(f"need a multiple of {2 * n} angles, got {len(thetas)}")
    layers = len(thetas) // (2 * n)
    gs: list[G.Gate] = []
    idx = 0
    for _ in range(layers):
        for q in range(n):
            gs.append(G.ry(q, float(thetas[idx])))
            gs.append(G.rz(q, float(thetas[idx + 1])))
            idx += 2
        for q in range(n - 1):
            gs.append(G.cnot(q, q + 1))
    return Circuit(n, gs, name=f"hea{n}x{layers}")


def synthetic(n: int, layers: int, num_vals: int, seed: int = 3) -> Circuit:
    """Paper §VII-B synthetic tuner: 1-qubit gates on *high* qubits only
    (indices >= log2(numVals)), no controlled gates, so fused-gate count
    shrinks linearly with f and circuit structure cannot interfere."""
    v = num_vals.bit_length() - 1
    rng = np.random.default_rng(seed)
    gs: list[G.Gate] = []
    rots = (G.rx, G.ry, G.rz)
    for _ in range(layers):
        for q in range(v, n):
            rot = rots[rng.integers(0, 3)]
            gs.append(rot(q, float(rng.uniform(0, 2 * math.pi))))
    return Circuit(n, gs, name=f"synth{n}x{layers}")


BUILDERS = {
    "qft": qft,
    "ghz": ghz,
    "grover": grover,
    "qrc": qrc,
    "qv": qv,
    "qaoa": qaoa,
    "hea": hardware_efficient,
}


def build(name: str, n: int, **kw) -> Circuit:
    return BUILDERS[name](n, **kw)


build_circuit = build  # legacy alias


def expected_ghz_dense(n: int) -> np.ndarray:
    psi = np.zeros(1 << n, np.complex64)
    psi[0] = psi[-1] = 1 / math.sqrt(2)
    return psi


def expected_qft_dense(n: int, basis_in: int = 0) -> np.ndarray:
    """QFT of a computational-basis state |x>: (1/sqrt(N)) sum_k w^{xk} |k>
    — with the standard bit-reversal-free definition matching our circuit
    (which ends with swaps)."""
    dim = 1 << n
    k = np.arange(dim)
    return (np.exp(2j * np.pi * basis_in * k / dim) / math.sqrt(dim)).astype(
        np.complex64)
