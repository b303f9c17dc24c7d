"""Quantum gate library.

Conventions (used consistently across core/, kernels/ and tests):

* ``Gate.qubits`` is a tuple of *target* qubit ids; bit ``m`` of the gate's
  2**k-dimensional index corresponds to ``qubits[m]`` (qubits[0] = LSB).
* ``Gate.controls`` is a tuple of control qubit ids; the unitary acts on the
  subspace where every control qubit is |1>.
* Matrices are ``complex64`` ndarrays of shape (2**k, 2**k) with the column
  index the *input* basis state.
* Qubit 0 is the least-significant bit of the computational-basis index.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

_SQRT2_INV = 1.0 / np.sqrt(2.0)


# Structural gate classes (paper §IV-D adaptation; see core.fusion /
# engine.plan).  "diagonal" and "permutation" gates admit matmul-free
# application: a diagonal is an elementwise phase rotation, a permutation
# (monomial: one nonzero per row/column, arbitrary phases — X, Y, CX, SWAP)
# is a static gather plus an optional phase rotation.
GATE_CLASSES = ("diagonal", "permutation", "general")
_CLASS_ATOL = 1e-6


def gate_class(matrix: np.ndarray, atol: float = _CLASS_ATOL) -> str:
    """Classify a unitary as ``diagonal | permutation | general``.

    ``permutation`` means *monomial*: exactly one nonzero entry per row and
    per column (phases allowed), excluding the diagonal case.  The check is
    structural (numpy, compile time) and conservative: anything else is
    ``general``.
    """
    m = np.asarray(matrix)
    nz = np.abs(m) > atol
    if not np.any(nz & ~np.eye(m.shape[0], dtype=bool)):
        return "diagonal"
    if np.all(nz.sum(axis=0) == 1) and np.all(nz.sum(axis=1) == 1):
        return "permutation"
    return "general"


def monomial_decompose(matrix: np.ndarray,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Split a diagonal/permutation matrix into ``(perm, phase)`` with
    ``out[r] = phase[r] * in[perm[r]]`` (i.e. ``matrix[r, perm[r]] =
    phase[r]``, all other entries zero).  Raises for general matrices."""
    m = np.asarray(matrix, np.complex64)
    nz = np.abs(m) > _CLASS_ATOL
    if not (np.all(nz.sum(axis=0) == 1) and np.all(nz.sum(axis=1) == 1)):
        raise ValueError("matrix is not diagonal or monomial")
    perm = nz.argmax(axis=1)
    phase = m[np.arange(m.shape[0]), perm]
    return perm.astype(np.int64), phase.astype(np.complex64)


@dataclasses.dataclass(frozen=True)
class Gate:
    qubits: tuple[int, ...]
    matrix: np.ndarray                     # complex64 [2**k, 2**k]
    controls: tuple[int, ...] = ()
    name: str = "g"

    def __post_init__(self):
        k = len(self.qubits)
        m = np.asarray(self.matrix, np.complex64)
        if m.shape != (1 << k, 1 << k):
            raise ValueError(
                f"gate {self.name}: matrix {m.shape} does not match {k} qubits")
        if set(self.qubits) & set(self.controls):
            raise ValueError(f"gate {self.name}: overlapping targets/controls")
        if len(set(self.qubits)) != k or len(set(self.controls)) != len(self.controls):
            raise ValueError(f"gate {self.name}: duplicate qubits")
        object.__setattr__(self, "matrix", m)

    @property
    def k(self) -> int:
        return len(self.qubits)

    @property
    def all_qubits(self) -> tuple[int, ...]:
        return tuple(sorted(self.qubits + self.controls))

    @property
    def gate_class(self) -> str:
        """Structural class of the full operator (controls included): a
        controlled gate whose target matrix is diagonal is itself diagonal;
        a controlled permutation (CX, CCX) is a permutation."""
        return gate_class(self.matrix)

    def flops(self) -> int:
        """Real FLOPs of one group matvec: per row, d complex mults (6 real
        flops each) + d-1 complex adds (2 each) = 8d - 2; matches the
        paper's 28 FLOPs for the 1-qubit kernel (d = 2)."""
        d = 1 << self.k
        return d * (8 * d - 2)


# --- matrix constructors -----------------------------------------------------

I2 = np.eye(2, dtype=np.complex64)
X_M = np.array([[0, 1], [1, 0]], np.complex64)
Y_M = np.array([[0, -1j], [1j, 0]], np.complex64)
Z_M = np.array([[1, 0], [0, -1]], np.complex64)
H_M = np.array([[1, 1], [1, -1]], np.complex64) * _SQRT2_INV
S_M = np.array([[1, 0], [0, 1j]], np.complex64)
T_M = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], np.complex64)


def rx_m(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], np.complex64)


def ry_m(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], np.complex64)


def rz_m(theta: float) -> np.ndarray:
    e = np.exp(-0.5j * theta)
    return np.array([[e, 0], [0, np.conj(e)]], np.complex64)


def phase_m(phi: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * phi)]], np.complex64)


def swap_m() -> np.ndarray:
    m = np.zeros((4, 4), np.complex64)
    m[0, 0] = m[3, 3] = 1
    m[1, 2] = m[2, 1] = 1
    return m


def fsim_m(theta: float, phi: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.zeros((4, 4), np.complex64)
    m[0, 0] = 1
    m[1, 1] = c
    m[1, 2] = -1j * s
    m[2, 1] = -1j * s
    m[2, 2] = c
    m[3, 3] = np.exp(-1j * phi)
    return m


def random_unitary(dim: int, rng: np.random.Generator) -> np.ndarray:
    """Haar-random unitary via QR of a complex Ginibre matrix."""
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    q = q * (np.diag(r) / np.abs(np.diag(r)))
    return q.astype(np.complex64)


# --- gate constructors --------------------------------------------------------

def h(q: int) -> Gate: return Gate((q,), H_M, name="h")
def x(q: int) -> Gate: return Gate((q,), X_M, name="x")
def y(q: int) -> Gate: return Gate((q,), Y_M, name="y")
def z(q: int) -> Gate: return Gate((q,), Z_M, name="z")
def s(q: int) -> Gate: return Gate((q,), S_M, name="s")
def t(q: int) -> Gate: return Gate((q,), T_M, name="t")
def rx(q: int, theta: float) -> Gate: return Gate((q,), rx_m(theta), name="rx")
def ry(q: int, theta: float) -> Gate: return Gate((q,), ry_m(theta), name="ry")
def rz(q: int, theta: float) -> Gate: return Gate((q,), rz_m(theta), name="rz")


def cnot(c: int, tgt: int) -> Gate:
    return Gate((tgt,), X_M, controls=(c,), name="cnot")


def cz(c: int, tgt: int) -> Gate:
    return Gate((tgt,), Z_M, controls=(c,), name="cz")


def cphase(c: int, tgt: int, phi: float) -> Gate:
    return Gate((tgt,), phase_m(phi), controls=(c,), name="cphase")


def swap(a: int, b: int) -> Gate:
    return Gate((a, b), swap_m(), name="swap")


def fsim(a: int, b: int, theta: float, phi: float) -> Gate:
    return Gate((a, b), fsim_m(theta, phi), name="fsim")


def toffoli(c1: int, c2: int, tgt: int) -> Gate:
    return Gate((tgt,), X_M, controls=(c1, c2), name="ccx")


def mcx(controls: Sequence[int], tgt: int) -> Gate:
    return Gate((tgt,), X_M, controls=tuple(controls), name=f"mc{len(controls)}x")


def mcz(controls: Sequence[int], tgt: int) -> Gate:
    return Gate((tgt,), Z_M, controls=tuple(controls), name=f"mc{len(controls)}z")


def su4(a: int, b: int, rng: np.random.Generator) -> Gate:
    return Gate((a, b), random_unitary(4, rng), name="su4")


# --- unitary algebra (used by the fuser) --------------------------------------

def expand_unitary(sub_qubits: Sequence[int], u: np.ndarray,
                   full_qubits: Sequence[int]) -> np.ndarray:
    """Embed ``u`` acting on ``sub_qubits`` into the space of ``full_qubits``.

    Bit m of the output index corresponds to full_qubits[m].
    """
    full_qubits = tuple(full_qubits)
    k_f = len(full_qubits)
    pos = {q: i for i, q in enumerate(full_qubits)}
    sub_pos = [pos[q] for q in sub_qubits]
    rest_pos = [i for i in range(k_f) if i not in sub_pos]
    # permutation: tensor index order (little-endian axis list)
    dim = 1 << k_f
    out = np.zeros((dim, dim), np.complex64)
    k_s = len(sub_pos)
    for r in range(1 << len(rest_pos)):
        base = 0
        for bi, p in enumerate(rest_pos):
            if (r >> bi) & 1:
                base |= 1 << p
        idx = []
        for a in range(1 << k_s):
            off = base
            for bi, p in enumerate(sub_pos):
                if (a >> bi) & 1:
                    off |= 1 << p
            idx.append(off)
        idx = np.asarray(idx)
        out[np.ix_(idx, idx)] = u
    return out


def matmul_fuse(u_later: np.ndarray, u_earlier: np.ndarray) -> np.ndarray:
    """Vertical fusion: apply u_earlier first, then u_later."""
    return (u_later @ u_earlier).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _identity(k: int) -> np.ndarray:
    return np.eye(1 << k, dtype=np.complex64)


def controlled_to_full(g: Gate) -> tuple[tuple[int, ...], np.ndarray]:
    """Absorb controls into an explicit unitary over all touched qubits."""
    if not g.controls:
        return g.qubits, g.matrix
    full = tuple(g.qubits) + tuple(g.controls)
    dim = 1 << len(full)
    out = np.eye(dim, dtype=np.complex64)
    k = g.k
    cmask_bits = range(k, len(full))
    # rows where every control bit is set
    sel = [i for i in range(dim)
           if all((i >> b) & 1 for b in cmask_bits)]
    # among selected, low-k bits enumerate the target subspace
    for a_out in range(1 << k):
        for a_in in range(1 << k):
            hi = sel[0] & ~((1 << k) - 1)
            out[hi | a_out, hi | a_in] = g.matrix[a_out, a_in]
    return full, out
