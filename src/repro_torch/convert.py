"""Carry states and circuits into and out of the port through numpy only.

The JAX package and the port share no objects; a test (or any caller that
holds both) moves a planar state as a ``float32[2, R, V]`` array and a
circuit as plain fields.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.core.circuits import Circuit
from repro_torch.core.gates import Gate
from repro_torch.core.statevec import State, resolve_device


def state_from_numpy(data: np.ndarray, n: int, v: int,
                     device: str | torch.device = "cuda") -> State:
    """A planar ``float32[2, R, V]`` array (``R * V = 2**n``, ``V = 2**v``)
    as a port :class:`State` on ``device``.  ``State.numpy()`` is the
    inverse."""
    arr = np.array(data, dtype=np.float32)       # an own, writable copy
    if arr.shape != (2, 1 << (n - v), 1 << v):
        raise ValueError(f"planar data {arr.shape} is not "
                         f"(2, {1 << (n - v)}, {1 << v})")
    return State(data=torch.as_tensor(arr, device=resolve_device(device)),
                 n=n, v=v)


def circuit_from_fields(n: int, fields: Iterable, name: str = "circuit",
                        ) -> Circuit:
    """A port :class:`Circuit` from ``(qubits, matrix, controls, name)``
    tuples, one per gate in application order."""
    gates = [Gate(tuple(int(q) for q in qubits),
                  np.asarray(matrix, np.complex64),
                  controls=tuple(int(c) for c in controls), name=str(gname))
             for qubits, matrix, controls, gname in fields]
    return Circuit(n, gates, name=name)
