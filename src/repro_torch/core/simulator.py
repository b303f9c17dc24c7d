"""High-level simulator API.

``Simulator`` ties together layout (statevec), fusion, and the execution
backend:

* ``backend="dense"``  — naive baseline: complex64, gate-by-gate, no fusion.
* ``backend="planar"`` — VLA design in plain PyTorch on the lane-tiled layout.
* ``backend="cuda"``   — VLA design with the hand-written CUDA kernels: one
  fused-gate or diagonal/permutation kernel launch per plan item.

Fusion degree ``f`` defaults to ``choose_f(target)`` — the machine-balance
adaptation of paper §IV-D.  The simulator runs on ``device`` (default
``"cuda"``, which raises without a card); pass ``device="cpu"`` to run the
plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core import measure as ME
from repro_torch.core import statevec as SV
from repro_torch.core.circuits import Circuit
from repro_torch.core.fusion import choose_f
from repro_torch.core.target import H100, Target
from repro_torch.kernels.expectation import ops as E

if TYPE_CHECKING:
    from repro_torch.engine.plan import CompiledPlan, PlanCache


@dataclasses.dataclass
class Simulator:
    target: Target = H100
    backend: str = "cuda"          # dense | planar | cuda
    f: int | None = None           # horizontal fusion degree; None = auto
    fuse: bool = True
    specialize: bool = True        # gate-class-specialized plan lowering
    plan_cache: PlanCache | None = None  # None = shared global cache
    device: str | torch.device = "cuda"

    def __post_init__(self):
        # imported here, as the JAX package does: the engine's modules
        # import this package, so a module-level import would be a cycle
        # for a caller who imports ``repro_torch.engine`` first
        from repro_torch.engine import plan as PL
        if self.backend not in PL.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {PL.BACKENDS}")
        self.device = SV.resolve_device(self.device)
        if self.f is None:
            self.f = choose_f(self.target) if self.fuse else 0
        if self.plan_cache is None:
            self.plan_cache = PL.GLOBAL_PLAN_CACHE

    def plan_for(self, circuit) -> CompiledPlan:
        """Resolve the compiled execution plan for a circuit or template."""
        return self.plan_cache.get_or_compile(
            circuit, backend=self.backend, target=self.target, f=self.f,
            fuse=self.fuse, specialize=self.specialize)

    def run(self, circuit: Circuit, initial: SV.State | None = None,
            params: Sequence[float] | np.ndarray | None = None) -> SV.State:
        """Execute one circuit (or one binding of a circuit template).
        Fusion and lowering happen once per circuit structure through the
        plan cache."""
        return self.plan_for(circuit).run(params=params, initial=initial,
                                          device=self.device)

    def expectation_z(self, state: SV.State, qubit: int) -> torch.Tensor:
        """<Z_q> as a streaming reduction (the paper's ExpectationValue
        avoids storing states back): the kernel on the cuda backend, the
        plain version otherwise."""
        if self.backend == "cuda":
            return E.expectation_z(state.data, state.n, state.v, qubit)
        return E.expectation_z_ref(state.data, state.n, state.v, qubit)

    def probabilities(self, state: SV.State) -> torch.Tensor:
        """|amplitude|^2 in dense basis order (see ``State.probabilities``)."""
        return state.probabilities()

    def sample(self, state: SV.State, n_samples: int,
               key=None) -> torch.Tensor:
        """``n_samples`` basis-state indices ~ |amp|^2 (int32), drawn with
        a float64 CDF on the state's device; ``key`` is a
        ``torch.Generator`` or an integer seed (default 0)."""
        return ME.sample(state, n_samples, 0 if key is None else key)

    def expectation_pauli(self, state: SV.State, paulis) -> torch.Tensor:
        """<P> for a Pauli string ``{qubit: 'X'|'Y'|'Z'}``.

        On the cuda backend a single-qubit Z is one launch of the ``<Z_q>``
        kernel, and every other string one fused-gate launch per factor
        before the inner product (``repro_torch.core.measure``); the other
        backends apply the factors with the plain version."""
        items = list(paulis.items())
        if (self.backend == "cuda" and len(items) == 1
                and str(items[0][1]).upper() == "Z"):
            return E.expectation_z(state.data, state.n, state.v,
                                   int(items[0][0]))
        return ME.expectation_pauli(state, paulis,
                                    plain=self.backend != "cuda")
