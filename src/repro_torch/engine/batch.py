"""Batch executor: one compiled plan serving a whole parameter sweep.

Hand ``BatchExecutor`` a :class:`CircuitTemplate` plus a ``[B, P]``
parameter matrix and it resolves one plan through the cache, then runs that
plan's program over the batch: every kernel takes the batch axis natively,
so B structurally identical circuits cost one fusion pass and one launch
per plan item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import statevec as SV
from repro_torch.core.circuits import Circuit
from repro_torch.core.target import H100, Target
from repro_torch.engine.plan import (BACKENDS, CacheStats, CompiledPlan,
                                     PlanCache)
from repro_torch.engine.template import CircuitTemplate, template_of


@dataclasses.dataclass
class BatchExecutor:
    """Executes batches of parameter bindings against cached plans."""

    target: Target = H100
    backend: str = "cuda"            # dense | planar | cuda
    f: int | None = None             # fusion degree; None = auto
    fuse: bool = True
    specialize: bool = True          # gate-class-specialized plan lowering
    cache: PlanCache | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {BACKENDS}")
        self.device = SV.resolve_device(self.device)
        if self.cache is None:
            self.cache = PlanCache()

    def plan_for(self, template: CircuitTemplate | Circuit) -> CompiledPlan:
        return self.cache.get_or_compile(
            template, backend=self.backend, target=self.target, f=self.f,
            fuse=self.fuse, specialize=self.specialize)

    def plan_key(self, template: CircuitTemplate | Circuit) -> tuple:
        """The cache key :meth:`plan_for` resolves ``template`` to — the
        key requests with the same structure batch under."""
        if isinstance(template, Circuit):
            template = template_of(template)
        return self.cache.plan_key(
            template, backend=self.backend, target=self.target, f=self.f,
            fuse=self.fuse, specialize=self.specialize)

    def run(self, template: CircuitTemplate | Circuit, params=None,
            initial: SV.State | None = None) -> SV.State:
        """Single binding (a batch of one)."""
        return self.plan_for(template).run(params=params, initial=initial,
                                           device=self.device)

    def run_batch(self, template: CircuitTemplate | Circuit,
                  params_matrix, initial: SV.State | None = None,
                  ) -> list[SV.State]:
        """Run a [B, P] parameter matrix through one compiled plan."""
        plan, raw = self.dispatch_batch(template, params_matrix,
                                        initial=initial)
        return plan.wrap_batch(raw)

    def dispatch_batch(self, template: CircuitTemplate | Circuit,
                       params_matrix, initial: SV.State | None = None,
                       ) -> tuple[CompiledPlan, torch.Tensor]:
        """Launch without waiting: resolve the plan and enqueue the batched
        program, returning the stacked output ``[B, ...]`` (statevector
        mode), whose device work may still be in flight."""
        params_matrix = np.atleast_2d(np.asarray(params_matrix, np.float32))
        plan = self.plan_for(template)
        return plan, plan.run_batch_raw(params_matrix, initial=initial,
                                        device=self.device)

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats

    def class_counts(self) -> dict:
        """Fused-gate counts by lowering class across all cached plans."""
        return self.cache.class_counts()
