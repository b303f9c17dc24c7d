"""Batch executor: one compiled plan serving a whole parameter sweep.

Hand ``BatchExecutor`` a :class:`CircuitTemplate` plus a ``[B, P]``
parameter matrix and it resolves one plan through the cache, then runs that
plan's program over the batch: every kernel takes the batch axis natively,
so B structurally identical circuits cost one fusion pass and one launch
per plan item.  A :class:`~repro_torch.engine.results.ResultSpec` asks for
shots, Pauli expectations or noisy trajectories instead of states
(``dispatch_batch(..., result=spec, rowkeys=...)`` + ``finalize_batch``).
Shot batches (one circuit, many initial states) go through ``run_states``.
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

    def plan_for(self, template: CircuitTemplate | Circuit,
                 result=None) -> CompiledPlan:
        return self.cache.get_or_compile(
            template, backend=self.backend, target=self.target, f=self.f,
            fuse=self.fuse, specialize=self.specialize, result=result)

    def plan_key(self, template: CircuitTemplate | Circuit,
                 result=None) -> tuple:
        """The cache key :meth:`plan_for` resolves ``template`` to — the
        key requests with the same structure batch under.  A result spec
        contributes its structural component only, so requests differing
        just in PRNG key or unraveling count share a plan."""
        if isinstance(template, Circuit):
            template = template_of(template)
        return self.cache.plan_key(
            template, backend=self.backend, target=self.target, f=self.f,
            fuse=self.fuse, specialize=self.specialize, result=result)

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
                       result=None, rowkeys=None,
                       ) -> tuple[CompiledPlan, torch.Tensor]:
        """Launch without waiting: resolve the plan and enqueue the batched
        program, returning the stacked output ``[B, ...]``, whose device
        work may still be in flight; retire it with :meth:`finalize_batch`.

        ``result`` (a :class:`~repro_torch.engine.results.ResultSpec`)
        dispatches the result-mode program instead; ``rowkeys`` is the
        matching ``uint32[B, 2]`` of per-row (request key, trajectory
        index) pairs — all zeros when omitted.
        """
        params_matrix = np.atleast_2d(np.asarray(params_matrix, np.float32))
        plan = self.plan_for(template, result=result)
        if plan.result is not None:
            if rowkeys is None:
                rowkeys = np.zeros((params_matrix.shape[0], 2), np.uint32)
            return plan, plan.run_batch_result_raw(
                params_matrix, rowkeys, initial=initial, device=self.device)
        return plan, plan.run_batch_raw(params_matrix, initial=initial,
                                        device=self.device)

    def finalize_batch(self, plan: CompiledPlan, raw: torch.Tensor,
                       count: int | None = None) -> list:
        """Blocking retire step for :meth:`dispatch_batch`: wait for the
        output (a CUDA event recorded on the stream it was made on), then
        hand back the first ``count`` rows (all, by default) — as
        :class:`~repro_torch.core.statevec.State` s in statevector mode, as
        per-row payload tensors in a result mode."""
        if raw.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(raw.device))
            done.synchronize()
        count = raw.shape[0] if count is None else count
        if plan.result is not None:
            return [raw[b] for b in range(count)]
        return plan.wrap_batch(raw, count=count)

    def run_states(self, template: CircuitTemplate | Circuit,
                   initials, params=None) -> list[SV.State]:
        """Shot-batch path: one circuit over B initial states, each row
        its own initial state (on the states' device)."""
        initials = list(initials)
        if not initials:
            raise ValueError("run_states needs at least one initial state "
                             "(got an empty sequence)")
        plan = self.plan_for(template)
        if plan.backend == "dense":
            data0 = torch.stack([s.to_dense() for s in initials])
        else:
            data0 = torch.stack([s.data for s in initials])
        if params is None:
            params = np.zeros((plan.num_params,), np.float32)
        pm = np.repeat(np.asarray(params, np.float32).reshape(1, -1),
                       len(initials), axis=0)
        out = plan.run_batch_raw(pm, initial_batch=data0)
        return [plan._wrap(out[b]) for b in range(out.shape[0])]

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats

    def class_counts(self) -> dict:
        """Fused-gate counts by lowering class across all cached plans."""
        return self.cache.class_counts()
