#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the port's three CUDA kernels from ``src/repro_torch/kernels/csrc``
(nvcc, sm_90a), holds each kernel against its plain PyTorch version on the
card, drives the port's main path at full width (the paper's five circuits
at n = 30 through ``Simulator.run``, ``Simulator.expectation_z``, and a
QAOA sweep through ``BatchExecutor.run_batch``), checks the states against
the plain ``dense`` backend, and times each kernel at the main path's shapes
beside its bound, its plain version and, where one exists, a single PyTorch
call computing the same function.

The result-mode path runs on the same states and plans: shots on qft30
and ghz30 (``Simulator.sample``; on qft30 every draw is held to a plain
float64 inverse CDF of the same uniforms, equal or across a boundary
within 1e-12 of its uniform), Pauli expectations on ghz30 and qv30
(``Simulator.expectation_pauli``), and expectation, shot and noisy-trajectory
sweeps of qaoa26 through ``BatchExecutor.dispatch_batch(result=...)`` +
``finalize_batch``: expectations against plain reductions of the
statevector sweep, shots bitwise across batch compositions, and each noisy
row against the same row on the planar path.  Each is timed beside its
bound.

Every kernel wrapper counts its launches.  Each path (statevector, result
modes) is driven in segments, with the counts zeroed just before a segment
and read just after it; a kernel a path did not launch fails the run.  The
last two lines of standard output are a JSON object
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero and prints no result.  Without a CUDA
device, or without the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside the tensor cores

KERNELS = {
    "apply_fused_gate": {
        "source": "src/repro_torch/kernels/csrc/apply_gate.cu",
        "replaces": "src/repro/kernels/apply_gate/apply_gate.py:96"},
    "apply_phase_gate": {
        "source": "src/repro_torch/kernels/csrc/phase_gate.cu",
        "replaces": "src/repro/kernels/apply_gate/apply_gate.py:133"},
    "expectation_z": {
        "source": "src/repro_torch/kernels/csrc/expectation.cu",
        "replaces": "src/repro/kernels/expectation/expectation.py:19"},
}
TOL = {"apply_fused_gate": 3e-6, "apply_phase_gate": 3e-6,
       "expectation_z": 1e-5}
# At n = 30 a random state's <Z_q> is of order 2**-15, so K3 is held there
# to a tolerance below that scale, and also checked on a state biased on q.
TOL_Z_FULL = 1e-6
TOL_EXPECT = 1e-5     # result-mode expectations against plain reductions
FULL_N = 30      # qubits of the main path's circuits and kernel timings
BATCH_N = 26     # qubits of the batched QAOA sweep (B = 8, p = 2)
TINY64 = 2.2250738585072014e-308
# a draw may differ from the plain inverse CDF only across a boundary this
# close to its uniform
BOUNDARY_TOL = 1e-12
# a noisy row is compared with the plain path unless one of its uniforms is
# this close to a branch boundary
BRANCH_MARGIN = 1e-6


def say(*parts) -> None:
    print(*parts, flush=True)


def chi2_crit_999(df: int) -> float:
    """99.9% point of the chi-square distribution (Wilson-Hilferty; within
    0.1% of the exact value at df = 1023)."""
    z = 3.090232306167813
    c = 2.0 / (9.0 * df)
    return df * (1.0 - c + z * math.sqrt(c)) ** 3


def plain_cdf(torch, probs):
    """The float64 CDF as one ``torch.cumsum`` over the whole vector (a
    scan order of its own), renormalized: the sampler's plain version."""
    cdf = torch.cumsum(probs.to(torch.float64), 0)
    cdf /= torch.clamp(cdf[-1], min=TINY64)
    return cdf


def plain_draws(torch, cdf, u):
    """The plain inverse CDF's draws for the uniforms ``u``, clamped."""
    idx = torch.searchsorted(cdf, u)
    return torch.clamp(idx, max=cdf.numel() - 1).to(torch.int32)


def equal_or_boundary(torch, got, want, cdf, u) -> tuple[int, int]:
    """Hold the sampler's draws ``got`` to the plain inverse CDF's ``want``
    on the same uniforms ``u``: every draw must be equal, or differ by one
    index with its uniform within 1e-12 of the plain CDF's boundary
    between the two (the two CDFs sum in different orders, so they may
    place a boundary a few ulp apart).  Returns the counts of each kind."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        g, w = got[diff].long(), want[diff].long()
        gap = (u[diff] - cdf[torch.minimum(g, w)]).abs()
        bad = ((g - w).abs() != 1) | (gap > BOUNDARY_TOL)
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"draw {int(diff[i])}: sampler {int(g[i])}, plain "
                f"{int(w[i])}, uniform {float(u[diff[i]])!r} is "
                f"{float(gap[i]):.3g} from the boundary; "
                f"{int(bad.sum())} such draws")
    return got.numel() - diff.numel(), diff.numel()


def result_bounds_ms(plan, b: int) -> tuple[float, float]:
    """``(bound, route)`` of a result-mode run of ``b`` rows, in ms.

    Both start from the gate items' bound (:func:`items_bound_ms`).  The
    bound then adds the least bytes the result steps must move at the
    memory rate: per channel one read of the states for the branch norms
    and one read and write to apply the drawn branch; for the epilogue one
    read of the states (every observable, or every draw, from one pass)
    and the draws written.  The route adds the bytes of the steps built:
    per Kraus branch a K1 pass (read and write) and a read for its norm,
    then one K1 pass for the drawn branch; per single-Z observable a K3
    read, per other string a K1 pass per factor and the inner product's
    two reads; per shot row the sampler's 48 bytes per amplitude."""
    spec = plan.result
    N = 1 << plan.n
    state = 8 * N * b
    least = route = 0
    for it in plan.items:
        if it.kind == "channel":
            least += 3 * state
            route += len(it.kraus) * 3 * state + 2 * state
    if spec.mode == "shots":
        least += state + 4 * spec.shots * b
        route += 6 * state + 4 * spec.shots * b
    else:
        least += state
        for obs in spec.observables:
            route += state if len(obs) == 1 and obs[0][1] == "Z" \
                else len(obs) * 2 * state + 2 * state
    gates = items_bound_ms(plan, b)
    return (gates + least / HBM_BYTES_PER_S * 1e3,
            gates + route / HBM_BYTES_PER_S * 1e3)


def items_bound_ms(plan, b: int) -> float:
    """Least time the card could take for a plan's gate items on ``b`` rows:
    per item, the larger of its bytes (state read and written once, plus
    its unitary / phase planes / perm read once) over the memory rate and
    its fp32 operations over the fp32 rate, summed over the items."""
    N = 1 << plan.n
    total = 0.0
    for it in plan.items:
        if it.kind not in ("dense", "diag", "perm"):
            continue
        w = len(it.qubits)
        rows = 1 if it.is_constant else b
        nbytes = 16 * N * b
        if it.kind == "dense":
            nbytes += 8 * (1 << (2 * w)) * rows
            ops = 8 * (1 << w) * N * b / (1 << len(it.controls))
        else:
            nbytes += 8 * (1 << w) * rows if it.phases else 0
            nbytes += 4 * (1 << w) if it.perm is not None else 0
            ops = 6 * N * b if it.phases else 0
        total += max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)
    return total * 1e3


class Smoke:
    # state sizes of the kernel-vs-plain phases
    fused_n, phase_n, expectation_n = 20, 24, 20

    def __init__(self, torch, args):
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.max_err = {k: 0.0 for k in KERNELS}
        self.report: dict = {"circuits": {}, "timings": {}, "results": {}}
        # launches per path, summed over its counted segments
        self.launches = {path: {k: 0 for k in KERNELS}
                         for path in ("statevector", "result")}

    # -- helpers -----------------------------------------------------------------
    def check(self, kernel: str, got, want, what: str,
              tol: float | None = None) -> float:
        tol = TOL[kernel] if tol is None else tol
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"{kernel} {what}: max |kernel - plain| = "
                                 f"{err:.3g} > {tol}")
        self.max_err[kernel] = max(self.max_err[kernel], err)
        return err

    def random_planar(self, b: int, n: int, seed: int):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn((b, 2, 1 << (n - 5), 32), generator=g,
                        device=self.dev)
        return x / torch.linalg.vector_norm(x.reshape(b, -1), dim=1
                                            ).reshape(b, 1, 1, 1)

    def time_ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        """Median over ``reps`` single launches of ``fn``, CUDA events."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    # -- phase 1: each kernel against its plain version ------------------------------
    def fused_phase(self) -> None:
        import numpy as np
        from repro_torch.core.gates import random_unitary
        from repro_torch.kernels.apply_gate import ops as K, ref as R
        torch = self.torch
        n = self.fused_n
        rng = np.random.default_rng(1)
        cases = 0
        worst = 0.0
        for k in range(1, 8):
            placements = {
                "low": tuple(range(k)),
                "high": tuple(range(n - k, n)),
                "unsorted": tuple(int(q) for q in rng.permutation(
                    [0, 2, 5, 7, n - 9, n - 4, n - 1])[:k]),
            }
            for where, qs in placements.items():
                free = [q for q in range(n) if q not in qs]
                ctrl_sets = [(), (free[len(free) // 2],),
                             (free[1], free[-2]), (free[-1],), (free[0],)]
                for ctrl in ctrl_sets:
                    for b in (1, 4):
                        data = self.random_planar(b, n, seed=cases)
                        u = np.stack([random_unitary(1 << k, rng)
                                      for _ in range(b if cases % 2 else 1)])
                        ur = torch.as_tensor(u.real.astype(np.float32),
                                             device=self.dev)
                        ui = torch.as_tensor(u.imag.astype(np.float32),
                                             device=self.dev)
                        if b == 1:
                            data, ur, ui = data[0], ur[0], ui[0]
                        got = K.apply_fused_gate(data, n, 5, qs, ur, ui, ctrl)
                        # the plain version takes unsorted qubits as they are
                        want = R.apply_fused_gate_ref(data, n, 5, qs, ur, ui,
                                                      ctrl)
                        worst = max(worst, self.check(
                            "apply_fused_gate", got, want,
                            f"k={k} {where} controls={ctrl} B={b}"))
                        cases += 1
        torch.cuda.synchronize()
        say(f"K1 apply_fused_gate vs plain: {cases} cases (n={n}, k=1..7, "
            f"low/high/unsorted qubits, 5 control sets, B=1/4), "
            f"max_abs_err={worst:.3e} (tol 3e-6)")

    def phase_phase(self) -> None:
        import numpy as np
        from repro_torch.kernels.apply_gate import ops as K, ref as R
        torch = self.torch
        n = self.phase_n
        rng = np.random.default_rng(2)
        cases = 0
        worst = 0.0
        for w in range(1, min(20, n - 4) + 1):
            qubits = tuple(sorted(int(q) for q in rng.choice(n, w,
                                                             replace=False)))
            for mode in ("phase", "perm", "both"):
                for b in (1, 4):
                    data = self.random_planar(b, n, seed=100 + cases)
                    rows = b if cases % 2 else 1
                    ang = rng.uniform(0, 2 * np.pi, (rows, 1 << w))
                    p_re = p_im = perm = None
                    if mode != "perm":
                        p_re = torch.as_tensor(np.cos(ang).astype(np.float32),
                                               device=self.dev)
                        p_im = torch.as_tensor(np.sin(ang).astype(np.float32),
                                               device=self.dev)
                    if mode != "phase":
                        perm = torch.as_tensor(
                            rng.permutation(1 << w).astype(np.int32),
                            device=self.dev)
                    if b == 1:
                        data = data[0]
                        if p_re is not None:
                            p_re, p_im = p_re[0], p_im[0]
                    got = K.apply_phase_gate(data, n, 5, qubits, p_re, p_im,
                                             perm=perm)
                    want = R.apply_phase_gate_ref(data, n, 5, qubits, p_re,
                                                  p_im, perm=perm)
                    worst = max(worst, self.check(
                        "apply_phase_gate", got, want,
                        f"w={w} {mode} B={b}"))
                    cases += 1
        torch.cuda.synchronize()
        say(f"K2 apply_phase_gate vs plain: {cases} cases (n={n}, w=1..{w}, "
            f"phase/perm/phase+perm, B=1/4), max_abs_err={worst:.3e} "
            f"(tol 3e-6)")

    def expectation_phase(self) -> None:
        from repro_torch.kernels.expectation import ops as E
        torch = self.torch
        n = self.expectation_n
        worst = 0.0
        for q in (0, 4, 5, n - 1):
            for b in (1, 4):
                data = self.random_planar(b, n, seed=200 + q)
                if b == 1:
                    data = data[0]
                got = E.expectation_z(data, n, 5, q)
                again = E.expectation_z(data, n, 5, q)
                if not torch.equal(got, again):
                    raise AssertionError(f"expectation_z q={q} B={b} does "
                                         f"not repeat bit for bit")
                worst = max(worst, self.check(
                    "expectation_z", got, E.expectation_z_ref(data, n, 5, q),
                    f"q={q} B={b}"))
        torch.cuda.synchronize()
        say(f"K3 expectation_z vs plain: 8 cases (n={n}, q=0/4/5/{n - 1}, "
            f"B=1/4), repeats bit for bit, max_abs_err={worst:.3e} "
            f"(tol 1e-5)")

    # -- phase 2: the main path at full width -----------------------------------------
    def counted(self, path: str, fn):
        """Run ``fn`` with every launch count set to 0 just before it, and
        add the counts read just after it to ``path``'s tally."""
        return self.counted_with(path, fn)[0]

    def counted_with(self, path: str, fn):
        """:meth:`counted`, returning ``fn``'s result with the counts of
        this run."""
        import repro_torch.kernels as RK
        RK.reset_launch_counts()
        out = fn()
        launched = RK.launch_counts()
        for k, c in launched.items():
            self.launches[path][k] += c
        return out, launched

    def main_path(self) -> None:
        import numpy as np
        from repro_torch.core.simulator import Simulator
        from repro_torch.core.target import H100
        from repro_torch.engine import (BatchExecutor, PlanCache,
                                        qaoa_template)
        torch = self.torch
        a = self.args
        sizes = {"qft": a.qft_n, "qv": FULL_N, "ghz": FULL_N,
                 "grover": FULL_N, "qrc": a.qrc_n}
        for name, nn in sizes.items():
            if nn != 30:
                say(f"cut: {name} at n={nn} instead of 30")
        cache = PlanCache()
        sim = Simulator(H100, backend="cuda", plan_cache=cache,
                        device=self.dev)
        dense = Simulator(H100, backend="dense", plan_cache=cache,
                          device=self.dev)
        results = {"qft": self.result_qft, "ghz": self.result_ghz,
                   "qv": self.result_qv}
        for name, nn in sizes.items():
            out = self.counted("statevector", lambda: self.circuit(
                sim, dense, cache, name, nn))
            if name == "qv":
                self.counted("statevector", lambda: self.qv_expectation_z(
                    sim, out))
            if name in results:
                # counts the first run of each result, not its checks
                timing = results[name](sim, out)
                timing()                 # not counted: timing launches
            del out
            torch.cuda.empty_cache()

        nb, batch = BATCH_N, 8
        tmpl = qaoa_template(nb, 2)
        pm = np.random.default_rng(0).uniform(
            -np.pi, np.pi, (batch, tmpl.num_params)).astype(np.float32)
        ex = BatchExecutor(H100, backend="cuda", device=self.dev)
        states = self.counted("statevector", lambda: self.sweep(ex, tmpl, pm))
        timing = self.result_sweep(ex, tmpl, pm, states)
        del states
        torch.cuda.empty_cache()
        timing()
        self.result_hea(ex)

    def circuit(self, sim, dense, cache, name: str, nn: int):
        """One of the paper's circuits through ``Simulator.run``, checked
        against the dense backend; returns the state."""
        from repro_torch.core import circuits as C
        from repro_torch.kernels import launch_counts
        torch = self.torch
        circ = C.build(name, nn, **({"depth": 8} if name == "qrc" else {}))
        t0 = time.perf_counter()
        plan = sim.plan_for(circ)
        compile_s = time.perf_counter() - t0
        kinds = {"dense": 0, "diag": 0, "perm": 0}
        for it in plan.items:
            kinds[it.kind] += 1
        widest = max(len(it.qubits) for it in plan.items)
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(circ)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        del out
        t0 = time.perf_counter()
        out = sim.run(circ)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: after[k] - before[k] for k in after}
        if launches["apply_fused_gate"] != kinds["dense"] or \
                launches["apply_phase_gate"] != kinds["diag"] + \
                kinds["perm"]:
            raise AssertionError(f"{name}{nn}: launches {launches} do "
                                 f"not match items {kinds}")
        norm_err = abs(float(out.norm_sq()) - 1.0)
        t0 = time.perf_counter()
        ref = dense.run(circ)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        dist = float(torch.linalg.vector_norm(out.data - ref.data))
        del ref
        bound = items_bound_ms(plan, 1)
        row = {"n": nn, "items": kinds, "widest_item": widest,
               "compile_s": compile_s, "run_ms_first": first_ms,
               "run_ms_warm": warm_ms, "items_bound_ms": bound,
               "launches": launches,
               "l2_vs_dense": dist, "norm_err": norm_err,
               "dense_s": dense_s}
        if name == "ghz":
            flat = out.data.reshape(2, -1)
            amp = 1 / math.sqrt(2)
            others = torch.cat([flat[0, 1:-1], flat[1]]).abs().max()
            row["ghz_err"] = max(abs(float(flat[0, 0]) - amp),
                                 abs(float(flat[0, -1]) - amp),
                                 float(others))
            if row["ghz_err"] > 1e-5:
                raise AssertionError(f"ghz{nn}: analytic amplitudes off "
                                     f"by {row['ghz_err']:.3g}")
        say(f"{name}{nn}: compile {compile_s:.2f} s, run {first_ms:.1f} ms "
            f"first / {warm_ms:.1f} ms warm (items' bound {bound:.1f} ms,"
            f" {100 * bound / warm_ms:.0f}%), items {kinds} (widest "
            f"{widest}), launches K1={launches['apply_fused_gate']} "
            f"K2={launches['apply_phase_gate']}, |psi-psi_dense|_2="
            f"{dist:.3e}, |norm^2-1|={norm_err:.3e}, dense backend "
            f"{dense_s:.1f} s"
            + (f", ghz amplitude err {row['ghz_err']:.3e}"
               if "ghz_err" in row else ""))
        if not (dist <= 1e-3 and norm_err <= 1e-4):
            raise AssertionError(f"{name}{nn}: state off the dense "
                                 f"backend ({dist:.3g}, {norm_err:.3g})")
        self.report["circuits"][f"{name}{nn}"] = row
        held = cache.held_bytes().get(str(out.device), 0)
        say(f"  plan cache holds {held} bytes on the card after {name}{nn}")
        row["cache_held_bytes"] = held
        return out

    def qv_expectation_z(self, sim, st) -> None:
        from repro_torch.kernels.expectation import ops as E
        nq = st.n
        for q in (0, nq - 1):
            got = sim.expectation_z(st, q)
            want = E.expectation_z_ref(st.data, nq, 5, q)
            err = self.check("expectation_z", got, want, f"qv{nq} q={q}",
                             tol=TOL_Z_FULL)
            say(f"qv{nq} <Z_{q}> = {float(got):+.6e} (plain "
                f"{float(want):+.6e}, |diff| {err:.2e})")
            self.report["circuits"][f"qv{nq}"][f"z{q}"] = float(got)

    def sweep(self, ex, tmpl, pm):
        """The qaoa26 sweep through ``BatchExecutor.run_batch``, checked
        against the dense backend; returns the states."""
        from repro_torch.core.target import H100
        from repro_torch.engine import BatchExecutor
        from repro_torch.kernels import launch_counts
        torch = self.torch
        nb, batch = tmpl.n, pm.shape[0]
        t0 = time.perf_counter()
        plan = ex.plan_for(tmpl)
        compile_s = time.perf_counter() - t0
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = ex.run_batch(tmpl, pm)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        del states
        t0 = time.perf_counter()
        states = ex.run_batch(tmpl, pm)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        refs = BatchExecutor(H100, backend="dense",
                             device=self.dev).run_batch(tmpl, pm)
        worst = max(float(torch.linalg.vector_norm(s.data - r.data))
                    for s, r in zip(states, refs))
        norm_err = max(abs(float(s.norm_sq()) - 1.0) for s in states)
        del refs
        kinds = plan.class_counts()
        bound = items_bound_ms(plan, batch)
        say(f"BatchExecutor qaoa{nb}p2 B={batch}: compile {compile_s:.2f} s, "
            f"run_batch {run_ms:.1f} ms first / {warm_ms:.1f} ms warm "
            f"(items' bound {bound:.1f} ms, {100 * bound / warm_ms:.0f}%), "
            f"items {kinds}, launches "
            f"K1={launches['apply_fused_gate']} "
            f"K2={launches['apply_phase_gate']}, max row |psi-psi_dense|_2="
            f"{worst:.3e}, max |norm^2-1|={norm_err:.3e}")
        if not (worst <= 1e-3 and norm_err <= 1e-4):
            raise AssertionError(f"qaoa{nb} batch off the dense backend "
                                 f"({worst:.3g}, {norm_err:.3g})")
        self.report["batch"] = {"n": nb, "B": batch, "compile_s": compile_s,
                                "run_ms": run_ms, "run_ms_warm": warm_ms,
                                "items_bound_ms": bound,
                                "items": kinds,
                                "launches": launches, "l2_vs_dense": worst}
        return states

    # -- phase 2b: result modes on the main path's states -----------------------------
    def launched(self, before) -> dict:
        from repro_torch.kernels import launch_counts
        after = launch_counts()
        return {k: after[k] - before[k] for k in after}

    def result_timing(self, label: str, ms: float, bound_ms: float,
                      route_ms: float, plain_ms: float, launches: dict,
                      **extra) -> None:
        row = {"ms": ms, "bound_ms": bound_ms, "route_bytes_ms": route_ms,
               "plain_ms": plain_ms,
               "k1_launches": launches["apply_fused_gate"],
               "k2_launches": launches["apply_phase_gate"],
               "k3_launches": launches["expectation_z"], **extra}
        self.report["results"].setdefault("timings", {})[label] = row
        say(f"timing {label}: {ms:.3f} ms warm (bound {bound_ms:.3f} ms at "
            f"3.35 TB/s, {100 * bound_ms / ms:.0f}%; the route's bytes "
            f"{route_ms:.3f} ms), plain {plain_ms:.3f} ms, launches "
            f"K1={row['k1_launches']} K2={row['k2_launches']} "
            f"K3={row['k3_launches']}"
            + "".join(f", {k} {v:.3f}" for k, v in extra.items()))

    def host_ms(self, fn, reps: int = 1) -> float:
        """Median host time of ``fn`` ending in a device synchronize."""
        torch = self.torch
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def result_qft(self, sim, st):
        """Shots on qft30, whose state is uniform: every draw against the
        plain float64 inverse CDF of the same uniforms (equal, or across a
        boundary within 1e-12 of its uniform), and the top and bottom 10
        index bits against uniform; returns the (uncounted) timing."""
        from repro_torch.core import measure as ME
        torch = self.torch
        n = st.n
        N = 1 << n
        shots, key = 1 << 20, 2024
        got = self.counted("result", lambda: sim.sample(st, shots, key))
        if got.device.type != self.dev.type or got.dtype != torch.int32 or \
                tuple(got.shape) != (shots,):
            raise AssertionError(f"sample: {got.device} {got.dtype} "
                                 f"{tuple(got.shape)}")
        u = ME.uniforms(shots, key, self.dev)
        cdf = plain_cdf(torch, ME.probabilities(st))
        equal, boundary = equal_or_boundary(
            torch, got, plain_draws(torch, cdf, u), cdf, u)
        del cdf
        crit = chi2_crit_999(1023)
        stats = {}
        for label, bins in (("top", got >> (n - 10)), ("bottom", got & 1023)):
            obs = torch.bincount(bins.long(), minlength=1024).double()
            e = shots / 1024
            stats[label] = float(((obs - e) ** 2 / e).sum())
        c32 = torch.cumsum(ME.probabilities(st), 0)
        distinct32 = 1 + int((c32[1:] != c32[:-1]).sum())
        del c32
        say(f"qft{n} sample 2**20 against the plain float64 inverse CDF of "
            f"the same uniforms: {equal} draws equal, {boundary} across a "
            f"boundary within {BOUNDARY_TOL} of the uniform, 0 other; "
            f"chi-square top 10 bits {stats['top']:.1f}, bottom 10 bits "
            f"{stats['bottom']:.1f} (99.9% point {crit:.1f}, df 1023); a "
            f"float32 CDF of these probabilities holds {distinct32} distinct "
            f"values for {N} basis states")
        if max(stats.values()) >= crit:
            raise AssertionError(f"qft{n} shots: chi-square {stats}")
        self.report["results"][f"qft{n}"] = {
            "draws_equal": equal, "draws_boundary": boundary, "chi2": stats,
            "chi2_crit": crit, "float32_cdf_distinct": distinct32}

        def timing():
            from repro_torch.kernels import launch_counts
            before = launch_counts()
            ms = self.time_ms(lambda: sim.sample(st, shots, key), reps=5,
                              warmup=1)
            launches = {k: 0 for k in before}   # the sampler launches none
            if self.launched(before) != launches:
                raise AssertionError("the sampler launched a kernel")
            plain_ms = self.time_ms(lambda: plain_draws(
                torch, plain_cdf(torch, ME.probabilities(st)),
                ME.uniforms(shots, key, self.dev)), reps=5, warmup=1)
            # the state read once, the draws written once
            bound = (8 * N + 4 * shots) / HBM_BYTES_PER_S * 1e3
            # the route built: |amp|^2 (8N read, 4N written), the float64
            # copy (4N, 8N), row sums (8N), the row scan (8N, 8N)
            route = (48 * N + 4 * shots) / HBM_BYTES_PER_S * 1e3
            self.result_timing(f"sample qft{n} 2**20 shots", ms, bound,
                               route, plain_ms, launches)
        return timing

    def result_ghz(self, sim, st):
        """Shots and parities on ghz30."""
        from repro_torch.core import measure as ME
        torch = self.torch
        n = st.n
        N = 1 << n
        shots = 1 << 16
        got = self.counted("result", lambda: sim.sample(st, shots, 7))
        zeros = int((got == 0).sum())
        ones = int((got == N - 1).sum())
        sigma = math.sqrt(shots) / 2
        say(f"ghz{n} sample 2**16: {zeros} x |0...0>, {ones} x |1...1> "
            f"(others {shots - zeros - ones}; split {zeros - shots / 2:+.0f} "
            f"= {(zeros - shots / 2) / sigma:+.2f} sigma)")
        if zeros + ones != shots or abs(zeros - shots / 2) > 5 * sigma:
            raise AssertionError(f"ghz{n} shots off: {zeros}, {ones}")
        xs = {q: "X" for q in range(n)}
        vals = {}
        for label, obs, k1, k3 in ((f"Z0 Z{n - 1}", {0: "Z", n - 1: "Z"}, 2,
                                    0),
                                   (f"X^{n}", xs, n, 0),
                                   ("Z0", {0: "Z"}, 0, 1)):
            v, d = self.counted_with("result", lambda: float(
                sim.expectation_pauli(st, obs)))
            want = 0.0 if label == "Z0" else 1.0
            vals[label] = v
            say(f"ghz{n} <{label}> = {v:+.7f} (exact {want:+.0f}), launches "
                f"K1={d['apply_fused_gate']} K3={d['expectation_z']}")
            if abs(v - want) > TOL_EXPECT or d["apply_fused_gate"] != k1 \
                    or d["expectation_z"] != k3:
                raise AssertionError(f"ghz{n} <{label}> = {v}, launches {d}")
        self.report["results"][f"ghz{n}"] = {"zeros": zeros, "ones": ones,
                                             **vals}

        def timing():
            ms = self.time_ms(lambda: sim.expectation_pauli(st, xs), reps=3,
                              warmup=1)
            plain_ms = self.time_ms(lambda: ME.expectation_pauli(
                st, xs, plain=True), reps=1, warmup=0)
            # n K1 passes (state read and written) and the inner product
            # (two states read): the route built, and its bound
            bound = (n * 16 * N + 16 * N) / HBM_BYTES_PER_S * 1e3
            self.result_timing(f"ghz{n} <X^{n}>", ms, bound, bound,
                               plain_ms,
                               {"apply_fused_gate": n, "apply_phase_gate": 0,
                                "expectation_z": 0})
        return timing

    def result_qv(self, sim, st):
        """Pauli strings on qv30 against the plain path.  A random state's
        values are of order 2**-15, so they are held to 1e-6 (as K3 is at
        n = 30), and again on a normalized copy biased so that both strings
        are far from 0: qubit 0 pulled towards |+>, qubit 29 towards |+i>
        (<X_0 Y_29> near 4/9; a wrong sign of Y flips it), and the
        amplitudes with bit 3 != bit 17 halved (<Z_3 Z_17> near 3/5)."""
        import dataclasses
        from repro_torch.core import measure as ME
        torch = self.torch
        n = st.n
        strings = ({0: "X", n - 1: "Y"}, {3: "Z", 17: "Z"})
        biased = st.data.clone()
        flat = biased.view(2, 2, -1, 2)          # plane, bit n-1, .., bit 0
        flat[..., 1] += flat[..., 0]
        flat[..., 1] *= 0.5
        lo, hi = flat[:, 0], flat[:, 1]          # bit n-1 = 0, 1
        hi[0] -= lo[1]                           # amp1 += i * amp0
        hi[1] += lo[0]
        hi *= 0.5
        del flat, lo, hi
        odd = biased.view(2, 1 << (n - 18), 2, 1 << 13, 2, 1 << 3)
        odd[:, :, 0, :, 1] *= 0.5
        odd[:, :, 1, :, 0] *= 0.5
        del odd
        biased /= torch.sqrt(ME.inner_re(biased, biased))
        report = self.report["results"].setdefault(f"qv{n}", {})
        tol = TOL_Z_FULL
        for which, state in (("", st),
                             (" biased", dataclasses.replace(st, data=biased))):
            for obs in strings:
                if which:
                    got = float(sim.expectation_pauli(state, obs))
                else:          # the path's own run
                    got = float(self.counted("result", lambda: (
                        sim.expectation_pauli(state, obs))))
                torch.cuda.empty_cache()
                want = float(ME.expectation_pauli(state, obs, plain=True))
                torch.cuda.empty_cache()
                label = " ".join(f"{p}{q}" for q, p in sorted(obs.items()))
                say(f"qv{n}{which} <{label}> = {got:+.7e} (plain "
                    f"{want:+.7e}, |diff| {abs(got - want):.2e}, tol {tol})")
                if abs(got - want) > tol:
                    raise AssertionError(f"qv{n}{which} <{label}> off the "
                                         f"plain path")
                if which and not abs(want) > 0.1:
                    raise AssertionError(f"biased qv{n}: <{label}> = {want}")
                report[label + which] = got
        del biased, state
        torch.cuda.empty_cache()
        return lambda: None

    def plain_observables(self, data, n: int, observables):
        """f32[B, O]: each observable by the plain versions on stacked
        states (K3's plain version for a single Z, else the fused gate's per
        factor and the inner product)."""
        from repro_torch.core import measure as ME
        from repro_torch.kernels.apply_gate import ref as R
        from repro_torch.kernels.expectation import ops as E
        torch = self.torch
        cols = []
        for obs in observables:
            items = sorted(obs.items())
            if len(items) == 1 and items[0][1] == "Z":
                cols.append(E.expectation_z_ref(data, n, 5, items[0][0]))
                continue
            pd = data
            for q, p in items:
                ur, ui = ME.pauli_planes(p, data.device)
                pd = R.apply_fused_gate_ref(pd, n, 5, (q,), ur, ui)
            cols.append(ME.inner_re(data, pd))
            del pd
        return torch.stack(cols, dim=1)

    def branch_margins(self, plan, prefix, rowkeys):
        """Per noisy row, the least distance of its channel uniforms from a
        branch boundary (a running sum of the branch norms over their
        total), and the branch it draws at each channel, replayed with the
        plain versions from the row's prefix state ``prefix[r]`` and the
        plan's stream seeds."""
        import itertools
        from repro_torch.core import measure as ME
        from repro_torch.engine import plan as PL
        from repro_torch.kernels.apply_gate import ref as R
        torch = self.torch
        chans = [it for it in plan.items if it.kind == "channel"]
        margins, picks = [], []
        for row, (key, traj) in zip(prefix, rowkeys):
            psi, least = row, math.inf
            picks.append([])
            for i, it in enumerate(chans):
                kr, ki = it.kraus_planes(self.dev)
                branches = [R.apply_fused_gate_ref(psi, plan.n, 5, it.qubits,
                                                   kr[j], ki[j])
                            for j in range(kr.shape[0])]
                norms = [float(ME.inner_re(x, x)) for x in branches]
                g = ME.generator(ME.mix64(int(key), int(traj),
                                          PL._CHANNEL_SALT + i), self.dev)
                u = float(torch.rand(1, dtype=torch.float64, generator=g,
                                     device=self.dev))
                cums = list(itertools.accumulate(norms))
                least = min([least] + [abs(u - c / cums[-1])
                                       for c in cums[:-1]])
                pick = next((j for j, c in enumerate(cums[:-1])
                             if c > u * cums[-1]), len(cums) - 1)
                psi = branches[pick] / math.sqrt(norms[pick])
                picks[-1].append(pick)
                del branches
            margins.append(least)
        return margins, picks

    def uncounted(self, fn):
        """Run ``fn`` outside every path's tally (a check, not the path's
        own run); return its result with the launches it made."""
        from repro_torch.kernels import launch_counts
        before = launch_counts()
        out = fn()
        return out, self.launched(before)

    def result_sweep(self, ex, tmpl, pm, states):
        """qaoa26 p = 2, B = 8 in the three result modes through
        ``dispatch_batch(result=...)`` + ``finalize_batch``.  The first run
        of each mode is the result path's own and counts; reruns in other
        batch compositions and the further channel runs are checks."""
        import numpy as np
        from repro_torch.engine import (ResultSpec, amplitude_damping,
                                        bit_flip, depolarizing)
        torch = self.torch
        n, b = tmpl.n, pm.shape[0]
        data = torch.stack([s.data for s in states])

        def run(spec, params, rowkeys=None):
            plan, raw = ex.dispatch_batch(tmpl, params, result=spec,
                                          rowkeys=rowkeys)
            return torch.stack(ex.finalize_batch(plan, raw))

        def compiled(spec):
            t0 = time.perf_counter()
            plan = ex.plan_for(tmpl, result=spec)
            return plan, time.perf_counter() - t0

        def k123(d):
            return (f"K1={d['apply_fused_gate']} K2={d['apply_phase_gate']} "
                    f"K3={d['expectation_z']}")

        report = self.report["results"].setdefault(f"qaoa{n}", {})
        # expectation: the ring's MaxCut terms, Z_0 (K3) and X_0
        ring = [{a: "Z", (a + 1) % n: "Z"} for a in range(n)]
        obs = ring + [{0: "Z"}, {0: "X"}]
        espec = ResultSpec.expectation(obs)
        eplan, compile_s = compiled(espec)
        got, elaunch = self.counted_with("result", lambda: run(espec, pm))
        want = self.plain_observables(data, n, obs)
        err = float((got - want).abs().max())
        energy = ((1.0 - got[:, :n]) / 2).sum(1)
        plain_energy = ((1.0 - want[:, :n].double()) / 2).sum(1)
        energy_err = float((energy.double() - plain_energy).abs().max())
        # ring[0] is Z_0 Z_1
        zz_ideal, z0_ideal = want[:, 0].clone(), want[:, n].clone()
        x0_ideal = want[:, n + 1].clone()
        say(f"qaoa{n} expectation B={b}, {len(obs)} observables: compile "
            f"{compile_s:.2f} s, max |payload - plain| {err:.2e} (tol "
            f"{TOL_EXPECT}), MaxCut energy per row "
            f"{[round(float(e), 5) for e in energy]} (max |energy - plain| "
            f"{energy_err:.2e}), launches {k123(elaunch)}")
        if err > TOL_EXPECT or elaunch["expectation_z"] != 1:
            raise AssertionError(f"qaoa{n} expectations off ({err:.3g}) or "
                                 f"K3 launches {elaunch}")
        report["expectation"] = {"max_err": err, "compile_s": compile_s,
                                 "launches": elaunch,
                                 "energy": [float(e) for e in energy]}
        del want, got, data
        torch.cuda.empty_cache()

        # shots: the same rows as B = 8, as 3 + 5 and one by one
        sspec = ResultSpec.sample(4096, key=0)
        keys = np.array([[7000 + r, 0] for r in range(b)], np.uint32)
        splan, compile_s = compiled(sspec)
        full, slaunch = self.counted_with("result",
                                          lambda: run(sspec, pm, keys))
        head = run(sspec, pm[:3], keys[:3])
        tail = run(sspec, pm[3:], keys[3:])
        split_ok = torch.equal(torch.cat([head, tail]), full)
        ones_ok = all(torch.equal(run(sspec, pm[r:r + 1], keys[r:r + 1]),
                                  full[r:r + 1]) for r in range(b))
        in_range = int(full.min()) >= 0 and int(full.max()) < 1 << n
        say(f"qaoa{n} shots B={b} x 4096: compile {compile_s:.2f} s, "
            f"bitwise equal as 3 + 5: {split_ok}, one by one: {ones_ok}, "
            f"in range: {in_range}, launches {k123(slaunch)}")
        if not (split_ok and ones_ok and in_range and
                full.dtype == torch.int32):
            raise AssertionError(f"qaoa{n} shots differ across batch "
                                 f"compositions")
        report["shots"] = {"compile_s": compile_s, "launches": slaunch}

        # noisy: each row held to the same row on the planar path (the
        # plan's items run by the plain versions) with the same rowkeys.
        # <X_0> shows which depolarizing branch a row drew (its Y and Z
        # branches flip its sign; qaoa's <Z_0> is 0 whatever the branch)
        def noisy(label, spec, reqs, key0, count):
            unr = spec.unravelings
            params = np.repeat(pm[reqs], unr, axis=0)
            rks = np.array([[key0 + r, t] for r in reqs for t in range(unr)],
                           np.uint32)
            plan, compile_s = compiled(spec)
            first = lambda: run(spec, params, rks)  # noqa: E731
            vals, launched = (self.counted_with("result", first) if count
                              else self.uncounted(first))
            rerun_ok = torch.equal(run(spec, params, rks), vals)
            plain_vals = plan.with_backend("planar").run_batch_result_raw(
                params, rks, device=self.dev)
            torch.cuda.empty_cache()
            margins, picks = self.branch_margins(
                plan, [states[r].data for r in reqs for _ in range(unr)],
                rks)
            kept = [r for r, m in enumerate(margins) if m > BRANCH_MARGIN]
            chans = [it for it in plan.items if it.kind == "channel"]
            drawn = [{k: sum(picks[r][i] == k for r in kept)
                      for k in range(len(it.kraus))}
                     for i, it in enumerate(chans)]
            row_err = float((vals[kept] - plain_vals[kept]).abs().max())
            say(f"qaoa{n} noisy {label}, {len(rks)} rows: compile "
                f"{compile_s:.2f} s, max |row - planar row| {row_err:.2e} "
                f"over {len(kept)} rows (tol {TOL_EXPECT}; "
                f"{len(rks) - len(kept)} excluded with a uniform within "
                f"{BRANCH_MARGIN} of a branch boundary, least margin "
                f"{min(margins):.3g}; branches drawn per channel in the rows "
                f"compared {drawn}), rerun bitwise equal: {rerun_ok}, "
                f"<Z_0>, <Z_5>, <X_0> per row "
                f"{[[round(v, 6) for v in r] for r in vals.tolist()]}, "
                f"launches {k123(launched)}")
            if not rerun_ok or row_err > TOL_EXPECT:
                raise AssertionError(f"qaoa{n} noisy {label}: rows off the "
                                     f"planar path ({row_err:.3g}) or rerun "
                                     f"{rerun_ok}")
            info = {"compile_s": compile_s, "launches": launched,
                    "rerun_bitwise": rerun_ok, "row_err": row_err,
                    "rows_compared": len(kept),
                    "rows_excluded": len(rks) - len(kept),
                    "least_margin": min(margins), "branches_drawn": drawn,
                    "payload": vals.tolist()}
            return plan, params, rks, launched, info

        nobs = [{0: "Z"}, {5: "Z"}, {0: "X"}]
        nspec = ResultSpec.noisy([depolarizing(0, 0.1),
                                  amplitude_damping(5, 0.2)], nobs,
                                 unravelings=8)
        nplan, npm, nkeys, nlaunch, report["noisy"] = noisy(
            "depolarizing(0, 0.1) + amplitude_damping(5, 0.2)", nspec,
            [0, 1], 900, count=True)
        # p = 3/4 draws each depolarizing branch with probability 1/4: the
        # comparison covers the X, Y and Z branches at full width too
        *_, uinfo = noisy("depolarizing(0, 0.75)", ResultSpec.noisy(
            [depolarizing(0, 0.75)], nobs, unravelings=8), [2], 950,
            count=False)
        report["noisy_uniform_branches"] = uinfo
        if not any(c for k, c in uinfo["branches_drawn"][0].items() if k):
            raise AssertionError(f"qaoa{n} depolarizing(0, 0.75): no X, Y "
                                 f"or Z branch among the rows compared")
        # a certain flip of qubit 0 negates <Z_0> and <Z_0 Z_1> and keeps
        # <X_0>
        flip = ResultSpec.noisy([bit_flip(0, 1.0)],
                                [{0: "Z"}, {0: "Z", 1: "Z"}, {0: "X"}],
                                unravelings=1)
        fplan, fcompile_s = compiled(flip)
        fv = run(flip, pm)
        ferr = max(float((fv[:, 0] + z0_ideal).abs().max()),
                   float((fv[:, 1] + zz_ideal).abs().max()),
                   float((fv[:, 2] - x0_ideal).abs().max()))
        say(f"qaoa{n} bit_flip(0, 1) B={b} (compile {fcompile_s:.2f} s): max "
            f"|<Z_0> + <Z_0>_ideal|, |<Z_0 Z_1> + <Z_0 Z_1>_ideal|, |<X_0> - "
            f"<X_0>_ideal| = {ferr:.2e} (tol {TOL_EXPECT}; <Z_0 Z_1>_ideal "
            f"per row {[round(float(v), 5) for v in zz_ideal]})")
        if ferr > TOL_EXPECT:
            raise AssertionError(f"qaoa{n} bit flip off ({ferr:.3g})")
        report["noisy"]["bit_flip_err"] = ferr

        def timing():
            sv = self.report["batch"]["run_ms_warm"]
            for label, plan, spec, params, rk, launches in (
                    ("expectation", eplan, espec, pm, None, elaunch),
                    ("shots", splan, sspec, pm, keys, slaunch),
                    ("noisy", nplan, nspec, npm, nkeys, nlaunch)):
                ms = self.host_ms(lambda: run(spec, params, rk), reps=3)
                twin = plan.with_backend("planar")
                rows = len(params)
                rk_ = rk if rk is not None else np.zeros((rows, 2), np.uint32)
                plain_ms = self.host_ms(lambda: twin.run_batch_result_raw(
                    params, rk_, device=self.dev))
                del twin
                torch.cuda.empty_cache()
                bound, route = result_bounds_ms(plan, rows)
                self.result_timing(
                    f"qaoa{n} {label} sweep B={rows}", ms, bound, route,
                    plain_ms, launches, statevector_sweep_ms=sv)
        return timing

    def result_hea(self, ex):
        """K3 on the result path held against values far from 0.  QAOA's
        <Z_q> is 0 by its global bit-flip symmetry, so an hea26 (2 layers)
        B = 8 sweep takes single-Z observables through K3, in expectation
        mode and under a certain bit flip of qubit 0, each held to the
        plain reductions of the sweep's states (a check: not counted)."""
        import numpy as np
        from repro_torch.engine import ResultSpec, bit_flip, hea_template
        torch = self.torch
        n, b = BATCH_N, 8
        tmpl = hea_template(n, 2)
        pm = np.random.default_rng(1).uniform(
            -np.pi, np.pi, (b, tmpl.num_params)).astype(np.float32)
        t0 = time.perf_counter()
        states, _ = self.uncounted(lambda: ex.run_batch(tmpl, pm))
        compile_s = time.perf_counter() - t0
        data = torch.stack([s.data for s in states])
        del states
        obs = [{0: "Z"}, {n // 2: "Z"}, {n - 1: "Z"}, {0: "Z", 1: "Z"}]
        want = self.plain_observables(data, n, obs)
        del data
        torch.cuda.empty_cache()
        singles = float(want[:, :3].abs().max())
        report = self.report["results"].setdefault(f"hea{n}", {})
        for label, spec, sign in (
                ("expectation", ResultSpec.expectation(obs), (1, 1, 1, 1)),
                ("bit_flip(0, 1)", ResultSpec.noisy([bit_flip(0, 1.0)], obs,
                                                    unravelings=1),
                 (-1, 1, 1, -1))):
            got, d = self.uncounted(lambda: torch.stack(ex.finalize_batch(
                *ex.dispatch_batch(tmpl, pm, result=spec))))
            err = float((got - want * torch.tensor(sign, device=self.dev))
                        .abs().max())
            say(f"hea{n}x2 {label} B={b}: <Z_0>, <Z_{n // 2}>, "
                f"<Z_{n - 1}>, <Z_0 Z_1> per row "
                f"{[[round(v, 6) for v in r] for r in got.tolist()]}, max "
                f"|payload - plain| {err:.2e} (tol {TOL_EXPECT}; largest "
                f"single-Z value {singles:.4f}), launches "
                f"K1={d['apply_fused_gate']} K2={d['apply_phase_gate']} "
                f"K3={d['expectation_z']}")
            if err > TOL_EXPECT or d["expectation_z"] != 3:
                raise AssertionError(f"hea{n} {label}: off the plain path "
                                     f"({err:.3g}) or K3 launches {d}")
            report[label] = {"max_err": err, "launches": d,
                             "payload": got.tolist()}
        if not singles > 0.1:
            raise AssertionError(f"hea{n}: single-Z values near 0 "
                                 f"({singles})")
        report["sweep_compile_and_run_s"] = compile_s

    # -- phase 3: kernel timings at the main path's shapes ------------------------------
    def shape(self, kernel: str, label: str, fn, plain, nbytes: float,
              ops: float, lib=None, lib_name: str | None = None) -> dict:
        """Check ``fn`` against ``plain`` on the card, then time the kernel,
        its plain version and, where one PyTorch call computes the same
        function, that call (``lib``; else ``lib_name`` says why not).
        The bound is the larger of ``nbytes`` at the memory rate and ``ops``
        fp32 operations at the fp32 rate."""
        torch = self.torch
        got = fn()
        err = self.check(kernel, got, plain(), label)
        del got
        ms = self.time_ms(fn)
        plain_ms = self.time_ms(plain)
        lib_ms = self.time_ms(lib) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / FP32_FLOPS_PER_S
        row = {"kernel": kernel, "shape": label, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": lib_name, "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err}
        row["share"] = row["bound_ms"] / ms
        lib_txt = (f"{lib_ms:.3f} ms ({lib_name})" if lib_ms is not None
                   else f"null ({lib_name})")
        say(f"{'K1' if kernel == 'apply_fused_gate' else 'K2'} {label}: "
            f"{ms:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, {100 * row['share']:.0f}%), plain "
            f"{plain_ms:.3f} ms, library {lib_txt}, max_abs_err {err:.2e}")
        self.report["timings"]["shapes"].append(row)
        torch.cuda.empty_cache()
        return row

    def fused_shapes(self, data, rng) -> dict:
        """K1 at n = 30 (and the qaoa sweep's n = 26, B = 8)."""
        import numpy as np
        from repro_torch.core.gates import random_unitary
        from repro_torch.kernels.apply_gate import ops as K, ref as R
        torch = self.torch
        n, N = FULL_N, 1 << FULL_N

        def planes(k, rows=None):
            u = np.stack([random_unitary(1 << k, rng)
                          for _ in range(rows or 1)])
            ur = torch.as_tensor(u.real.astype(np.float32), device=self.dev)
            ui = torch.as_tensor(u.imag.astype(np.float32), device=self.dev)
            return (ur, ui) if rows else (ur[0], ui[0])

        def einsum_lib(x, qs, ur, ui, nq):
            """One ``torch.einsum`` of U (as 2k binary axes) with the
            complex state viewed as nq binary axes."""
            k = len(qs)
            letters = [chr(ord("a") + i) for i in range(26)] + \
                [chr(ord("A") + i) for i in range(26)]
            st = letters[:nq]                   # axis i <-> qubit nq-1-i
            rows_ = letters[nq:nq + k]          # row bit m <-> qs[m]
            cols = list(st)
            outs = list(st)
            for m, q in enumerate(qs):
                outs[nq - 1 - q] = rows_[m]
            spec = ("".join(reversed(rows_)) +
                    "".join(cols[nq - 1 - q] for q in reversed(qs)) + "," +
                    "".join(cols) + "->" + "".join(outs))
            psi = torch.complex(x[0], x[1]).reshape((2,) * nq)
            uc = torch.complex(ur, ui).reshape((2,) * (2 * k))
            return lambda: torch.einsum(spec, uc, psi)

        rows = {}
        for label, qs, ctrl, lib in [
                (f"k={self.f} top bits", tuple(range(n - self.f, n)), (),
                 "matmul_top"),
                ("k=4 qubits 0-3", (0, 1, 2, 3), (), "matmul_low"),
                ("k=4 qv30 (0,6,21,23)", (0, 6, 21, 23), (), "einsum"),
                ("k=4 qv30 (1,2,9,26)", (1, 2, 9, 26), (), "einsum"),
                (f"k=1 grover, {n - 1} controls", (n - 1,),
                 tuple(range(n - 1)), None),
                ("k=7 top bits", tuple(range(n - 7, n)), (), "matmul_top")]:
            k = len(qs)
            ur, ui = planes(k)
            libfn, lib_name = None, None
            if lib == "matmul_top":   # U @ psi viewed [2^k, 2^(n-k)]
                psi = torch.complex(data[0], data[1]).reshape(1 << k, -1)
                uc = torch.complex(ur, ui)
                libfn, lib_name = (lambda: torch.matmul(uc, psi)), \
                    "torch.matmul, complex view"
            elif lib == "matmul_low":  # psi viewed [2^(n-k), 2^k] @ U^T
                psi = torch.complex(data[0], data[1]).reshape(-1, 1 << k)
                ut = torch.complex(ur, ui).T.contiguous()
                libfn, lib_name = (lambda: torch.matmul(psi, ut)), \
                    "torch.matmul by U^T, complex view"
            elif lib == "einsum":
                libfn = einsum_lib(data, qs, ur, ui, n)
                lib_name = "torch.einsum on a binary-axis view"
            else:
                lib_name = "no single call applies a controlled gate"
            rows[label] = self.shape(
                "apply_fused_gate", f"n={n} {label}",
                lambda: K.apply_fused_gate(data, n, 5, qs, ur, ui, ctrl),
                lambda: R.apply_fused_gate_ref(data, n, 5, qs, ur, ui, ctrl),
                16 * N + 8 * (1 << (2 * k)),
                8 * (1 << k) * N / (1 << len(ctrl)), libfn, lib_name)
            libfn = psi = None

        nb, b = BATCH_N, 8
        batch = self.random_planar(b, nb, seed=11)
        ur, ui = planes(4, rows=b)
        psi = torch.complex(batch[:, 0], batch[:, 1]).reshape(b, -1, 16)
        ut = torch.complex(ur, ui).transpose(1, 2).contiguous()
        qs = (0, 1, 2, 3)
        rows["k=4 qubits 0-3, B=8 per-row U"] = self.shape(
            "apply_fused_gate", f"n={nb} B={b} k=4 qubits 0-3 per-row U",
            lambda: K.apply_fused_gate(batch, nb, 5, qs, ur, ui),
            lambda: R.apply_fused_gate_ref(batch, nb, 5, qs, ur, ui),
            b * (16 * (1 << nb) + 8 * 256), b * 8 * 16 * (1 << nb),
            lambda: torch.matmul(psi, ut), "batched torch.matmul by U^T")
        del batch, psi
        torch.cuda.empty_cache()
        return rows

    def phase_shapes(self, data, rng) -> dict:
        """K2 at n = 30 (and the qaoa sweep's n = 26, B = 8)."""
        import numpy as np
        from repro_torch.kernels.apply_gate import ops as K, ref as R
        torch = self.torch
        n, N = FULL_N, 1 << FULL_N

        def phases(w, rows=None):
            ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (rows or 1,
                                                             1 << w)),
                                  dtype=torch.float32, device=self.dev)
            p_re, p_im = torch.cos(ang), torch.sin(ang)
            return (p_re, p_im) if rows else (p_re[0], p_im[0])

        def perm_of(w):
            return torch.as_tensor(rng.permutation(1 << w).astype(np.int32),
                                   device=self.dev)

        rows = {}
        w = self.phase_w
        top = tuple(range(n - w, n))
        p_re, p_im = phases(w)
        psi = torch.complex(data[0], data[1]).reshape(1 << w, -1)
        ph = torch.complex(p_re, p_im)[:, None]
        rows["pure phase top bits"] = self.shape(
            "apply_phase_gate", f"n={n} pure phase w={w} top bits",
            lambda: K.apply_phase_gate(data, n, 5, top, p_re, p_im),
            lambda: R.apply_phase_gate_ref(data, n, 5, top, p_re, p_im),
            16 * N + 8 * (1 << w), 6 * N, lambda: torch.mul(psi, ph),
            "torch.mul, broadcast phase")
        # qft30's wide diagonals: bits 0..23 plus bit 29
        qft = tuple(range(w - 1)) + (n - 1,)
        psi = torch.complex(data[0], data[1]).reshape(2, -1, 1 << (w - 1))
        ph = torch.complex(p_re, p_im).reshape(2, 1, 1 << (w - 1))
        rows["qft30 low bits"] = self.shape(
            "apply_phase_gate",
            f"n={n} pure phase w={w} bits 0-{w - 2} + {n - 1}",
            lambda: K.apply_phase_gate(data, n, 5, qft, p_re, p_im),
            lambda: R.apply_phase_gate_ref(data, n, 5, qft, p_re, p_im),
            16 * N + 8 * (1 << w), 6 * N, lambda: torch.mul(psi, ph),
            "torch.mul, phase broadcast over a view")
        psi = ph = None
        torch.cuda.empty_cache()
        # qft30's perm + phase items: bits 0..k-2 plus one high bit
        qs = tuple(range(12)) + (max(12, n - 12),)
        p_re, p_im = phases(13)
        perm = perm_of(13)
        rows["perm+phase w=13"] = self.shape(
            "apply_phase_gate", f"n={n} perm+phase w=13 bits 0-11 + {qs[-1]}",
            lambda: K.apply_phase_gate(data, n, 5, qs, p_re, p_im, perm=perm),
            lambda: R.apply_phase_gate_ref(data, n, 5, qs, p_re, p_im,
                                           perm=perm),
            16 * N + 12 * (1 << 13), 6 * N, None,
            "the cluster is two axes of the state; no single gather")
        perm = perm_of(4)
        for qs, lib in (((0, 1, 2, 3), True),
                        (tuple(sorted({0, 7, n - 11, n - 1})), False)):
            libfn = None
            if lib:
                psi = torch.complex(data[0], data[1]).reshape(-1, 16)
                libfn = (lambda: torch.index_select(psi, 1, perm))
            rows[f"perm w=4 {qs}"] = self.shape(
                "apply_phase_gate", f"n={n} permutation w=4 qubits {qs}",
                lambda: K.apply_phase_gate(data, n, 5, qs, None, None,
                                           perm=perm),
                lambda: R.apply_phase_gate_ref(data, n, 5, qs, None, None,
                                               perm=perm),
                16 * N + 4 * 16, 0, libfn,
                "torch.index_select on the cluster axis" if lib else
                "the cluster is four axes of the state; no single gather")
            psi = libfn = None
        # qaoa26's per-row wide diagonals: bits 0..20, B = 8
        nb, b = BATCH_N, 8
        batch = self.random_planar(b, nb, seed=12)
        qs = tuple(range(21))
        p_re, p_im = phases(21, rows=b)
        psi = torch.complex(batch[:, 0], batch[:, 1]).reshape(b, -1, 1 << 21)
        ph = torch.complex(p_re, p_im).reshape(b, 1, 1 << 21)
        rows["qaoa26 per-row"] = self.shape(
            "apply_phase_gate", f"n={nb} B={b} pure phase w=21 bits 0-20 "
            f"per-row phases",
            lambda: K.apply_phase_gate(batch, nb, 5, qs, p_re, p_im),
            lambda: R.apply_phase_gate_ref(batch, nb, 5, qs, p_re, p_im),
            b * (16 * (1 << nb) + 8 * (1 << 21)), b * 6 * (1 << nb),
            lambda: torch.mul(psi, ph), "torch.mul, phase broadcast over a "
            "view")
        del batch, psi, ph
        torch.cuda.empty_cache()
        return rows

    def timings(self) -> dict:
        from repro_torch.kernels.expectation import ops as E
        import numpy as np
        torch = self.torch
        n = FULL_N
        N = 1 << n
        rows = {}
        self.report["timings"]["shapes"] = []
        data = self.random_planar(1, n, seed=7)[0]
        rng = np.random.default_rng(3)

        fused = self.fused_shapes(data, rng)
        # the kernels line keeps its first shapes: K1 k = f on the top bits
        rows["apply_fused_gate"] = fused[f"k={self.f} top bits"]
        self.report["timings"]["apply_fused_gate"] = fused
        phase = self.phase_shapes(data, rng)
        rows["apply_phase_gate"] = phase["pure phase top bits"]
        self.report["timings"]["apply_phase_gate"] = phase

        for q in (n - 1, 0):
            got = E.expectation_z(data, n, 5, q)
            self.check("expectation_z", got,
                       E.expectation_z_ref(data, n, 5, q), f"n={n} q={q}",
                       tol=TOL_Z_FULL)
            # bit q = 1 amplitudes halved: <Z_q> near 3/8, far from 0
            biased = data.clone()
            biased.view(2, -1, 2, 1 << q)[:, :, 1] *= 0.5
            got = E.expectation_z(biased, n, 5, q)
            want = E.expectation_z_ref(biased, n, 5, q)
            if not abs(float(want)) > 0.1:
                raise AssertionError(f"biased state: <Z_{q}> = {float(want)}")
            err = self.check("expectation_z", got, want,
                             f"n={n} q={q} biased", tol=TOL_Z_FULL)
            say(f"K3 n={n} q={q} biased state: {float(got):+.7f} (plain "
                f"{float(want):+.7f}, |diff| {err:.2e}, tol {TOL_Z_FULL})")
            del biased
        ms = self.time_ms(lambda: E.expectation_z(data, n, 5, n - 1))
        plain = self.time_ms(lambda: E.expectation_z_ref(data, n, 5, n - 1))
        ms0 = self.time_ms(lambda: E.expectation_z(data, n, 5, 0))
        t_bytes = 8 * N / HBM_BYTES_PER_S
        t_ops = 4 * N / FP32_FLOPS_PER_S
        rows["expectation_z"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        r = rows["expectation_z"]
        say(f"K3 n={n} q={n - 1}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f}"
            f" ms by {r['bound_by']}), plain {r['plain_ms']:.3f} ms, library "
            f"null (no single call computes <Z_q>); q=0: {ms0:.3f} ms")
        self.report["timings"]["expectation_z"] = dict(r, q0_ms=ms0)
        del data
        torch.cuda.empty_cache()
        return rows


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--qft-n", type=int, default=30,
                   help="qubits of qft (cut only when the time limit forces)")
    p.add_argument("--qrc-n", type=int, default=30,
                   help="qubits of qrc, depth 8 (cut as qft)")
    p.add_argument("--out", default=None,
                   help="also write every number as JSON to this file")
    p.add_argument("--timings-only", action="store_true",
                   help="build the kernels and time them at the main path's "
                        "shapes (phase 3) only; prints no result line")
    p.add_argument("--src", default=os.path.join(ROOT, "src"),
                   help="directory holding the repro_torch package to time "
                        "(another checkout's, to compare two versions of "
                        "the kernels in one run)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch.kernels as RK
    from repro_torch.core.fusion import choose_f
    from repro_torch.core.target import H100, row_budget
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    say(f"choose_f(H100) = {choose_f(H100)}")
    t0 = time.perf_counter()
    built = _build.build()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(built)) or 'all present'})")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    smoke = Smoke(torch, args)
    # main-path shapes timed: K1 at the fused degree, K2 at the diagonal cap
    smoke.f, smoke.phase_w = choose_f(H100), row_budget(FULL_N, H100)
    if args.timings_only:
        say(f"timings only, kernels of {RK.__file__}")
        smoke.timings()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(smoke.report, fh, indent=1)
        say(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    smoke.fused_phase()
    smoke.phase_phase()
    smoke.expectation_phase()

    smoke.main_path()
    for path, counts in smoke.launches.items():
        say(f"{path} path launches: {counts}")
        missing = [k for k, c in counts.items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} "
                                 f"path: {missing}")
    launches = {k: sum(c[k] for c in smoke.launches.values())
                for k in KERNELS}
    smoke.report["launches"] = smoke.launches

    rows = smoke.timings()
    kernels = []
    for name, meta in KERNELS.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": meta["source"],
                        "replaces": meta["replaces"],
                        "launches": launches[name],
                        "max_abs_err": smoke.max_err[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    smoke.report.update(kernels=kernels, nvidia_smi=smi,
                        seconds=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(smoke.report, fh, indent=1)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
