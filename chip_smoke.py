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

Every kernel wrapper counts its launches; the counts are zeroed just before
the main path and read just after it, and a kernel the path did not launch
fails the run.  The last two lines of standard output are a JSON object
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
FULL_N = 30      # qubits of the main path's circuits and kernel timings
BATCH_N = 26     # qubits of the batched QAOA sweep (B = 8, p = 2)


def say(*parts) -> None:
    print(*parts, flush=True)


def items_bound_ms(plan, b: int) -> float:
    """Least time the card could take for a plan's items on ``b`` rows: per
    item, the larger of its bytes (state read and written once, plus its
    unitary / phase planes / perm read once) over the memory rate and its
    fp32 operations over the fp32 rate, summed over the items."""
    N = 1 << plan.n
    total = 0.0
    for it in plan.items:
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
        self.report: dict = {"circuits": {}, "timings": {}}

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
    def main_path(self) -> None:
        import numpy as np
        from repro_torch.core import circuits as C
        from repro_torch.core.simulator import Simulator
        from repro_torch.core.target import H100
        from repro_torch.engine import (BatchExecutor, PlanCache,
                                        qaoa_template)
        from repro_torch.kernels import launch_counts
        from repro_torch.kernels.expectation import ops as E
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
        qv_state = None
        for name, nn in sizes.items():
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
            self.report["circuits"][f"{name}{nn}"]["cache_held_bytes"] = held
            if name == "qv":
                qv_state = out
            del out
            torch.cuda.empty_cache()

        nq = sizes["qv"]
        for q in (0, nq - 1):
            got = sim.expectation_z(qv_state, q)
            want = E.expectation_z_ref(qv_state.data, nq, 5, q)
            err = self.check("expectation_z", got, want, f"qv{nq} q={q}",
                             tol=TOL_Z_FULL)
            say(f"qv{nq} <Z_{q}> = {float(got):+.6e} (plain "
                f"{float(want):+.6e}, |diff| {err:.2e})")
            self.report["circuits"][f"qv{nq}"][f"z{q}"] = float(got)
        del qv_state
        torch.cuda.empty_cache()

        nb, batch = BATCH_N, 8
        tmpl = qaoa_template(nb, 2)
        pm = np.random.default_rng(0).uniform(
            -np.pi, np.pi, (batch, tmpl.num_params)).astype(np.float32)
        ex = BatchExecutor(H100, backend="cuda", device=self.dev)
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
        del states, refs
        torch.cuda.empty_cache()

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

    RK.reset_launch_counts()
    smoke.main_path()
    launches = RK.launch_counts()
    say(f"main-path launches: {launches}")
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

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
