"""The port's single-device state-vector path against the JAX package.

``Simulator.run`` on the paper's circuits and ``BatchExecutor.run_batch`` on
parameter sweeps, for every backend: the port's ``cuda`` backend (its kernel
wrappers run their plain versions on the CPU) against JAX ``pallas`` (Pallas
in interpret mode), ``planar`` against ``planar`` and ``dense`` against
``dense``.  States cross as numpy arrays; the tolerance is the reference
suite's 5e-6 for whole circuits (tests/test_kernels.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import circuits as JC  # noqa: E402
from repro.core import statevec as JSV  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.target import CPU_TEST as J_CPU  # noqa: E402
from repro.engine import BatchExecutor as JBatchExecutor  # noqa: E402
from repro.engine import hea_template as j_hea  # noqa: E402
from repro.engine import qaoa_template as j_qaoa  # noqa: E402
from repro_torch.convert import circuit_from_fields, state_from_numpy  # noqa: E402
from repro_torch.core import circuits as TC  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.target import CPU_TEST  # noqa: E402
from repro_torch.engine import (BatchExecutor, PlanCache,  # noqa: E402
                                hea_template, qaoa_template)
from repro_torch.kernels import launch_counts  # noqa: E402

PAIRS = [("cuda", "pallas"), ("planar", "planar"), ("dense", "dense")]
CIRCUITS = [("ghz", 8, {}), ("qft", 7, {}), ("qv", 6, {}), ("grover", 6, {}),
            ("qrc", 6, {"depth": 8})]


@functools.lru_cache(maxsize=None)
def _jax_state(name, n, depth, backend):
    kw = {"depth": depth} if depth else {}
    circ = JC.build(name, n, **kw)
    return np.asarray(JSimulator(J_CPU, backend=backend).run(circ).to_dense())


@pytest.mark.parametrize("name,n,kw", CIRCUITS)
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_simulator_matches_reference(name, n, kw, backend, jax_backend):
    sim = Simulator(CPU_TEST, backend=backend, device="cpu",
                    plan_cache=PlanCache())
    out = sim.run(TC.build(name, n, **kw))
    assert out.data.device.type == "cpu" and out.n == n
    ref = _jax_state(name, n, kw.get("depth"), jax_backend)
    np.testing.assert_allclose(out.to_dense().numpy(), ref, atol=5e-6)
    assert float(out.norm_sq()) == pytest.approx(1.0, abs=1e-5)


@functools.lru_cache(maxsize=None)
def _sweep(which, b):
    n, p = 6, 2
    jt = {"qaoa": j_qaoa, "hea": j_hea}[which](n, p)
    tt = {"qaoa": qaoa_template, "hea": hea_template}[which](n, p)
    pm = np.random.default_rng(b).uniform(
        -np.pi, np.pi, (b, jt.num_params)).astype(np.float32)
    return jt, tt, pm


@functools.lru_cache(maxsize=None)
def _jax_sweep(which, backend):
    jt, _, pm = _sweep(which, 4)
    return [np.asarray(s.to_dense()) for s in
            JBatchExecutor(J_CPU, backend=backend).run_batch(jt, pm)]


@pytest.mark.parametrize("which", ["qaoa", "hea"])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_batch_executor_matches_reference(which, backend, jax_backend):
    _, tt, pm = _sweep(which, 4)
    ex = BatchExecutor(CPU_TEST, backend=backend, device="cpu")
    states = ex.run_batch(tt, pm)
    ref = _jax_sweep(which, jax_backend)
    assert len(states) == 4
    for s, r in zip(states, ref):
        np.testing.assert_allclose(s.to_dense().numpy(), r, atol=5e-6)
    # one compile serves the sweep; a single binding runs the same plan
    one = ex.run(tt, params=pm[2])
    np.testing.assert_allclose(one.to_dense().numpy(), ref[2], atol=5e-6)
    assert ex.stats.compiles == 1 and ex.stats.hits == 1


def test_dispatch_batch_and_plan_key():
    _, tt, pm = _sweep("qaoa", 4)
    ex = BatchExecutor(CPU_TEST, backend="cuda", device="cpu")
    plan, raw = ex.dispatch_batch(tt, pm)
    assert tuple(raw.shape) == (4, 2, 8, 8)
    assert ex.plan_key(tt) == ex.cache.plan_key(
        tt, backend="cuda", target=CPU_TEST, f=None, fuse=True)
    assert len(plan.wrap_batch(raw, count=3)) == 3
    with pytest.raises(ValueError, match="parameters per row"):
        ex.run_batch(tt, pm[:, :3])


def test_initial_state_and_expectation_match_reference():
    n = 6
    rng = np.random.default_rng(9)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    jinit = JSV.from_dense(psi, n, J_CPU)
    jsim = JSimulator(J_CPU, backend="planar")
    jc = JC.qv(n)
    jout = jsim.run(jc, initial=jinit)
    circ = circuit_from_fields(
        n, [(g.qubits, g.matrix, g.controls, g.name) for g in jc.gates])
    init = state_from_numpy(np.asarray(jinit.data), n, jinit.v, device="cpu")
    for backend in ("cuda", "planar", "dense"):
        sim = Simulator(CPU_TEST, backend=backend, device="cpu")
        out = sim.run(circ, initial=init)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout.data),
                                   atol=5e-6)
        for q in (0, 3, 5):
            ref = float(jsim.expectation_z(jout, q))
            assert abs(float(sim.expectation_z(out, q)) - ref) < 1e-5
        np.testing.assert_allclose(sim.probabilities(out).numpy(),
                                   np.asarray(jout.probabilities()),
                                   atol=5e-6)


def test_plan_cache_reports_held_device_bytes():
    cache = PlanCache()
    sim = Simulator(CPU_TEST, backend="cuda", device="cpu", plan_cache=cache)
    circ = TC.qft(6)
    sim.run(circ)
    plan = sim.plan_for(circ)
    held = cache.held_bytes()
    assert held == plan.held_bytes() and held["cpu"] > 0
    diag = [it for it in plan.items if it.kind == "diag"]
    assert diag
    for it in diag:      # at least its f32 (re, im) phase planes
        assert it.held_bytes()["cpu"] >= 8 << len(it.qubits)
    cache.clear()
    assert cache.held_bytes() == {}


def test_cuda_backend_on_cpu_launches_no_kernel():
    """On the CPU every wrapper takes its plain version; nothing counts as a
    launch."""
    before = launch_counts()
    sim = Simulator(CPU_TEST, backend="cuda", device="cpu")
    st_ = sim.run(TC.qft(6))
    sim.expectation_z(st_, 2)
    assert launch_counts() == before
