"""Host-side parity of the port with the JAX package.

Gates, circuits, fusion clustering, the plan compiler's item lists, template
structure keys, the cost model, layouts and the plain gate applications are
held against the JAX package on the same inputs (built from numpy seeds and
compared as numpy arrays).  Also: the port's entry points refuse to run
without CUDA unless asked for the CPU, and no module of the port imports JAX
or the JAX package.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core.apply as JA  # noqa: E402
import repro.core.circuits as JC  # noqa: E402
import repro.core.fusion as JF  # noqa: E402
import repro.core.gates as JG  # noqa: E402
import repro.core.metrics as JM  # noqa: E402
import repro.core.statevec as JSV  # noqa: E402
import repro.core.target as JT  # noqa: E402
import repro.engine.plan as JP  # noqa: E402
import repro.engine.template as JTP  # noqa: E402
import repro_torch.core.apply as TA  # noqa: E402
import repro_torch.core.circuits as TC  # noqa: E402
import repro_torch.core.fusion as TF  # noqa: E402
import repro_torch.core.gates as TG  # noqa: E402
import repro_torch.core.metrics as TM  # noqa: E402
import repro_torch.core.statevec as TSV  # noqa: E402
import repro_torch.core.target as TT  # noqa: E402
import repro_torch.engine.plan as TP  # noqa: E402
import repro_torch.engine.template as TTP  # noqa: E402
from repro_torch.convert import circuit_from_fields, state_from_numpy  # noqa: E402
from repro_torch.engine.batch import BatchExecutor  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# every concrete builder of core.circuits, at n <= 10, with fixed angles for
# the parameterized ones
_KW = {"qaoa": lambda n: {"gammas": [0.3, -0.8], "betas": [1.1, 0.4]},
       "hea": lambda n: {"thetas": np.linspace(-1.0, 1.0, 4 * n)},
       "qrc": lambda n: {"depth": 8}}
WORKLOADS = [(name, n) for name in sorted(JC.BUILDERS) for n in (4, 7, 10)]


def _build_both(name, n):
    kw = _KW.get(name, lambda n: {})(n)
    return JC.build(name, n, **kw), TC.build(name, n, **kw)


def _assert_gates_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert (ga.qubits, ga.controls, ga.name) == (gb.qubits, gb.controls,
                                                     gb.name)
        assert np.array_equal(ga.matrix, gb.matrix)


# -- targets, gates, circuits ------------------------------------------------------

def test_targets_and_fusion_degree_match():
    for name in ("cpu_test", "arm_grace", "arm_graviton3", "arm_a64fx"):
        j, t = JT.get_target(name), TT.get_target(name)
        assert dataclasses.astuple(j) == dataclasses.astuple(t)
        for max_f in (4, 7):
            assert JF.choose_f(j, max_f=max_f) == TF.choose_f(t, max_f=max_f)
        for n in (3, 8, 20):
            assert JT.row_budget(n, j) == TT.row_budget(n, t)
    assert TF.choose_f(TT.H100) == 4
    assert TT.H100.lane_qubits == 5
    assert TT.row_budget(30, TT.H100) == 25


def test_gate_library_matches():
    for ctor in ("h", "x", "y", "z", "s", "t"):
        assert np.array_equal(getattr(JG, ctor)(2).matrix,
                              getattr(TG, ctor)(2).matrix)
    for theta in (0.0, 0.7, -2.9):
        for m in ("rx_m", "ry_m", "rz_m", "phase_m"):
            assert np.array_equal(getattr(JG, m)(theta), getattr(TG, m)(theta))
        assert np.array_equal(JG.fsim_m(theta, 0.3), TG.fsim_m(theta, 0.3))
    assert np.array_equal(JG.swap_m(), TG.swap_m())
    for dim in (2, 4, 8):
        assert np.array_equal(JG.random_unitary(dim, np.random.default_rng(5)),
                              TG.random_unitary(dim, np.random.default_rng(5)))
    g = JG.su4(1, 3, np.random.default_rng(2))
    assert TG.gate_class(g.matrix) == JG.gate_class(g.matrix)
    for mk in (JG.cnot(0, 2), JG.cphase(1, 0, 0.4), JG.swap(0, 1)):
        tg = TG.Gate(mk.qubits, mk.matrix, mk.controls)
        jq, jm = JG.controlled_to_full(mk)
        tq, tm = TG.controlled_to_full(tg)
        assert jq == tq and np.array_equal(jm, tm)


@pytest.mark.parametrize("name,n", WORKLOADS)
def test_circuits_match(name, n):
    j, t = _build_both(name, n)
    assert (j.n, j.name) == (t.n, t.name)
    _assert_gates_equal(j.gates, t.gates)


# -- fusion clustering ---------------------------------------------------------------

@pytest.mark.parametrize("name,n", WORKLOADS)
@pytest.mark.parametrize("class_aware", [False, True])
def test_cluster_gates_match(name, n, class_aware):
    j, t = _build_both(name, n)
    for f in (2, 3):
        kw = {"diag_f": max(f, n - 3)} if class_aware else {}
        jprep, jspecs = JF.cluster_gates(j.gates, f, **kw)
        tprep, tspecs = TF.cluster_gates(t.gates, f, **kw)
        _assert_gates_equal(jprep, tprep)
        assert [(s.qubits, s.controls, s.members, s.cls) for s in jspecs] == \
            [(s.qubits, s.controls, s.members, s.cls) for s in tspecs]
        _assert_gates_equal(JF.fuse_circuit(j.gates, f),
                            TF.fuse_circuit(t.gates, f))


# -- plan lowering ---------------------------------------------------------------------

def _assert_items_match(jitems, titems):
    assert len(jitems) == len(titems)
    for a, b in zip(jitems, titems):
        assert (a.kind, a.qubits, a.controls) == (b.kind, b.qubits, b.controls)
        assert a.generic_flops == b.generic_flops
        if a.perm is None:
            assert b.perm is None
        else:
            assert np.array_equal(a.perm, b.perm)
        assert [p[0] for p in a.phases] == [p[0] for p in b.phases]
        for pa, pb in zip(a.phases, b.phases):
            if pa[0] == "const":
                np.testing.assert_allclose(pa[1], pb[1], atol=1e-6)
            else:
                assert (pa[1].param, pa[1].kind) == (pb[1].param, pb[1].kind)
                np.testing.assert_allclose(pa[2], pb[2], atol=1e-6)
        assert [f[0] for f in a.factors] == [f[0] for f in b.factors]
        for fa, fb in zip(a.factors, b.factors):
            if fa[0] == "const":
                np.testing.assert_allclose(fa[1], fb[1], atol=1e-6)
            else:
                assert (fa[1].param, fa[1].kind) == (fb[1].param, fb[1].kind)
                for ma, mb in zip(fa[2], fb[2]):
                    assert np.array_equal(ma, mb)


@pytest.mark.parametrize("name,n", WORKLOADS)
@pytest.mark.parametrize("backends", [("pallas", "cuda"),
                                      ("planar", "planar")])
def test_compile_plan_items_match(name, n, backends):
    j, t = _build_both(name, n)
    jp = JP.compile_plan(JTP.template_of(j), backend=backends[0],
                         target=JT.CPU_TEST)
    tp = TP.compile_plan(TTP.template_of(t), backend=backends[1],
                         target=TT.CPU_TEST)
    assert (jp.f, jp.specialize) == (tp.f, tp.specialize)
    _assert_items_match(jp.items, tp.items)
    jprof, tprof = jp.profile.as_dict(), tp.profile.as_dict()
    assert jprof.keys() == tprof.keys()
    for k in jprof:
        assert jprof[k] == pytest.approx(tprof[k], rel=1e-12), k


@pytest.mark.parametrize("which", ["qaoa", "hea"])
@pytest.mark.parametrize("backends", [("pallas", "cuda"),
                                      ("planar", "planar"),
                                      ("dense", "dense")])
def test_compile_plan_template_items_match(which, backends):
    mk = {"qaoa": lambda M: M.qaoa_template(8, 2),
          "hea": lambda M: M.hea_template(6, 2)}[which]
    jt, tt = mk(JTP), mk(TTP)
    assert jt.structure_key() == tt.structure_key()
    for specialize in (True, False):
        jp = JP.compile_plan(jt, backend=backends[0], target=JT.CPU_TEST,
                             specialize=specialize)
        tp = TP.compile_plan(tt, backend=backends[1], target=TT.CPU_TEST,
                             specialize=specialize)
        _assert_items_match(jp.items, tp.items)


def test_param_items_build_the_same_unitaries_and_phases():
    """PlanItem.unitary / phase_planes batched over rows equal the JAX
    per-binding values."""
    jt, tt = JTP.qaoa_template(6, 2), TTP.qaoa_template(6, 2)
    pm = np.random.default_rng(0).uniform(-3, 3, (3, 4)).astype(np.float32)
    for specialize in (True, False):
        jp = JP.compile_plan(jt, backend="pallas", target=JT.CPU_TEST,
                             specialize=specialize)
        tp = TP.compile_plan(tt, backend="cuda", target=TT.CPU_TEST,
                             specialize=specialize)
        for a, b in zip(jp.items, tp.items):
            if a.kind == "dense":
                u = b.unitary(torch.as_tensor(pm)).numpy()
                for r in range(3):
                    ref = np.asarray(a.unitary(jnp.asarray(pm[r])))
                    np.testing.assert_allclose(u[r % u.shape[0]], ref,
                                               atol=1e-6)
            elif a.phases:
                pr, pi = b.phase_planes(torch.as_tensor(pm))
                for r in range(3):
                    jr, ji = a.phase_planes(jnp.asarray(pm[r]))
                    np.testing.assert_allclose(pr[r % pr.shape[0]].numpy(),
                                               np.asarray(jr), atol=1e-6)
                    np.testing.assert_allclose(pi[r % pi.shape[0]].numpy(),
                                               np.asarray(ji), atol=1e-6)


@pytest.mark.parametrize("name,n", WORKLOADS)
def test_structure_key_byte_identical(name, n):
    j, t = _build_both(name, n)
    assert JTP.template_of(j).structure_key() == \
        TTP.template_of(t).structure_key()


def test_template_structure_keys_and_bind_match():
    for p in (1, 2, 3):
        assert JTP.qaoa_template(7, p).structure_key() == \
            TTP.qaoa_template(7, p).structure_key()
    assert JTP.hea_template(5, 3).structure_key() == \
        TTP.hea_template(5, 3).structure_key()
    params = np.array([0.3, -0.7, 0.9, 0.2])
    _assert_gates_equal(JTP.qaoa_template(6, 2).bind(params).gates,
                        TTP.qaoa_template(6, 2).bind(params).gates)
    angles = torch.tensor([0.0, 0.5, -2.0, 3.1])
    for kind in ("rx", "ry", "rz", "phase"):
        got = TTP.PARAM_KINDS[kind].torch_fn(angles).numpy()
        for i, a in enumerate(angles.tolist()):
            ref = np.asarray(JTP.PARAM_KINDS[kind].jax_fn(jnp.float32(a)))
            np.testing.assert_allclose(got[i], ref, atol=1e-6)


def test_plan_cache_and_key():
    cache = TP.PlanCache()
    t = TTP.qaoa_template(5, 2)
    for _ in range(3):
        cache.get_or_compile(t, backend="cuda", target=TT.CPU_TEST)
    assert (cache.stats.compiles, cache.stats.misses, cache.stats.hits) == \
        (1, 1, 2)
    key = cache.plan_key(t, backend="cuda", target=TT.CPU_TEST, f=None,
                         fuse=True)
    # the last component is the result spec's structural key (statevector)
    assert key == (t.structure_key(), "cuda", "cpu_test", 2, True, None)
    cache.get_or_compile(t, backend="planar", target=TT.CPU_TEST)
    assert len(cache) == 2 and cache.stats.compile_summary()["count"] == 2
    with pytest.raises(ValueError, match="unknown backend"):
        TP.compile_plan(t, backend="pallas", target=TT.CPU_TEST)


# -- cost model ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qft", "qaoa", "grover"])
def test_cost_model_matches(name):
    j, t = _build_both(name, 8)
    for spec in (False, True):
        a = JM.circuit_cost(j.gates, 8, JT.CPU_TEST, specialized=spec)
        b = TM.circuit_cost(t.gates, 8, TT.CPU_TEST, specialized=spec)
        assert (a.flops, a.hbm_bytes, a.vector_ops, a.active_lanes) == \
            (b.flops, b.hbm_bytes, b.vector_ops, b.active_lanes)
    jf, tf = JF.fuse_circuit(j.gates, 3), TF.fuse_circuit(t.gates, 3)
    assert JM.op_reduction_ratio(j.gates, jf, 8, JT.CPU_TEST) == \
        TM.op_reduction_ratio(t.gates, tf, 8, TT.CPU_TEST)
    assert JM.roofline_time(1e9, 1e8, JT.CPU_TEST) == \
        TM.roofline_time(1e9, 1e8, TT.CPU_TEST)


# -- layouts and plain applications -----------------------------------------------------

def _psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex64)


@pytest.mark.parametrize("n,lanes", [(5, 8), (7, 32), (9, 128)])
def test_layout_roundtrip_matches(n, lanes):
    jt = dataclasses.replace(JT.CPU_TEST, lanes=lanes)
    tt = dataclasses.replace(TT.CPU_TEST, lanes=lanes)
    psi = _psi(n, n)
    js = JSV.from_dense(psi, n, jt)
    ts = TSV.from_dense(psi, n, tt, device="cpu")
    assert np.array_equal(np.asarray(js.data), ts.numpy())
    np.testing.assert_array_equal(ts.to_dense().numpy(), psi)
    np.testing.assert_allclose(ts.probabilities().numpy(),
                               np.asarray(js.probabilities()), atol=1e-7)
    assert float(ts.norm_sq()) == pytest.approx(float(js.norm_sq()), abs=1e-6)
    back = state_from_numpy(np.asarray(js.data), n, js.v, device="cpu")
    assert np.array_equal(back.numpy(), np.asarray(js.data))
    z = TSV.zero_state(n, tt, device="cpu")
    assert np.array_equal(z.numpy(), np.asarray(JSV.zero_state(n, jt).data))
    r = TSV.random_state(n, tt, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert float(r.norm_sq()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("qubits,controls", [((0,), ()), ((3,), (1,)),
                                             ((4, 1), ()), ((2, 5), (0, 6)),
                                             ((6, 0, 3), ())])
def test_plain_applications_match(qubits, controls):
    n = 7
    psi = _psi(n, 3)
    u = JG.random_unitary(1 << len(qubits), np.random.default_rng(1))
    ref = np.asarray(JA.apply_gate_dense(jnp.asarray(psi), n, qubits,
                                         jnp.asarray(u), controls))
    dense = TA.apply_gate_dense(torch.as_tensor(psi), n, qubits,
                                torch.as_tensor(u), controls).numpy()
    np.testing.assert_allclose(dense, ref, atol=3e-6)
    js = JSV.from_dense(psi, n, JT.CPU_TEST)
    jpl = np.asarray(JA.apply_gate_planar(
        js.data, n, qubits, jnp.asarray(u.real), jnp.asarray(u.imag),
        controls))
    tpl = TA.apply_gate_planar(
        torch.as_tensor(np.array(js.data)), n, qubits,
        torch.as_tensor(np.ascontiguousarray(u.real)),
        torch.as_tensor(np.ascontiguousarray(u.imag)), controls).numpy()
    np.testing.assert_allclose(tpl, jpl, atol=3e-6)
    # batched: two states, per-row matrices
    u2 = JG.random_unitary(1 << len(qubits), np.random.default_rng(2))
    both = TA.apply_gate_dense(
        torch.as_tensor(np.stack([psi, psi])), n, qubits,
        torch.as_tensor(np.stack([u, u2])), controls).numpy()
    np.testing.assert_allclose(both[0], ref, atol=3e-6)
    ref2 = np.asarray(JA.apply_gate_dense(jnp.asarray(psi), n, qubits,
                                          jnp.asarray(u2), controls))
    np.testing.assert_allclose(both[1], ref2, atol=3e-6)


def test_circuit_from_fields_carries_a_reference_circuit():
    j = JC.qft(6)
    t = circuit_from_fields(
        j.n, [(g.qubits, g.matrix, g.controls, g.name) for g in j.gates],
        name=j.name)
    _assert_gates_equal(j.gates, t.gates)
    assert TTP.template_of(t).structure_key() == \
        JTP.template_of(j).structure_key()


# -- device rules ------------------------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    psi = _psi(4, 0)
    for make in (lambda: Simulator(TT.CPU_TEST),
                 lambda: BatchExecutor(TT.CPU_TEST),
                 lambda: TSV.zero_state(4, TT.CPU_TEST),
                 lambda: TSV.from_dense(psi, 4, TT.CPU_TEST),
                 lambda: state_from_numpy(np.zeros((2, 2, 8), np.float32), 4,
                                          3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # explicitly on the CPU they run
    sim = Simulator(TT.CPU_TEST, device="cpu")
    assert sim.run(TC.ghz(4)).data.device.type == "cpu"
    assert BatchExecutor(TT.CPU_TEST, device="cpu").device.type == "cpu"
    assert TSV.zero_state(4, TT.CPU_TEST, device="cpu").numpy().shape == \
        (2, 2, 8)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 15
    # the result-mode modules are covered too (``engine/results.py`` is
    # numpy-only in the JAX package, but the port keeps its own copy)
    checked = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/core/measure.py",
            "src/repro_torch/engine/results.py",
            "src/repro_torch/engine/plan.py",
            "src/repro_torch/engine/batch.py",
            "src/repro_torch/core/simulator.py"} <= checked
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("module", [
    "repro_torch.engine", "repro_torch.core", "repro_torch.core.measure",
    "repro_torch.engine.results", "repro_torch.engine.batch",
    "repro_torch.kernels"])
def test_port_module_imports_first_in_a_fresh_interpreter(module):
    """Any of the port's packages can be the first one a caller imports
    (``repro_torch.engine`` first used to close an import cycle through
    ``core/simulator.py``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                   check=True, timeout=300)
