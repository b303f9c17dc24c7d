"""The port's three kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs the
Pallas kernels in interpret mode and their oracles.  Inputs are made from
numpy seeds and cross the packages as numpy arrays.  Tolerances are the
reference suite's: 3e-6 for single kernels, 5e-6 for properties, 1e-5 for
expectations (tests/test_kernels.py).  The CUDA kernels themselves are held
against the plain versions on a card by tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import gates as JG  # noqa: E402
from repro.core import statevec as JSV  # noqa: E402
from repro.core.target import CPU_TEST as J_CPU  # noqa: E402
from repro.kernels.apply_gate import ops as JK  # noqa: E402
from repro.kernels.apply_gate import ref as JR  # noqa: E402
from repro.kernels.expectation import ops as JE  # noqa: E402
from repro_torch.kernels.apply_gate import ops as TK  # noqa: E402
from repro_torch.kernels.expectation import ops as TE  # noqa: E402

V8 = J_CPU.lane_qubits


def _psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex64)


def _planar(n, seed, lanes=8):
    """The same random state as a JAX planar array and a numpy array."""
    tgt = dataclasses.replace(J_CPU, lanes=lanes)
    st_ = JSV.from_dense(_psi(n, seed), n, tgt)
    return st_, np.asarray(st_.data)


def _t(a):
    return torch.as_tensor(np.array(a))


# -- K1: fused dense gate --------------------------------------------------------

def _run_fused(n, qubits, controls=(), seed=0, lanes=8):
    st_, data = _planar(n, seed, lanes)
    u = JG.random_unitary(1 << len(qubits), np.random.default_rng(seed + 1))
    ur, ui = u.real.astype(np.float32), u.imag.astype(np.float32)
    port = TK.apply_fused_gate(_t(data), n, st_.v, tuple(qubits), _t(ur),
                               _t(ui), controls=tuple(controls)).numpy()
    jker = np.asarray(JK.apply_fused_gate(
        st_.data, n, st_.v, tuple(qubits), jnp.asarray(ur), jnp.asarray(ui),
        controls=tuple(controls)))
    jref = np.asarray(JR.apply_fused_gate_ref(
        st_.data, n, st_.v, tuple(qubits), jnp.asarray(ur), jnp.asarray(ui),
        controls=tuple(controls)))
    return port, jker, jref


@pytest.mark.parametrize("n", [5, 8, 9])
@pytest.mark.parametrize("qubits", [(0,), (2,), (4,)])
def test_fused_single_qubit_positions(n, qubits):
    port, jker, jref = _run_fused(n, qubits)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


@pytest.mark.parametrize("qubits", [
    (0, 1), (0, 7), (3, 6), (6, 7),
    (1, 4, 6), (0, 2, 5, 7), (2, 3, 4, 5, 6),
])
def test_fused_multi_qubit_sets(qubits):
    port, jker, jref = _run_fused(8, qubits, seed=7)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


@pytest.mark.parametrize("lanes", [8, 16, 32, 64, 128])
def test_fused_lane_width_sweep(lanes):
    port, jker, jref = _run_fused(9, (1, 5), seed=3, lanes=lanes)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


@pytest.mark.parametrize("controls", [(5,), (5, 6), (0,), (0, 7)])
def test_fused_controlled(controls):
    qubits = (2,) if 2 not in controls else (3,)
    port, jker, jref = _run_fused(8, qubits, controls=controls, seed=11)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


def test_fused_unsorted_qubits():
    """qubits=(5, 1) goes through the port's _sort_perm like the JAX one."""
    port, jker, jref = _run_fused(7, (5, 1), seed=13)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)
    qs, perm = TK._sort_perm((5, 1, 3))
    jqs, jperm = JK._sort_perm((5, 1, 3))
    assert qs == jqs and np.array_equal(perm, jperm)


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_fused_property(data):
    n = data.draw(st.integers(4, 9))
    k = data.draw(st.integers(1, min(3, n)))
    perm = data.draw(st.permutations(range(n)))
    qubits = tuple(perm[:k])
    nc = data.draw(st.integers(0, min(2, n - k)))
    controls = tuple(perm[k:k + nc])
    seed = data.draw(st.integers(0, 9999))
    port, jker, jref = _run_fused(n, qubits, controls, seed)
    np.testing.assert_allclose(port, jker, atol=5e-6)
    np.testing.assert_allclose(port, jref, atol=5e-6)


def test_fused_batch_axis_per_row_unitaries():
    """[B, 2, R, V] with U[B] equals B single-row calls; U[1] broadcasts."""
    n, qubits, controls = 7, (1, 4), (6,)
    rows = [_planar(n, s)[1] for s in range(3)]
    us = [JG.random_unitary(4, np.random.default_rng(s)) for s in range(3)]
    ur = np.stack([u.real for u in us]).astype(np.float32)
    ui = np.stack([u.imag for u in us]).astype(np.float32)
    out = TK.apply_fused_gate(_t(np.stack(rows)), n, V8, qubits, _t(ur),
                              _t(ui), controls=controls).numpy()
    bcast = TK.apply_fused_gate(_t(np.stack(rows)), n, V8, qubits,
                                _t(ur[:1]), _t(ui[:1]), controls).numpy()
    for b in range(3):
        one = TK.apply_fused_gate(_t(rows[b]), n, V8, qubits, _t(ur[b]),
                                  _t(ui[b]), controls=controls).numpy()
        np.testing.assert_allclose(out[b], one, atol=3e-6)
        ref = np.asarray(JR.apply_fused_gate_ref(
            jnp.asarray(rows[b]), n, V8, qubits, jnp.asarray(ur[b]),
            jnp.asarray(ui[b]), controls=controls))
        np.testing.assert_allclose(out[b], ref, atol=3e-6)
        one0 = TK.apply_fused_gate(_t(rows[b]), n, V8, qubits, _t(ur[0]),
                                   _t(ui[0]), controls=controls).numpy()
        np.testing.assert_allclose(bcast[b], one0, atol=3e-6)


# -- K2: diagonal / permutation gate ----------------------------------------------

def _phase_inputs(w, seed, mode):
    rng = np.random.default_rng(seed)
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << w)).astype(np.complex64)
    p_re = ph.real.astype(np.float32) if mode != "perm" else None
    p_im = ph.imag.astype(np.float32) if mode != "perm" else None
    perm = rng.permutation(1 << w).astype(np.int32) if mode != "phase" \
        else None
    return p_re, p_im, perm


def _run_phase(n, qubits, mode, seed=0, lanes=8):
    st_, data = _planar(n, seed, lanes)
    p_re, p_im, perm = _phase_inputs(len(qubits), seed + 1, mode)
    port = TK.apply_phase_gate(
        _t(data), n, st_.v, qubits, None if p_re is None else _t(p_re),
        None if p_im is None else _t(p_im), perm=perm).numpy()
    jp = (lambda a: None if a is None else jnp.asarray(a))
    jker = np.asarray(JK.apply_phase_gate(st_.data, n, st_.v, qubits,
                                          jp(p_re), jp(p_im), perm=perm))
    jref = np.asarray(JR.apply_phase_gate_ref(st_.data, n, st_.v, qubits,
                                              p_re, p_im, perm=perm))
    return port, jker, jref


@pytest.mark.parametrize("mode", ["phase", "perm", "both"])
@pytest.mark.parametrize("qubits", [(0,), (3,), (1, 2), (0, 5), (2, 4, 7),
                                    (0, 1, 2, 3)])
def test_phase_gate_modes(mode, qubits):
    port, jker, jref = _run_phase(8, qubits, mode, seed=len(qubits))
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


@pytest.mark.parametrize("lanes", [8, 32, 128])
def test_phase_gate_lane_width_sweep(lanes):
    port, jker, jref = _run_phase(9, (1, 6, 8), "both", seed=5, lanes=lanes)
    np.testing.assert_allclose(port, jker, atol=3e-6)
    np.testing.assert_allclose(port, jref, atol=3e-6)


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_phase_gate_property(data):
    n = data.draw(st.integers(3, 9))
    w = data.draw(st.integers(1, min(5, n)))
    qubits = tuple(sorted(data.draw(st.permutations(range(n)))[:w]))
    mode = data.draw(st.sampled_from(["phase", "perm", "both"]))
    seed = data.draw(st.integers(0, 9999))
    port, jker, jref = _run_phase(n, qubits, mode, seed)
    np.testing.assert_allclose(port, jker, atol=5e-6)
    np.testing.assert_allclose(port, jref, atol=5e-6)


def test_phase_gate_batch_axis_per_row_phases():
    n, qubits = 7, (2, 3, 6)
    rows = np.stack([_planar(n, s)[1] for s in range(3)])
    ins = [_phase_inputs(3, s, "both") for s in range(3)]
    p_re = np.stack([i[0] for i in ins])
    p_im = np.stack([i[1] for i in ins])
    perm = ins[0][2]
    out = TK.apply_phase_gate(_t(rows), n, V8, qubits, _t(p_re), _t(p_im),
                              perm=perm).numpy()
    for b in range(3):
        ref = np.asarray(JR.apply_phase_gate_ref(
            jnp.asarray(rows[b]), n, V8, qubits, p_re[b], p_im[b], perm=perm))
        np.testing.assert_allclose(out[b], ref, atol=3e-6)


def test_phase_gate_needs_sorted_qubits():
    data = _t(_planar(5, 0)[1])
    with pytest.raises(ValueError, match="sorted"):
        TK.apply_phase_gate(data, 5, V8, (3, 1), None, None,
                            perm=np.arange(4, dtype=np.int32))


# -- K3: <Z_q> ----------------------------------------------------------------------

@pytest.mark.parametrize("n,q", [(6, 0), (6, 3), (6, 5), (9, 4), (9, 8)])
def test_expectation_z(n, q):
    st_, data = _planar(n, q)
    port = float(TE.expectation_z(_t(data), n, st_.v, q))
    assert abs(port - float(JE.expectation_z(st_.data, n, st_.v, q))) < 1e-5
    assert abs(port - float(JE.expectation_z_ref(st_.data, n, st_.v, q))) \
        < 1e-5


def test_expectation_basis_states_and_batch():
    n = 7
    zero = np.zeros((2, 1 << (n - V8), 1 << V8), np.float32)
    zero[0, 0, 0] = 1.0
    for q in range(n):
        assert abs(float(TE.expectation_z(_t(zero), n, V8, q)) - 1.0) < 1e-6
    rows = np.stack([_planar(n, s)[1] for s in range(4)])
    out = TE.expectation_z(_t(rows), n, V8, 3).numpy()
    assert out.shape == (4,)
    for b in range(4):
        ref = float(JE.expectation_z_ref(jnp.asarray(rows[b]), n, V8, 3))
        assert abs(out[b] - ref) < 1e-5


# -- wrapper rules -------------------------------------------------------------------

def test_wrappers_raise_for_devices_without_a_kernel():
    data = torch.zeros((2, 4, 8), device="meta")
    u = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TK.apply_fused_gate(data, 5, V8, (3,), u, u)
    with pytest.raises(ValueError, match="no kernel"):
        TK.apply_phase_gate(data, 5, V8, (3,), None, None,
                            perm=np.array([1, 0], np.int32))
    with pytest.raises(ValueError, match="no kernel"):
        TE.expectation_z(data, 5, V8, 0)


def test_kernel_modules_build_nothing_on_import():
    from repro_torch.kernels import _build as KB
    assert KB._libs == {}
    assert all(k._fn is None for k in (TK.FUSED, TK.PHASE, TE.EXPECT))


def test_kernel_libraries_are_named_by_source_and_flags(monkeypatch):
    from repro_torch.kernels import _build as KB
    paths = {name: KB.library_path(name) for name in KB.SOURCES}
    assert len(set(paths.values())) == len(KB.SOURCES)
    for name, path in paths.items():
        assert path.parent == KB.BUILD_DIR
        assert path.parts[-3:-1] == ("build", "repro_torch_kernels")
        assert (KB.CSRC / f"{name}.cu").is_file()
        assert path == KB.library_path(name)          # stable
    assert "arch=compute_90a,code=sm_90a" in KB.NVCC_FLAGS
    monkeypatch.setattr(KB, "NVCC_FLAGS", KB.NVCC_FLAGS + ("-lineinfo",))
    assert KB.library_path("apply_gate") != paths["apply_gate"]
