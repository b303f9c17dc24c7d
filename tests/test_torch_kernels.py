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


# -- launch plans, replayed index by index ---------------------------------------
# The CUDA kernels cannot run here, so the plans they follow are replayed in
# numpy with the kernels' own index arithmetic and held against the plain
# versions (and so, through the tests above, against the JAX package).

def _complex_rows(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, 1, 1 << n)).astype(np.float32)
    return x, (x[:, 0, 0] + 1j * x[:, 1, 0]).astype(np.complex128)


def _replay_fused(plan, x, u):
    """K1 as the kernel runs it: tile by tile, thread unit by unit."""
    s, h, k = plan.s, plan.h, plan.k
    out = x.copy()
    covered = np.zeros(x.shape, np.int64)
    for b in range(x.shape[0]):
        ub = u[b if u.shape[0] > 1 else 0]
        for t in range(plan.tiles_per_row):
            gidx = np.array([plan.global_index(t, a)
                             for a in range(1 << (s + h))])
            covered[b, gidx] += 1
            tile = x[b, gidx]
            if plan.tile_base(t) & plan.cmask_hi != plan.cmask_hi:
                continue
            for unit in range(plan.units):
                r0 = (unit % plan.rb) * plan.tr
                for j in range(plan.tg):
                    gi = (unit // plan.rb) * plan.tg + j
                    if gi >= plan.groups:
                        continue
                    base = plan.group_base(gi)
                    if base & plan.cmask_lo != plan.cmask_lo:
                        continue
                    col = tile[[plan.row_off(c) | base for c in range(1 << k)]]
                    for r in range(r0, r0 + plan.tr):
                        out[b, gidx[plan.row_off(r) | base]] = ub[r] @ col
    assert (covered == 1).all()
    return out


@pytest.mark.parametrize("n,qubits,controls", [
    (8, (0, 1, 2, 3), ()), (9, (0, 6), (8,)), (9, (1, 2, 4, 7), ()),
    (10, (2, 3, 8, 9), (0, 5)), (6, (5,), (0, 1, 2, 3, 4)), (4, (0, 1, 2, 3),
                                                              ()),
    (5, (0, 2, 4), (1,)), (1, (0,), ()), (13, (12,), (0, 11)),
    (13, (0, 6, 11, 12), ()), (10, (0, 1, 2, 3, 4, 5, 6), (9,)),
    (9, tuple(range(3, 9)), ()),
])
def test_fused_plan_replays_the_plain_gate(n, qubits, controls):
    plan = TK.fused_plan(n, qubits, controls)
    assert plan.s + plan.h <= TK.FUSED_TILE_LOG and len(plan.gbits) == \
        plan.s - plan.low
    assert sorted(plan.gbits + tuple(q for q in qubits if q < plan.s)) == \
        list(range(plan.s))
    x, psi = _complex_rows(2, n, n)
    rng = np.random.default_rng(len(qubits))
    u = np.stack([JG.random_unitary(1 << len(qubits), rng) for _ in range(2)])
    got = _replay_fused(plan, psi, u)
    want = TK.apply_fused_gate(_t(x), n, n, qubits,
                               _t(u.real.astype(np.float32)),
                               _t(u.imag.astype(np.float32)), controls)
    want = want.numpy()[:, :, 0].astype(np.float64)
    np.testing.assert_allclose(got.real, want[:, 0], atol=3e-6)
    np.testing.assert_allclose(got.imag, want[:, 1], atol=3e-6)


@pytest.mark.parametrize("qubits", [(0, 1, 2, 3), (0, 6, 21, 23),
                                    (1, 2, 9, 26), (26, 27, 28, 29),
                                    (2, 3, 4, 5), (5, 9, 17, 28)])
def test_fused_plan_reads_a_column_without_bank_conflicts(qubits):
    """At k = 4 each column's reads by one warp hit distinct banks after the
    swizzle, which is linear over XOR and keeps 16-byte chunks whole."""
    plan = TK.fused_plan(30, qubits)
    assert sorted(TK.swizzle(a) for a in range(4096)) == list(range(4096))
    assert all(TK.swizzle(a) & ~3 == TK.swizzle(a & ~3)
               for a in range(0, 4096, 7))
    for c in range(16):
        addrs = set()
        for lane in range(32):
            base = plan.group_base((lane // plan.rb) * plan.tg)
            a = plan.row_off(c) | base
            assert TK.swizzle(a) == TK.swizzle(plan.row_off(c)) ^ \
                TK.swizzle(base)
            addrs.add(TK.swizzle(a))
        assert len({a % 32 for a in addrs}) == len(addrs) == 8


def _replay_phase(plan, x, phase, perm):
    """K2 as the kernel runs it, in the plan's mode."""
    b_rows, N = x.shape
    w, s, wl = plan.w, plan.s, plan.w_low
    lo_mask = TK.pdep((1 << wl) - 1, plan.low_runs)
    cmask = TK.pdep((1 << w) - 1, plan.all_runs)
    out = np.zeros_like(x)
    written = np.zeros(x.shape, np.int64)
    for b in range(b_rows):
        ph = phase[b if phase.shape[0] > 1 else 0]
        for it in range(plan.items_per_row):
            if plan.mode == TK.PHASE_STREAM:
                fh_bits = plan.nfree_hi - plan.m
                hc, fh_hi = it >> fh_bits, it & ((1 << fh_bits) - 1)
                slice_ = ph[hc << wl:(hc + 1) << wl]
                for i in range(1 << plan.m):
                    base = TK.pdep(hc, plan.hi_runs) | TK.pdep(
                        (fh_hi << plan.m) | i, plan.free_runs)
                    for o in range(1 << s):
                        out[b, base + o] = slice_[TK.pext(o, plan.low_runs)] \
                            * x[b, base + o]
                        written[b, base + o] += 1
            elif plan.mode == TK.PHASE_TILE:
                tb = TK.pdep(it, plan.free_runs)
                spans = [tb + TK.pdep(j, plan.hi_runs)
                         for j in range(1 << plan.h)]
                tile = np.concatenate([x[b, sp:sp + (1 << s)]
                                       for sp in spans])
                for a in range(1 << (s + plan.h)):
                    j, o = a >> s, a & ((1 << s) - 1)
                    r = (j << wl) | TK.pext(o, plan.low_runs)
                    p = int(perm[r])
                    src = ((p >> wl) << s) | (o & ~lo_mask) | TK.pdep(
                        p & ((1 << wl) - 1), plan.low_runs)
                    out[b, spans[j] + o] = ph[r] * tile[src]
                    written[b, spans[j] + o] += 1
            else:
                for xi in range(4 * it, min(4 * it + 4, N)):
                    r = TK.pext(xi, plan.all_runs)
                    src = (xi & ~cmask) | TK.pdep(int(perm[r]),
                                                  plan.all_runs)
                    out[b, xi] = ph[r] * x[b, src]
                    written[b, xi] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("n,qubits,perm,mode", [
    (9, (0, 1, 2), False, TK.PHASE_STREAM),
    (9, (0, 1, 2, 3, 4, 5, 8), False, TK.PHASE_STREAM),
    (9, (3, 4, 7), False, TK.PHASE_STREAM),
    (14, tuple(range(12)) + (13,), False, TK.PHASE_STREAM),
    (14, tuple(range(1, 13)), False, TK.PHASE_STREAM),
    (14, tuple(range(5, 14)), False, TK.PHASE_DIRECT),
    (14, tuple(range(14)), False, TK.PHASE_DIRECT),
    (8, (0, 1, 2, 3), True, TK.PHASE_TILE),
    (9, (0, 3, 7, 8), True, TK.PHASE_TILE),
    (14, tuple(range(12)) + (13,), True, TK.PHASE_TILE),
    (15, tuple(range(14)), True, TK.PHASE_DIRECT),
    (9, (4, 6), True, TK.PHASE_TILE),
    (15, (13, 14), True, TK.PHASE_DIRECT),
    (1, (0,), False, TK.PHASE_DIRECT),
])
def test_phase_plan_replays_the_plain_gate(n, qubits, perm, mode):
    plan = TK.phase_plan(n, qubits, perm)
    assert plan.mode == mode
    x, psi = _complex_rows(2, n, n + len(qubits))
    rng = np.random.default_rng(n)
    ang = rng.uniform(0, 2 * np.pi, (2, 1 << len(qubits)))
    p = rng.permutation(1 << len(qubits)).astype(np.int32) if perm else \
        np.arange(1 << len(qubits), dtype=np.int32)
    got = _replay_phase(plan, psi, np.exp(1j * ang), p)
    want = TK.apply_phase_gate(
        _t(x), n, n, qubits, _t(np.cos(ang).astype(np.float32)),
        _t(np.sin(ang).astype(np.float32)),
        perm=p if perm else None).numpy()[:, :, 0].astype(np.float64)
    np.testing.assert_allclose(got.real, want[:, 0], atol=3e-6)
    np.testing.assert_allclose(got.imag, want[:, 1], atol=3e-6)


@pytest.mark.parametrize("n,qubits,perm,slice_entries,items", [
    (30, tuple(range(24)) + (29,), False, 4096, 1 << 13),   # qft30 low
    (26, tuple(range(21)), False, 4096, 1 << 9),            # qaoa26
    (30, tuple(range(5, 30)), False, None, 1 << 28),        # top bits
    (30, tuple(range(12)) + (25,), True, None, 1 << 17),
])
def test_phase_plan_reads_each_phase_entry_once(n, qubits, perm,
                                                slice_entries, items):
    plan = TK.phase_plan(n, qubits, perm)
    assert plan.items_per_row == items
    if perm:
        assert plan.mode == TK.PHASE_TILE and plan.s + plan.h == 13
        return
    if slice_entries is None:
        # a cluster up to the top bit: chunks meet the entries in order
        assert plan.mode == TK.PHASE_DIRECT and plan.all_runs == (
            (qubits[0], n - qubits[0], 0),)
        return
    # items x slice = the phase vector: every entry staged exactly once
    assert plan.mode == TK.PHASE_STREAM
    assert 1 << plan.w_low == slice_entries
    hc_items = plan.items_per_row >> (plan.nfree_hi - plan.m)
    assert hc_items * (1 << plan.w_low) == 1 << len(qubits)
    assert plan.nfree_hi == plan.m   # one item per slice


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
