"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode, and on the CPU the wrappers run the plain versions
(held against the JAX package by tests/test_torch_kernels.py).  The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import circuits as C  # noqa: E402
from repro_torch.core.gates import random_unitary  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.target import H100  # noqa: E402
from repro_torch.engine import (BatchExecutor, PlanCache,  # noqa: E402
                                hea_template, qaoa_template)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.apply_gate import ops as K  # noqa: E402
from repro_torch.kernels.apply_gate import ref as R  # noqa: E402
from repro_torch.kernels.expectation import ops as E  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _states(dev, b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, 1 << (n - 5), 32)).astype(np.float32)
    x /= np.sqrt((x.reshape(b, -1) ** 2).sum(1)).reshape(b, 1, 1, 1)
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("where", ["low", "high", "unsorted"])
def test_fused_kernel_matches_plain(dev, k, where):
    n, b = 14, 3
    rng = np.random.default_rng(k)
    qs = {"low": tuple(range(k)), "high": tuple(range(n - k, n)),
          "unsorted": tuple(int(q) for q in rng.permutation(n)[:k])}[where]
    free = [q for q in range(n) if q not in qs]
    data = _states(dev, b, n, k)
    u = np.stack([random_unitary(1 << k, rng) for _ in range(b)])
    ur = torch.as_tensor(u.real.astype(np.float32), device=dev)
    ui = torch.as_tensor(u.imag.astype(np.float32), device=dev)
    for ctrl in ((), (free[0],), (free[-1], free[1])):
        out = K.apply_fused_gate(data, n, 5, qs, ur, ui, controls=ctrl)
        ref = R.apply_fused_gate_ref(data, n, 5, qs, ur, ui, ctrl)
        assert float((out - ref).abs().max()) < 3e-6
        one = K.apply_fused_gate(data[1], n, 5, qs, ur[1], ui[1], ctrl)
        assert float((one - ref[1]).abs().max()) < 3e-6


@pytest.mark.parametrize("mode", ["phase", "perm", "both"])
@pytest.mark.parametrize("qubits", [(0,), (3, 4, 5), (0, 6, 9, 13),
                                    tuple(range(2, 14))])
def test_phase_kernel_matches_plain(dev, mode, qubits):
    n, w = 14, len(qubits)
    rng = np.random.default_rng(w)
    data = _states(dev, 2, n, w)
    ang = torch.as_tensor(rng.uniform(0, 6.3, (2, 1 << w)),
                          dtype=torch.float32, device=dev)
    p_re, p_im = (torch.cos(ang), torch.sin(ang)) if mode != "perm" \
        else (None, None)
    perm = rng.permutation(1 << w).astype(np.int32) if mode != "phase" \
        else None
    out = K.apply_phase_gate(data, n, 5, qubits, p_re, p_im, perm=perm)
    ref = R.apply_phase_gate_ref(data, n, 5, qubits, p_re, p_im, perm=perm)
    assert float((out - ref).abs().max()) < 3e-6


def _states_v(dev, b, n, seed):
    """Like _states, with the lane axis cut to the state when n < 5."""
    v = min(n, 5)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, 1 << (n - v), 1 << v)).astype(np.float32)
    x /= np.sqrt((x.reshape(b, -1) ** 2).sum(1)).reshape(b, 1, 1, 1)
    return torch.as_tensor(x, device=dev), v


# K1's tile plan (ops.fused_plan): the cut s puts gate bits below it in
# shared memory and those at or above it on the span table, controls below
# it on groups and at or above it on whole tiles.
@pytest.mark.parametrize("n,qubits,controls", [
    (14, (0, 6, 9, 13), ()),             # lowest gate bit 0
    (14, (1, 2, 9, 12), ()),             # lowest gate bit 1, split at s
    (14, (2, 3, 4, 5), ()),              # lowest gate bit 2, all below s
    (14, (5, 8, 11, 13), ()),            # lowest gate bit >= 5
    (14, (0, 6, 12, 13), ()),            # two below s, two above
    (14, (10, 11, 12, 13), ()),          # all at or above s
    (4, (0, 1, 2, 3), ()),               # n = k: smaller than one tile
    (5, (0, 2, 4), (1,)),                # n = 5, control below s
    (1, (0,), ()),                       # one qubit: 4-byte copies
    (14, (0,), (1, 13)),                 # controls below and above s
    (14, (13,), tuple(range(13))),       # grover: k = 1, 13 controls
    (14, (3, 7), (0, 12)),
    (14, tuple(range(5)), (13,)),        # k = 5
    (14, (0, 1, 2, 3, 4, 5), (9,)),      # k = 6
    (14, (1, 3, 5, 7, 9, 11, 13), ()),   # k = 7, spread
    (14, tuple(range(7, 14)), (0,)),     # k = 7, top bits
])
@pytest.mark.parametrize("rows", [1, 3])
def test_fused_kernel_tile_plan_branches(dev, n, qubits, controls, rows):
    data, v = _states_v(dev, 3, n, n + len(qubits))
    rng = np.random.default_rng(len(qubits) + rows)
    u = np.stack([random_unitary(1 << len(qubits), rng)
                  for _ in range(rows)])
    ur = torch.as_tensor(u.real.astype(np.float32), device=dev)
    ui = torch.as_tensor(u.imag.astype(np.float32), device=dev)
    out = K.apply_fused_gate(data, n, v, qubits, ur, ui, controls)
    ref = R.apply_fused_gate_ref(data, n, v, qubits, ur, ui, controls)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 3e-6


# K2's plan (ops.phase_plan): pure phases stream past a staged slice;
# permutations gather from a staged tile, or from global memory when the
# cluster has no bits below the cut or is too wide for a tile.
@pytest.mark.parametrize("n,qubits", [
    (14, (0, 1, 2)),                     # entirely below s
    (14, tuple(range(12)) + (13,)),      # split across s (qft's shape)
    (16, tuple(range(14))),              # too wide for a gather tile
    (16, (13, 14, 15)),                  # entirely above s
    (14, (0, 7, 10, 13)),                # scattered low and high bits
    (14, (3, 4, 7, 8, 11, 12)),          # qrc-like runs
    (14, tuple(range(1, 14))),           # lowest bit 1
    (3, (0, 2)),
])
@pytest.mark.parametrize("mode", ["phase", "perm", "both"])
@pytest.mark.parametrize("rows", [1, 3])
def test_phase_kernel_plan_branches(dev, n, qubits, mode, rows):
    w = len(qubits)
    data, v = _states_v(dev, 3, n, n + w)
    rng = np.random.default_rng(w + rows)
    ang = torch.as_tensor(rng.uniform(0, 6.3, (rows, 1 << w)),
                          dtype=torch.float32, device=dev)
    p_re, p_im = (torch.cos(ang), torch.sin(ang)) if mode != "perm" \
        else (None, None)
    perm = rng.permutation(1 << w).astype(np.int32) if mode != "phase" \
        else None
    out = K.apply_phase_gate(data, n, v, qubits, p_re, p_im, perm=perm)
    ref = R.apply_phase_gate_ref(data, n, v, qubits, p_re, p_im, perm=perm)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 3e-6


@pytest.mark.parametrize("q", [0, 4, 5, 13])
def test_expectation_kernel_matches_plain_and_repeats(dev, q):
    n = 14
    data = _states(dev, 2, n, q)
    out = E.expectation_z(data, n, 5, q)
    assert torch.equal(out, E.expectation_z(data, n, 5, q))
    assert float((out - E.expectation_z_ref(data, n, 5, q)).abs().max()) \
        < 1e-5


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    data = _states(dev, 1, 10, 0)
    u = torch.eye(256, device=dev)
    with pytest.raises(ValueError, match="1..7"):
        K.apply_fused_gate(data, 10, 5, tuple(range(8)), u, u)
    with pytest.raises(ValueError, match="contiguous"):
        K.apply_fused_gate(data.transpose(2, 3), 10, 5, (1,),
                           torch.eye(2, device=dev), torch.eye(2, device=dev))


@pytest.mark.parametrize("name,n", [("ghz", 12), ("qft", 12), ("qv", 10),
                                    ("grover", 10), ("qrc", 11)])
def test_cuda_backend_matches_dense_backend(dev, name, n):
    kw = {"depth": 8} if name == "qrc" else {}
    circ = C.build(name, n, **kw)
    before = launch_counts()
    out = Simulator(H100, backend="cuda", plan_cache=PlanCache()).run(circ)
    ref = Simulator(H100, backend="dense").run(circ)
    torch.cuda.synchronize()
    assert launch_counts()["apply_fused_gate"] > \
        before["apply_fused_gate"] or name == "ghz"
    assert float((out.data - ref.data).abs().max()) < 5e-6


def test_batch_executor_on_card(dev):
    t = qaoa_template(10, 2)
    pm = np.random.default_rng(0).uniform(-3, 3, (4, 4)).astype(np.float32)
    got = BatchExecutor(H100, backend="cuda").run_batch(t, pm)
    want = BatchExecutor(H100, backend="dense").run_batch(t, pm)
    for a, b in zip(got, want):
        assert float((a.data - b.data).abs().max()) < 5e-6


# -- result modes ------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [0.2, 1.0])
@pytest.mark.parametrize("q", [0, 5, 13])
def test_fused_kernel_takes_non_unitary_kraus_operators(dev, gamma, q):
    """Amplitude damping's Kraus operators, K1 = [[0, sqrt(g)], [0, 0]] and
    K0 = diag(1, sqrt(1 - g)), through the fused-gate kernel: shared by the
    batch, and as a per-row [B, 2, 2] matrix (each row its own branch,
    scaled as a trajectory's renormalized survivor is)."""
    n, b = 14, 3
    data = _states(dev, b, n, q)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]])
    k0 = np.diag([1.0, np.sqrt(1.0 - gamma)])
    for m in (k1, k0):
        ur = torch.as_tensor(m.astype(np.float32), device=dev)
        ui = torch.zeros_like(ur)
        out = K.apply_fused_gate(data, n, 5, (q,), ur, ui)
        ref = R.apply_fused_gate_ref(data, n, 5, (q,), ur, ui)
        assert float((out - ref).abs().max()) < 3e-6
    rows = np.stack([k1 * 1.5, k0 * 0.75, (k0 + 1j * k1) * 1.1])
    ur = torch.as_tensor(rows.real.astype(np.float32), device=dev)
    ui = torch.as_tensor(rows.imag.astype(np.float32), device=dev)
    out = K.apply_fused_gate(data, n, 5, (q,), ur, ui)
    ref = R.apply_fused_gate_ref(data, n, 5, (q,), ur, ui)
    assert float((out - ref).abs().max()) < 3e-6


@pytest.mark.parametrize("n", [16, 20])
def test_sampler_matches_float64_inverse_cdf_on_the_card(dev, n):
    """The card's float64 CDF against numpy's sequential one, on the same
    uniforms: every draw agrees (a tie within 1e-16 of a CDF entry could
    split them; none is expected in 2**16 draws)."""
    from repro_torch.core import measure as ME
    st = _states(dev, 1, n, n)[0]
    probs = (st.reshape(2, -1) ** 2).sum(0)
    u = ME.uniforms(1 << 16, 5, dev)
    got = ME.inverse_cdf(ME.cdf64(probs), u)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    p = probs.cpu().numpy().astype(np.float64)
    cdf = np.cumsum(p)
    want = np.minimum(np.searchsorted(cdf / cdf[-1], u.cpu().numpy()),
                      p.size - 1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(ME.cdf64(probs), ME.cdf64(probs))


def test_pauli_strings_through_the_fused_kernel(dev):
    from repro_torch.core import measure as ME
    from repro_torch.core.statevec import State
    n = 14
    st = State(_states(dev, 1, n, 3)[0], n, 5)
    for obs in ({0: "X"}, {13: "Y"}, {0: "Z", 7: "Z"},
                {1: "X", 6: "Y", 12: "Z"}):
        before = launch_counts()["apply_fused_gate"]
        got = ME.expectation_pauli(st, obs)
        assert launch_counts()["apply_fused_gate"] == before + len(obs)
        want = ME.expectation_pauli(st, obs, plain=True)
        assert abs(float(got) - float(want)) < 1e-5


def _compositions(b):
    """Row slices of a batch of ``b``: whole, as 3 + (b - 3), one by one."""
    return [[slice(0, b)], [slice(0, 3), slice(3, b)],
            [slice(r, r + 1) for r in range(b)]]


@pytest.mark.parametrize("which", ["qaoa", "hea"])
def test_batched_binding_gives_each_row_the_same_bits(dev, which):
    """A row's bound constants (unitary planes of parameterized dense items,
    phase planes of parameterized diagonals) and its gate-prefix state are
    bitwise the same at B = 8, as 3 + 5 and one by one: the result program
    runs its gate prefix through the same batched steps as run_batch_raw."""
    t = {"qaoa": qaoa_template, "hea": hea_template}[which](10, 2)
    pm = torch.as_tensor(np.random.default_rng(3).uniform(
        -3, 3, (8, t.num_params)).astype(np.float32), device=dev)
    plan = BatchExecutor(H100, backend="cuda", cache=PlanCache()).plan_for(t)
    bound = [it for it in plan.items if not it.is_constant]
    assert bound, "no parameterized item"
    for it in bound:
        bind = it.unitary_planes if it.kind == "dense" else it.phase_planes
        full = bind(pm)
        for parts in _compositions(8):
            got = [bind(pm[s]) for s in parts]
            for plane in range(2):
                assert torch.equal(torch.cat([g[plane] for g in got]),
                                   full[plane]), (it.kind, it.qubits, parts)
    full = plan.run_batch_raw(pm)
    for parts in _compositions(8):
        assert torch.equal(torch.cat([plan.run_batch_raw(pm[s])
                                      for s in parts]), full)


@pytest.mark.parametrize("which", ["qaoa", "hea"])
def test_shots_bitwise_across_batch_compositions_on_card(dev, which):
    from repro_torch.engine import ResultSpec
    t = {"qaoa": qaoa_template, "hea": hea_template}[which](10, 2)
    pm = np.random.default_rng(1).uniform(
        -3, 3, (8, t.num_params)).astype(np.float32)
    keys = np.array([[50 + b, 0] for b in range(8)], np.uint32)
    spec = ResultSpec.sample(1024, key=0)
    ex = BatchExecutor(H100, backend="cuda", cache=PlanCache())
    plan, full = ex.dispatch_batch(t, pm, result=spec, rowkeys=keys)
    assert full.device.type == "cuda" and full.dtype == torch.int32
    for parts in _compositions(8):
        got = [ex.dispatch_batch(t, pm[s], result=spec, rowkeys=keys[s])[1]
               for s in parts]
        assert torch.equal(torch.cat(got), full)
    for b in range(8):
        assert torch.equal(plan.run_result(pm[b], rowkey=keys[b]), full[b])
    _, again = ex.dispatch_batch(t, pm, result=spec, rowkeys=keys)
    assert torch.equal(again, full)
    _, other = ex.dispatch_batch(t, pm, result=spec, rowkeys=keys + 1)
    assert not torch.equal(other, full)


def test_result_modes_launch_kernels_on_card(dev):
    """Expectations and noisy trajectories on the card: K3 for single Z,
    K1 for the other strings and every Kraus branch, against the dense
    backend's payloads."""
    from repro_torch.engine import ResultSpec, amplitude_damping, bit_flip
    t = qaoa_template(10, 2)
    pm = np.random.default_rng(2).uniform(-3, 3, (4, 4)).astype(np.float32)
    obs = [{0: "Z"}, {0: "Z", 1: "Z"}, {3: "X"}, {5: "Y", 2: "Z"}]
    ex = BatchExecutor(H100, backend="cuda", cache=PlanCache())
    dense = BatchExecutor(H100, backend="dense", cache=PlanCache())
    before = launch_counts()
    plan, got = ex.dispatch_batch(t, pm, result=ResultSpec.expectation(obs))
    _, want = dense.dispatch_batch(t, pm, result=ResultSpec.expectation(obs))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["expectation_z"] == before["expectation_z"] + 1
    gates = sum(1 for it in plan.items if it.kind == "dense")
    assert after["apply_fused_gate"] - before["apply_fused_gate"] == \
        gates + 1 + 2 + 2
    assert float((got - want).abs().max()) < 1e-5
    # a certain flip negates <Z_0> and keeps <X_3>; a certain decay
    # resets qubit 3 to |0>
    flip = ResultSpec.noisy([bit_flip(0, 1.0)], [{0: "Z"}, {3: "X"}],
                            unravelings=4)
    _, noisy = ex.dispatch_batch(t, pm, result=flip)
    assert float((noisy[:, 0] + want[:, 0]).abs().max()) < 1e-5
    assert float((noisy[:, 1] - want[:, 2]).abs().max()) < 1e-5
    decay = ResultSpec.noisy([amplitude_damping(3, 1.0)], [{3: "Z"}],
                             unravelings=4)
    _, noisy = ex.dispatch_batch(t, pm, result=decay)
    assert float((noisy[:, 0] - 1.0).abs().max()) < 1e-5


def test_noisy_rows_match_the_planar_path_on_card(dev):
    """Every Kraus branch on the card, row by row: 64 trajectories of a
    strong depolarizing channel (each branch drawn with probability 1/4)
    and amplitude damping, on the cuda backend and on the planar backend
    with the same rowkeys, draw the same branches and give the same
    payloads; <X_1> and <Y_1> show which depolarizing branch a row drew."""
    from repro_torch.engine import ResultSpec, amplitude_damping, depolarizing
    t = hea_template(10, 2)       # complex amplitudes: <Y_1> is not 0
    rows = 64
    pm = np.repeat(np.random.default_rng(4).uniform(
        -3, 3, (1, t.num_params)).astype(np.float32), rows, axis=0)
    keys = np.array([[31, r] for r in range(rows)], np.uint32)
    spec = ResultSpec.noisy([depolarizing(1, 0.75),
                             amplitude_damping(4, 0.5)],
                            [{1: "X"}, {1: "Y"}, {4: "Z"}], unravelings=rows)
    _, got = BatchExecutor(H100, backend="cuda", cache=PlanCache()
                           ).dispatch_batch(t, pm, result=spec, rowkeys=keys)
    _, want = BatchExecutor(H100, backend="planar", cache=PlanCache()
                            ).dispatch_batch(t, pm, result=spec, rowkeys=keys)
    assert float((got - want).abs().max()) < 1e-5
    # the four depolarizing branches give four (<X_1>, <Y_1>) sign pairs
    signs = {tuple(np.sign(r[:2]).astype(int)) for r in got.cpu().numpy()}
    assert len(signs) == 4, signs
