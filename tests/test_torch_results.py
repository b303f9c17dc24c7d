"""The port's result modes (shots, Pauli expectations, noisy trajectories)
against the JAX package.

The same numpy inputs go through both packages: the port's ``cuda``
backend (its kernel wrappers run their plain versions on the CPU) against
JAX ``pallas`` in interpret mode, ``planar`` against ``planar`` and
``dense`` against ``dense``.  Expectations are held at the reference's
1e-5, states at 5e-6.  Shots cannot match ``jax.random`` bit for bit, so
they are held to the exact probabilities (chi-square under the 99.9%
critical value), to a float64 inverse CDF on the same uniforms, and to
themselves across batch compositions and reruns.  Noisy trajectory means
are held to a numpy density-matrix oracle.
"""
import functools

import numpy as np
import pytest
from scipy.stats import chi2

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import measure as JME  # noqa: E402
from repro.core import statevec as JSV  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.target import CPU_TEST as J_CPU  # noqa: E402
from repro.engine import BatchExecutor as JBatchExecutor  # noqa: E402
from repro.engine import results as JR  # noqa: E402
from repro.engine.plan import compile_plan as j_compile_plan  # noqa: E402
from repro.engine.template import hea_template as j_hea  # noqa: E402
from repro.engine.template import qaoa_template as j_qaoa  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core import circuits as TC  # noqa: E402
from repro_torch.core import gates as TG  # noqa: E402
from repro_torch.core import measure as ME  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.target import CPU_TEST  # noqa: E402
from repro_torch.engine import results as TR  # noqa: E402
from repro_torch.engine import (BatchExecutor, PlanCache,  # noqa: E402
                                hea_template, qaoa_template, template_of)
from repro_torch.engine.plan import compile_plan  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402

PAIRS = [("cuda", "pallas"), ("planar", "planar"), ("dense", "dense")]
PAULI = {"X": np.array([[0, 1], [1, 0]], np.complex128),
         "Y": np.array([[0, -1j], [1j, 0]], np.complex128),
         "Z": np.array([[1, 0], [0, -1]], np.complex128)}
OBS = [{0: "Z"}, {0: "Z", 1: "Z"}, {2: "X"}, {3: "Y"},
       {0: "X", 2: "Z", 5: "Y"}]


def _psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex64)


def _port_state(psi, n):
    jst = JSV.from_dense(psi, n, J_CPU)
    return jst, state_from_numpy(np.asarray(jst.data), n, jst.v,
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _templates(which, n=6, p=2):
    jt = {"qaoa": j_qaoa, "hea": j_hea}[which](n, p)
    tt = {"qaoa": qaoa_template, "hea": hea_template}[which](n, p)
    return jt, tt


def _params(t, b, seed=0):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (b, t.num_params)).astype(np.float32)


def _executor(backend):
    return BatchExecutor(CPU_TEST, backend=backend, device="cpu",
                         cache=PlanCache())


@functools.lru_cache(maxsize=None)
def _jax_dense_states(which, b, seed):
    jt, _ = _templates(which)
    pm = _params(jt, b, seed)
    ex = JBatchExecutor(J_CPU, backend="dense")
    return np.stack([np.asarray(s.to_dense()) for s in ex.run_batch(jt, pm)])


# -- specs ------------------------------------------------------------------------------

def _dep(m):
    return m.depolarizing(0, 0.1)


SPEC_CASES = {
    "statevector default": lambda m: m.ResultSpec.statevector(),
    "shots other key": lambda m: m.ResultSpec.sample(32, key=999),
    "noisy 16 unravelings": lambda m: m.ResultSpec.noisy(
        [_dep(m)], [{0: "Z"}], unravelings=16, key=7),
    "shots zero": lambda m: m.ResultSpec.sample(0),
    "shots negative": lambda m: m.ResultSpec(mode="shots", shots=-4),
    "key negative": lambda m: m.ResultSpec.sample(8, key=-1),
    "key too wide": lambda m: m.ResultSpec.sample(8, key=1 << 32),
    "key max": lambda m: m.ResultSpec.sample(8, key=(1 << 32) - 1),
    "expectation empty": lambda m: m.ResultSpec.expectation([]),
    "noisy no channels": lambda m: m.ResultSpec.noisy([], [{0: "Z"}]),
    "noisy no observables": lambda m: m.ResultSpec.noisy([_dep(m)], []),
    "noisy zero unravelings": lambda m: m.ResultSpec.noisy(
        [_dep(m)], [{0: "Z"}], unravelings=0),
    "channels outside noisy": lambda m: m.ResultSpec(
        mode="expectation", observables=({0: "Z"},), channels=(_dep(m),)),
    "shots outside shots mode": lambda m: m.ResultSpec(
        mode="expectation", observables=({0: "Z"},), shots=3),
    "unknown mode": lambda m: m.ResultSpec(mode="bogus"),
    "channel not a NoiseChannel": lambda m: m.ResultSpec(
        mode="noisy", observables=({0: "Z"},), channels=("x",)),
    "repeated qubit": lambda m: m.ResultSpec.expectation(
        [[(1, "Z"), (1, "X")]]),
    "unknown pauli": lambda m: m.ResultSpec.expectation([{0: "Q"}]),
    "negative qubit": lambda m: m.ResultSpec.expectation([{-1: "Z"}]),
    "observable normalized": lambda m: m.ResultSpec.expectation(
        [{2: "z", 0: "x"}]),
    "noisy ok": lambda m: m.ResultSpec.noisy(
        [_dep(m), m.amplitude_damping(2, 0.3)], [{0: "Z"}, {1: "X"}],
        unravelings=5, key=9),
    "kraus wrong shape": lambda m: m.NoiseChannel(
        qubits=(0,), kraus=(np.eye(4, dtype=np.complex64),)),
    "kraus empty": lambda m: m.NoiseChannel(qubits=(0,), kraus=()),
    "channel no qubits": lambda m: m.NoiseChannel(
        qubits=(), kraus=(np.eye(1, dtype=np.complex64),)),
    "channel repeats qubit": lambda m: m.NoiseChannel(
        qubits=(0, 0), kraus=(np.eye(4, dtype=np.complex64),)),
    "depolarizing p > 1": lambda m: m.depolarizing(0, 1.5),
    "bit flip p < 0": lambda m: m.bit_flip(0, -0.1),
    "phase flip p > 1": lambda m: m.phase_flip(0, 2.0),
    "damping gamma > 1": lambda m: m.amplitude_damping(0, 1.1),
}


def _outcome(make, module):
    try:
        return "ok", make(module)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_validation_matches_reference(case):
    kind, got = _outcome(SPEC_CASES[case], TR)
    ref_kind, ref = _outcome(SPEC_CASES[case], JR)
    assert kind == ref_kind
    if kind != "ok":
        assert got == ref                       # the same message
    elif isinstance(got, TR.ResultSpec):
        assert got.plan_key() == ref.plan_key()
        assert got.class_key_component() == ref.class_key_component()
        assert (got.rows, got.needs_key, got.observables) == \
            (ref.rows, ref.needs_key, ref.observables)


@pytest.mark.parametrize("make", [
    lambda m: m.depolarizing(0, 0.1), lambda m: m.depolarizing(0, 0.2),
    lambda m: m.depolarizing(1, 0.1), lambda m: m.bit_flip(1, 0.2),
    lambda m: m.phase_flip(0, 0.4), lambda m: m.amplitude_damping(2, 0.5),
    lambda m: m.NoiseChannel(qubits=(1, 3), kraus=(
        np.eye(4, dtype=np.complex64) * np.sqrt(0.5),
        np.diag([1, -1, 1, -1]).astype(np.complex64) * np.sqrt(0.5)),
        name="two-qubit")])
def test_channel_structure_keys_match_reference(make):
    a, b = make(TR), make(JR)
    assert a.structure_key() == b.structure_key()
    assert a.qubits == b.qubits and len(a.kraus) == len(b.kraus)
    for ka, kb in zip(a.kraus, b.kraus):
        assert ka.tobytes() == np.asarray(kb).tobytes()


def test_builtin_channels_trace_preserving_as_reference():
    for ch in (TR.depolarizing(0, 0.3), TR.bit_flip(1, 0.2),
               TR.phase_flip(0, 0.4), TR.amplitude_damping(2, 0.5)):
        acc = sum(k.conj().T @ k for k in ch.kraus)
        np.testing.assert_allclose(acc, np.eye(2), atol=1e-6)
    assert [len(c.kraus) for c in (TR.depolarizing(0, 0.1),
                                   TR.bit_flip(0, 0.1),
                                   TR.phase_flip(0, 0.1),
                                   TR.amplitude_damping(0, 0.1))] == \
        [4, 2, 2, 2]


def test_validate_for_matches_reference():
    jt, tt = _templates("qaoa", 5, 1)
    for make in (lambda m: m.ResultSpec.expectation([{7: "Z"}]),
                 lambda m: m.ResultSpec.noisy([m.depolarizing(6, 0.1)],
                                              [{0: "Z"}])):
        with pytest.raises(ValueError) as ref:
            make(JR).validate_for(jt)
        with pytest.raises(ValueError) as got:
            make(TR).validate_for(tt)
        assert str(got.value) == str(ref.value)


# -- plans ------------------------------------------------------------------------------

def _spec(m, mode):
    return {"shots": lambda: m.ResultSpec.sample(16, key=2),
            "expectation": lambda: m.ResultSpec.expectation(OBS),
            "noisy": lambda: m.ResultSpec.noisy(
                [m.depolarizing(0, 0.1), m.amplitude_damping(4, 0.3)],
                [{0: "Z"}, {1: "X", 4: "Z"}], unravelings=3, key=5)}[mode]()


@pytest.mark.parametrize("mode", ["shots", "expectation", "noisy"])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_result_plan_items_match_reference(mode, backend, jax_backend):
    jt, tt = _templates("qaoa")
    ref = j_compile_plan(jt, backend=jax_backend, target=J_CPU,
                         result=_spec(JR, mode))
    got = compile_plan(tt, backend=backend, target=CPU_TEST,
                       result=_spec(TR, mode))
    assert len(got.items) == len(ref.items)
    for a, b in zip(got.items, ref.items):
        assert (a.kind, a.qubits, a.controls) == (b.kind, b.qubits,
                                                  b.controls)
        assert [k.tobytes() for k in a.kraus] == \
            [np.asarray(k).tobytes() for k in b.kraus]
        if a.kind == "result":
            assert a.result.plan_key() == b.result.plan_key()
    assert got.items[-1].kind == "result" and got.result is not None
    assert got.class_counts() == ref.class_counts()
    assert got.flops_per_amp() == pytest.approx(ref.flops_per_amp())


@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_run_on_result_plan_is_the_statevector_run(backend):
    _, tt = _templates("qaoa")
    pm = _params(tt, 3)
    plain = compile_plan(tt, backend=backend, target=CPU_TEST)
    sv = compile_plan(tt, backend=backend, target=CPU_TEST,
                      result=TR.ResultSpec.statevector())
    assert sv.result is None
    assert [it.kind for it in sv.items] == [it.kind for it in plain.items]
    shots = compile_plan(tt, backend=backend, target=CPU_TEST,
                         result=TR.ResultSpec.sample(16, key=2))
    assert torch.equal(shots.run(pm[0], device="cpu").data,
                       plain.run(pm[0], device="cpu").data)
    assert torch.equal(shots.run_batch_raw(pm, device="cpu"),
                       plain.run_batch_raw(pm, device="cpu"))


def test_executor_plan_keys_cobatch_structural_twins():
    _, tt = _templates("qaoa", 5, 1)
    ex = _executor("cuda")
    k1 = ex.plan_key(tt, result=TR.ResultSpec.sample(32, key=1))
    k2 = ex.plan_key(tt, result=TR.ResultSpec.sample(32, key=2))
    k3 = ex.plan_key(tt, result=TR.ResultSpec.sample(64, key=1))
    assert k1 == k2 and k1 != k3 and k1 != ex.plan_key(tt)
    assert ex.plan_key(tt, result=TR.ResultSpec.statevector()) == \
        ex.plan_key(tt)


# -- expectations -----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_expectations(which, jax_backend):
    jt, _ = _templates(which)
    pm = _params(jt, 3, seed=4)
    ex = JBatchExecutor(J_CPU, backend=jax_backend)
    _, raw = ex.dispatch_batch(jt, pm, result=JR.ResultSpec.expectation(OBS))
    return np.asarray(raw)


@pytest.mark.parametrize("which", ["qaoa", "hea"])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_expectation_payloads_match_reference(which, backend, jax_backend):
    _, tt = _templates(which)
    pm = _params(tt, 3, seed=4)
    spec = TR.ResultSpec.expectation(OBS)
    ex = _executor(backend)
    plan, raw = ex.dispatch_batch(tt, pm, result=spec)
    assert tuple(raw.shape) == (3, len(OBS)) and raw.dtype == torch.float32
    ref = _jax_expectations(which, jax_backend)
    np.testing.assert_allclose(raw.numpy(), ref, atol=1e-5)
    # one row alone, and the rows retired through finalize_batch
    one = plan.run_result(pm[1], device="cpu")
    np.testing.assert_allclose(one.numpy(), ref[1], atol=1e-5)
    rows = ex.finalize_batch(plan, raw, count=2)
    assert len(rows) == 2 and torch.equal(rows[1], raw[1])


@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_simulator_expectation_pauli_matches_reference(backend):
    n = 6
    jst, st_ = _port_state(_psi(n, 3), n)
    sim = Simulator(CPU_TEST, backend=backend, device="cpu")
    for obs in OBS + [{4: "Z"}, {1: "x", 3: "y"}]:
        want = float(JME.expectation_pauli(jst, obs))
        got = sim.expectation_pauli(st_, obs)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) < 1e-5, obs
        plain = ME.expectation_pauli(st_, obs, plain=True)
        assert abs(float(plain) - want) < 1e-5


@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_ghz_parities(backend):
    sim = Simulator(CPU_TEST, backend=backend, device="cpu",
                    plan_cache=PlanCache())
    st_ = sim.run(TC.ghz(6))
    assert abs(float(sim.expectation_pauli(st_, {0: "Z", 5: "Z"})) - 1) < 1e-5
    assert abs(float(sim.expectation_pauli(
        st_, {q: "X" for q in range(6)})) - 1) < 1e-5
    assert abs(float(sim.expectation_pauli(st_, {0: "Z"}))) < 1e-5
    shots = sim.sample(st_, 512, key=4).numpy()
    assert set(np.unique(shots)) == {0, 63}


def test_measure_helpers_match_reference():
    n = 6
    jst, st_ = _port_state(_psi(n, 8), n)
    np.testing.assert_allclose(ME.probabilities(st_).numpy(),
                               np.asarray(JME.probabilities(jst)), atol=5e-7)
    for qubits in ([2], [0, 3], [4, 1, 5]):
        np.testing.assert_allclose(
            ME.marginal_probs(st_, qubits).numpy(),
            np.asarray(JME.marginal_probs(jst, qubits)), atol=1e-6)
    samples = np.array([3, 3, 5, 7, 7, 7, 0], np.int32)
    assert ME.bitstring_counts(torch.as_tensor(samples), 3) == \
        JME.bitstring_counts(samples, 3)


# -- shots ------------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_shots_chi_square_against_exact_probabilities(backend):
    which, b = "qaoa", 2
    _, tt = _templates(which)
    pm = _params(tt, b, seed=6)
    probs = np.abs(_jax_dense_states(which, b, 6)[1]) ** 2
    probs = probs / probs.sum()
    shots = 20000
    plan = _executor(backend).plan_for(tt, result=TR.ResultSpec.sample(
        shots, key=77))
    s = plan.run_result(pm[1], rowkey=(77, 0), device="cpu").numpy()
    assert s.dtype == np.int32 and s.shape == (shots,)
    observed = np.bincount(s, minlength=probs.size)
    expected = probs * shots
    mask = expected > 1e-9
    assert observed[~mask].sum() == 0
    stat = float(np.sum((observed[mask] - expected[mask]) ** 2
                        / expected[mask]))
    crit = chi2.ppf(0.999, int(mask.sum()) - 1)
    assert stat < crit, f"chi-square {stat:.1f} vs {crit:.1f}"


@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_shots_bitwise_across_batch_compositions(backend):
    _, tt = _templates("qaoa")
    pm = _params(tt, 8, seed=2)
    keys = np.array([[1000 + 7 * b, 0] for b in range(8)], np.uint32)
    spec = TR.ResultSpec.sample(64, key=0)
    ex = _executor(backend)
    plan, full = ex.dispatch_batch(tt, pm, result=spec, rowkeys=keys)
    assert full.dtype == torch.int32 and tuple(full.shape) == (8, 64)
    _, head = ex.dispatch_batch(tt, pm[:3], result=spec, rowkeys=keys[:3])
    _, tail = ex.dispatch_batch(tt, pm[3:], result=spec, rowkeys=keys[3:])
    assert torch.equal(torch.cat([head, tail]), full)
    for b in range(8):
        assert torch.equal(plan.run_result(pm[b], rowkey=keys[b],
                                           device="cpu"), full[b])
    _, again = ex.dispatch_batch(tt, pm, result=spec, rowkeys=keys)
    assert torch.equal(again, full)
    # another request key draws another payload; so does another trajectory
    _, other = ex.dispatch_batch(tt, pm, result=spec, rowkeys=keys + 1)
    assert not torch.equal(other, full)
    assert not torch.equal(plan.run_result(pm[0], rowkey=(keys[0, 0], 1),
                                           device="cpu"), full[0])


def test_sample_probs_clamps_top_of_cdf_edge():
    probs = torch.zeros(16)
    probs[15] = 1.0
    idx = ME.sample_probs(probs, 500, 7)
    assert int(idx.min()) == int(idx.max()) == 15
    # a mass past 1.0 (a float32 overshoot) still gives in-range indices
    idx = ME.sample_probs(torch.full((64,), 1.0 / 64) * 1.001, 2000, 8)
    assert int(idx.min()) >= 0 and int(idx.max()) <= 63
    # zero mass: the tiny-denominator guard leaves every CDF entry at 0, so
    # u = 0 finds the first entry and any u > 0 clamps to the last
    u = torch.tensor([0.0, 0.5, 1.0 - 2.0 ** -53], dtype=torch.float64)
    assert ME.inverse_cdf(ME.cdf64(torch.zeros(8)), u).tolist() == [0, 7, 7]


def test_sample_probs_renormalizes_unnormalized_cdf():
    probs = torch.zeros(8)
    probs[2] = probs[5] = 0.25             # total mass 0.5
    idx = ME.sample_probs(probs, 4000, 9).numpy()
    assert set(np.unique(idx)) == {2, 5}
    assert 0.45 < np.mean(idx == 2) < 0.55


def test_sample_reproducible_per_key_and_generator():
    _, st_ = _port_state(_psi(6, 3), 6)
    a, b = ME.sample(st_, 256, 1234), ME.sample(st_, 256, 1234)
    assert torch.equal(a, b) and not torch.equal(a, ME.sample(st_, 256, 1235))
    g = torch.Generator().manual_seed(5)
    h = torch.Generator().manual_seed(5)
    assert torch.equal(ME.sample(st_, 64, g), ME.sample(st_, 64, h))
    assert a.dtype == torch.int32 and int(a.max()) < 64


# -- the float64 CDF ----------------------------------------------------------------------

def _numpy_inverse_cdf(probs, u):
    cdf = np.cumsum(probs.astype(np.float64))
    cdf = cdf / max(cdf[-1], np.finfo(np.float64).tiny)
    return np.minimum(np.searchsorted(cdf, u), probs.size - 1)


@pytest.mark.parametrize("size", [1 << 10, 5000, 1 << 14])
def test_sampler_equals_float64_inverse_cdf(size):
    """With the same uniforms, every draw is the float64 inverse CDF's: one
    row of the blocked scan (1024), a padded last row (5000), and the
    two-level scan (2**14)."""
    rng = np.random.default_rng(size)
    probs = rng.exponential(size=size).astype(np.float32)
    probs /= probs.sum()
    probs[rng.integers(0, size, 8)] = 0.0
    u = ME.uniforms(20000, 31, "cpu")
    got = ME.inverse_cdf(ME.cdf64(torch.as_tensor(probs)), u).numpy()
    np.testing.assert_array_equal(got, _numpy_inverse_cdf(probs, u.numpy()))
    assert torch.equal(ME.sample_probs(torch.as_tensor(probs), 20000, 31),
                       torch.as_tensor(got))
    cdf = ME.cdf64(torch.as_tensor(probs)).numpy()
    np.testing.assert_allclose(cdf, np.cumsum(probs.astype(np.float64)),
                               rtol=1e-13, atol=0)


def test_float32_cdf_of_the_reference_loses_basis_states(capsys):
    """A record of the JAX package's float32 CDF (``measure.py:45``), not a
    change to it: at n = 20 a random state's float32 running sum has fewer
    distinct values than the state has basis states of nonzero
    probability, so ``searchsorted`` can never return some of them; the
    port's float64 CDF keeps every one reachable."""
    n = 20
    rng = np.random.default_rng(20)
    amp = rng.standard_normal((2, 1 << n)).astype(np.float32)
    probs = amp[0] ** 2 + amp[1] ** 2
    probs /= probs.sum()
    f32 = np.asarray(jnp.cumsum(jnp.asarray(probs)))
    f64 = ME.cdf64(torch.as_tensor(probs)).numpy()
    reach32 = np.unique(f32).size
    reach64 = np.unique(f64).size
    with capsys.disabled():
        print(f"\nn={n}: reference float32 CDF {reach32} distinct values, "
              f"port float64 CDF {reach64}, nonzero states "
              f"{int((probs > 0).sum())}")
    assert reach64 == int((probs > 0).sum()) == 1 << n
    assert reach32 < reach64, (reach32, reach64)


# -- noisy trajectories -------------------------------------------------------------------

def _embed(n, q, m):
    full = np.eye(1, dtype=np.complex128)
    for i in reversed(range(n)):          # qubit 0 is the lowest bit
        full = np.kron(full, m if i == q else np.eye(2))
    return full


def _oracle_noisy(psi, n, channels, obs):
    """Exact density-matrix (Kraus-sum) expectation of each observable."""
    psi = np.asarray(psi, np.complex128)
    rho = np.outer(psi, psi.conj())
    for ch in channels:
        ks = [_embed(n, ch.qubits[0], np.asarray(k, np.complex128))
              for k in ch.kraus]
        rho = sum(k @ rho @ k.conj().T for k in ks)
    out = []
    for o in obs:
        p = np.eye(1 << n, dtype=np.complex128)
        for q, name in o.items():
            p = _embed(n, q, PAULI[name]) @ p
        out.append(float(np.real(np.trace(p @ rho))))
    return np.array(out)


NOISY_N = 3
NOISY_OBS = [{0: "Z"}, {2: "Z"}, {1: "X"}]


def _noisy_channels(m):
    return [m.depolarizing(0, 0.3), m.amplitude_damping(2, 0.4)]


def _noisy_inputs():
    jt, tt = _templates("qaoa", NOISY_N, 1)
    params = np.array([0.5, 0.3], np.float32)
    psi = JSimulator(J_CPU, backend="dense").run(
        jt.bind(params)).to_dense()
    want = _oracle_noisy(np.asarray(psi), NOISY_N, _noisy_channels(JR),
                         NOISY_OBS)
    return jt, tt, params, want


NOISY_ROWS = 2048


def _ideal(params):
    jt, _ = _templates("qaoa", NOISY_N, 1)
    psi = JSimulator(J_CPU, backend="dense").run(jt.bind(params)).to_dense()
    return _oracle_noisy(np.asarray(psi), NOISY_N, [], NOISY_OBS)


def _within_four_standard_errors(rows, want, ideal):
    """The trajectory mean lies within 4 standard errors of the oracle, and
    for some observable the noise moves the oracle further than that from
    the noiseless value, so a run that skipped the channels would fail.
    (The 1e-6 covers float32 rounding where an observable does not vary
    from row to row: <X_1> here, whose standard error is near 0.)"""
    mean = rows.mean(axis=0)
    se = rows.std(axis=0, ddof=1) / np.sqrt(rows.shape[0])
    assert np.all(np.abs(mean - want) <= 4 * se + 1e-6), (mean, want, se)
    assert np.any(np.abs(ideal - want) > 8 * se), (ideal, want, se)


def _noisy_rows(m):
    spec = m.ResultSpec.noisy(_noisy_channels(m), NOISY_OBS,
                              unravelings=NOISY_ROWS, key=17)
    keys = np.array([[17, t] for t in range(NOISY_ROWS)], np.uint32)
    return spec, keys


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_noisy_mean_matches_density_matrix_oracle(backend):
    _, tt, params, want = _noisy_inputs()
    spec, keys = _noisy_rows(TR)
    pm = np.repeat(params[None], NOISY_ROWS, axis=0)
    _, raw = _executor(backend).dispatch_batch(tt, pm, result=spec,
                                               rowkeys=keys)
    _within_four_standard_errors(raw.numpy().astype(np.float64), want,
                                 _ideal(params))


def test_reference_noisy_mean_matches_density_matrix_oracle():
    jt, _, params, want = _noisy_inputs()
    spec, keys = _noisy_rows(JR)
    pm = np.repeat(params[None], NOISY_ROWS, axis=0)
    _, raw = JBatchExecutor(J_CPU, backend="planar").dispatch_batch(
        jt, pm, result=spec, rowkeys=keys)
    _within_four_standard_errors(np.asarray(raw, np.float64), want,
                                 _ideal(params))


@pytest.mark.parametrize("backend", ["cuda", "planar", "dense"])
def test_noisy_deterministic_channels(backend):
    _, tt = _templates("qaoa")
    pm = _params(tt, 3, seed=5)
    obs = [{0: "Z"}, {2: "X"}, {3: "Z"}]
    ex = _executor(backend)
    _, ideal = ex.dispatch_batch(tt, pm, result=TR.ResultSpec.expectation(
        obs))
    zero = TR.ResultSpec.noisy([TR.depolarizing(0, 0.0),
                                TR.bit_flip(2, 0.0)], obs, unravelings=3,
                               key=1)
    _, got = ex.dispatch_batch(tt, pm, result=zero,
                               rowkeys=[[1, t] for t in range(3)])
    np.testing.assert_allclose(got.numpy(), ideal.numpy(), atol=1e-5)
    # a certain flip on qubit 3 negates <Z_3> and leaves the others
    flip = TR.ResultSpec.noisy([TR.bit_flip(3, 1.0)], obs, unravelings=3,
                               key=2)
    _, got = ex.dispatch_batch(tt, pm, result=flip,
                               rowkeys=[[2, t] for t in range(3)])
    np.testing.assert_allclose(got.numpy()[:, 2], -ideal.numpy()[:, 2],
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, :2], ideal.numpy()[:, :2],
                               atol=1e-6)
    # X|0> = |1>, then damping with gamma = 1 resets it: exactly |0>
    reset = TR.ResultSpec.noisy([TR.amplitude_damping(1, 1.0)], [{1: "Z"}],
                                unravelings=1)
    got = ex.plan_for(template_of(TC.Circuit(3, [TG.x(1)])),
                      result=reset).run_result(device="cpu")
    np.testing.assert_allclose(got.numpy(), [1.0], atol=1e-6)


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_noisy_rows_bitwise_across_batch_compositions(backend):
    _, tt = _templates("qaoa")
    params = _params(tt, 1, seed=9)[0]
    spec = TR.ResultSpec.noisy([TR.depolarizing(1, 0.4),
                                TR.amplitude_damping(4, 0.5)],
                               [{1: "Z"}, {4: "Z"}], unravelings=6, key=23)
    pm = np.repeat(params[None], 6, axis=0)
    keys = np.array([[23, t] for t in range(6)], np.uint32)
    ex = _executor(backend)
    plan, full = ex.dispatch_batch(tt, pm, result=spec, rowkeys=keys)
    _, again = ex.dispatch_batch(tt, pm, result=spec, rowkeys=keys)
    assert torch.equal(again, full)
    _, head = ex.dispatch_batch(tt, pm[:2], result=spec, rowkeys=keys[:2])
    assert torch.equal(head, full[:2])
    assert torch.equal(plan.run_result(params, rowkey=keys[5], device="cpu"),
                       full[5])
    assert len({tuple(r) for r in full.numpy().tolist()}) > 1


def test_with_backend_runs_the_same_items_with_steps_of_its_own():
    """A cuda plan's planar twin shares the compiled items and nothing it
    builds: its rows equal the plan's and those of the planar backend's own
    plan."""
    _, tt = _templates("qaoa")
    pm = np.repeat(_params(tt, 1, seed=4), 4, axis=0)
    spec = TR.ResultSpec.noisy([TR.depolarizing(0, 0.75)],
                               [{0: "X"}, {2: "Z"}], unravelings=4, key=3)
    keys = np.array([[3, t] for t in range(4)], np.uint32)
    plan = _executor("cuda").plan_for(tt, result=spec)
    got = plan.run_batch_result_raw(pm, keys, device="cpu")
    twin = plan.with_backend("planar")
    assert twin.backend == "planar" and twin.items is plan.items
    assert twin.result == plan.result
    assert twin._program_steps() is not plan._program_steps()
    assert twin._result_program() is not plan._result_program()
    # the twin reduces <Z_2> with the planar inner product, not K3's plain
    # version: equal at the expectation tolerance, not bit for bit
    for other in (twin, _executor("planar").plan_for(tt, result=spec)):
        np.testing.assert_allclose(
            other.run_batch_result_raw(pm, keys, device="cpu").numpy(),
            got.numpy(), atol=1e-5)
    assert plan.with_backend("cuda").backend == "cuda"
    with pytest.raises(ValueError, match="share an item list"):
        plan.with_backend("dense")


# -- executor paths -----------------------------------------------------------------------

@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_run_states_and_finalize_match_reference(backend, jax_backend):
    n = 5
    jt, tt = _templates("qaoa", n, 1)
    params = np.array([0.4, -0.9], np.float32)
    pairs = [_port_state(_psi(n, s), n) for s in (1, 2, 3)]
    ref = JBatchExecutor(J_CPU, backend=jax_backend).run_states(
        jt, [j for j, _ in pairs], params=params)
    ex = _executor(backend)
    got = ex.run_states(tt, [p for _, p in pairs], params=params)
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.to_dense().numpy(),
                                   np.asarray(r.to_dense()), atol=5e-6)
    with pytest.raises(ValueError, match="at least one"):
        ex.run_states(tt, [])
    pm = np.stack([params, params * 0.5])
    plan, raw = ex.dispatch_batch(tt, pm)
    states = ex.finalize_batch(plan, raw)
    assert len(states) == 2 and torch.equal(states[1].data,
                                            plan._wrap(raw[1]).data)


def test_result_modes_on_the_cpu_launch_no_kernel():
    """On the CPU every wrapper takes its plain version: the whole result
    path, K3 observables and Kraus branches included, counts no launch."""
    _, tt = _templates("qaoa")
    pm = _params(tt, 2)
    before = launch_counts()
    ex = _executor("cuda")
    for spec in (TR.ResultSpec.sample(8, key=1),
                 TR.ResultSpec.expectation(OBS),
                 TR.ResultSpec.noisy([TR.amplitude_damping(0, 0.3)],
                                     [{0: "Z"}], unravelings=2)):
        ex.dispatch_batch(tt, pm, result=spec)
    assert launch_counts() == before
