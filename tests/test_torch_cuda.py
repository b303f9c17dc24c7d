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
                                qaoa_template)
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
