"""Measurement: computational-basis sampling + Pauli-string observables.

Production simulators expose both (Qsim's ``sample`` and
``ExpectationValue``); the paper's §IV streams the expectation reduction
instead of storing states back.  This module mirrors the JAX package's
``core/measure.py``:

* ``sample(state, n_samples, key)`` — inverse-CDF sampling over |amp|^2
  (searchsorted; exact, no Gumbel approximation).
* ``expectation_pauli(state, {qubit: 'X'|'Y'|'Z'})`` — <P> for a Pauli
  string, computed as <psi| P |psi> with each factor applied by the
  fused-gate kernel (its plain version for a CPU state).
* ``marginal_probs(state, qubits)`` — marginal distribution over a subset.

**Where this module departs from the JAX package: the CDF is float64.**
The JAX package accumulates the CDF in float32 (``jnp.cumsum`` of float32
probabilities, ``src/repro/core/measure.py:45``).  At n = 30 one basis
state's probability is about 1e-9, while float32 values near a CDF of
0.5-1 are 6e-8 apart: the float32 running sum gives runs of consecutive
basis states one CDF value, and ``searchsorted`` only ever returns the
first of each run, so most basis states can never be drawn.  That is a
fault of the reference, and the port does not copy it: the CDF here is
accumulated in float64 and searched with float64 uniforms, so every basis
state with nonzero probability stays reachable.  The reference's two
guards are kept: the CDF is renormalized by ``max(cdf[-1], tiny)`` and the
drawn index is clamped to ``2**n - 1``.

Randomness comes from an explicit ``torch.Generator``, or from an integer
key that seeds one (:func:`generator`); never from the global generator.
Draws are bitwise reproducible within the port for one device type (the
CPU's and CUDA's generators differ); they cannot match ``jax.random``.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import gates as G
from repro_torch.core.statevec import State
from repro_torch.kernels.apply_gate import ops as K
from repro_torch.kernels.apply_gate import ref as R

_PAULI = {"X": G.X_M, "Y": G.Y_M, "Z": G.Z_M}
_MASK64 = (1 << 64) - 1
_TINY64 = float(np.finfo(np.float64).tiny)
# row length of the blocked prefix sum in :func:`_scan64`
_SCAN_ROW = 1 << 12
# device copies of the Pauli planes, made at first use on a device
_PLANES: dict = {}


def mix64(*words: int) -> int:
    """A 64-bit seed from a tuple of integers: a splitmix64 step per word.

    Fixed for all time, so a seed (and the stream a generator draws from
    it) depends only on the words — for a result-mode row, on its request
    key, trajectory index and stream salt."""
    h = 0
    for w in words:
        h = (h ^ (int(w) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h


def generator(key, device: str | torch.device) -> torch.Generator:
    """``key`` itself if it is a ``torch.Generator``, else a new generator
    on ``device`` seeded with ``mix64(key)``."""
    if isinstance(key, torch.Generator):
        return key
    g = torch.Generator(device=device)
    g.manual_seed(mix64(int(key)))
    return g


def pauli_planes(p: str, device: str | torch.device,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (re, im) planes of the Pauli matrix ``p`` on ``device``."""
    key = (p.upper(), torch.device(device))
    planes = _PLANES.get(key)
    if planes is None:
        m = _PAULI[key[0]]
        planes = _PLANES[key] = (
            torch.as_tensor(m.real.astype(np.float32), device=device),
            torch.as_tensor(m.imag.astype(np.float32), device=device))
    return planes


def probabilities(state: State) -> torch.Tensor:
    """|amplitude|^2 in dense basis order, f32[2**n]."""
    return state.probabilities()


def cdf64(probs: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 prefix sum of a probability vector."""
    return _scan64(probs.reshape(-1).to(torch.float64, copy=True))


def _scan64(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the float64 vector ``x``, which it may
    overwrite.

    The sum runs in an order fixed by the length alone: rows of ``2**12``
    entries each get their offset (the prefix of the row sums, the same
    scheme one level down) added to their first entry and are then scanned
    along the row.  On CUDA ``torch.cumsum`` of a 1-D tensor runs a
    single-pass scan whose partial sums may combine in another order from
    run to run; row sums and scans along the rows of a 2-D tensor do not,
    so the same probabilities always give the same bits.
    """
    n = x.numel()
    if n <= _SCAN_ROW:
        # two rows: the scan along rows, never the 1-D single-pass scan
        return torch.cumsum(torch.stack((x, x)), dim=1)[0]
    rows_n = -(-n // _SCAN_ROW)
    if rows_n * _SCAN_ROW != n:
        x = torch.nn.functional.pad(x, (0, rows_n * _SCAN_ROW - n))
    rows = x.view(rows_n, _SCAN_ROW)
    offsets = _scan64(rows.sum(dim=1))
    rows[1:, 0] += offsets[:-1]
    return torch.cumsum(rows, dim=1).view(-1)[:n]


def inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Basis-state index of each float64 uniform ``u`` under the float64
    CDF ``cdf`` (int32, the shape of ``u``).

    Keeps the JAX package's two guards against the float edges of
    searchsorted sampling: the CDF is renormalized with a tiny-denominator
    guard (here by scaling the uniforms by ``max(cdf[-1], tiny)`` instead
    of dividing all ``2**n`` entries), and the drawn index is clamped to
    the last basis state."""
    total = torch.clamp(cdf[-1], min=_TINY64)
    idx = torch.searchsorted(cdf, u.to(torch.float64) * total)
    return torch.clamp(idx, max=cdf.shape[0] - 1).to(torch.int32)


def uniforms(n_samples: int, key, device: str | torch.device,
             ) -> torch.Tensor:
    """float64 uniforms in [0, 1) from ``key`` (see :func:`generator`)."""
    g = generator(key, device)
    return torch.rand(n_samples, dtype=torch.float64, generator=g,
                      device=device)


def sample_probs(probs: torch.Tensor, n_samples: int, key) -> torch.Tensor:
    """Inverse-CDF sampling from a probability vector (int32
    ``[n_samples]``); ``key`` is a ``torch.Generator`` or an integer."""
    return inverse_cdf(cdf64(probs), uniforms(n_samples, key, probs.device))


def sample(state: State, n_samples: int, key) -> torch.Tensor:
    """Draw basis-state indices ~ |amp|^2 (int32 [n_samples]).

    At n = 30 the state is 8 GiB, its probabilities 4 GiB and their CDF
    8 GiB: each intermediate is freed before the next is made."""
    probs = probabilities(state)
    x = probs.reshape(-1).to(torch.float64)
    del probs
    cdf = _scan64(x)
    del x
    return inverse_cdf(cdf, uniforms(n_samples, key, cdf.device))


def inner_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a|b> of planar states: f32 for ``[2, R, V]``, f32[B] for
    ``[B, 2, R, V]``, one row at a time.  Each plane is one ``torch.dot``
    (2**n entries, within cuBLAS's 32-bit count at n = 30), the two added
    in float64."""
    if a.dim() == 4:
        return torch.stack([inner_re(a[i], b[i]) for i in range(a.shape[0])])
    fa, fb = a.reshape(2, -1), b.reshape(2, -1)
    return (torch.dot(fa[0], fb[0]).double()
            + torch.dot(fa[1], fb[1]).double()).float()


def expectation_pauli(state: State, paulis: Mapping[int, str],
                      plain: bool = False) -> torch.Tensor:
    """<psi| prod_q P_q |psi> for P in {X, Y, Z} (real for Hermitian P).

    Each factor is one launch of the fused-gate kernel (k = 1; its plain
    version for a CPU state), or the plain version itself with
    ``plain=True``; the inner product is :func:`inner_re`."""
    apply = R.apply_fused_gate_ref if plain else K.apply_fused_gate
    data = state.data
    pd = data
    for q, p in sorted(paulis.items()):
        ur, ui = pauli_planes(p, data.device)
        pd = apply(pd, state.n, state.v, (int(q),), ur, ui)
    return inner_re(data, pd)


def marginal_probs(state: State, qubits: Sequence[int]) -> torch.Tensor:
    """Marginal distribution over ``qubits`` (little-endian order)."""
    probs = probabilities(state).reshape((2,) * state.n)
    axes = tuple(state.n - 1 - q for q in range(state.n)
                 if q not in set(qubits))
    marg = torch.sum(probs, dim=axes) if axes else probs
    # remaining axes are qubits sorted descending; reorder to `qubits`
    remaining = sorted(qubits, reverse=True)
    perm = [remaining.index(q) for q in qubits]
    if perm != list(range(len(perm))):
        marg = marg.permute(perm)
    return marg.reshape(-1) if len(qubits) == 1 else marg


def bitstring_counts(samples, n: int, top: int = 8) -> list[tuple[str, int]]:
    """Human-readable histogram of sampled basis states."""
    if torch.is_tensor(samples):
        samples = samples.cpu().numpy()
    vals, counts = np.unique(np.asarray(samples), return_counts=True)
    order = np.argsort(-counts)[:top]
    return [(format(int(vals[i]), f"0{n}b"), int(counts[i])) for i in order]
