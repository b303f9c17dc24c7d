"""Dispatchers for the fused-gate and diagonal/permutation CUDA kernels.

Each wrapper takes its plain version (``ref.py``) for a tensor on the CPU
and launches its kernel for a tensor on a CUDA device; anything else, or a
tensor the kernel does not take, raises.  There is no fallback from a CUDA
tensor to the plain version.  Both wrappers accept an optional leading batch
axis on the state, and a batch extent of 1 or B on the unitary / phase
planes (1 broadcasts).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels.apply_gate import ref as R

MAX_K = 7          # widest dense gate the fused kernel takes (U in shared memory)

FUSED = KB.Kernel("apply_gate", "rt_apply_fused_gate",
                  [KB.P, KB.P, KB.P, KB.P, KB.I32, KB.I32, KB.I32, KB.U64,
                   KB.U64, KB.P])
PHASE = KB.Kernel("phase_gate", "rt_apply_phase_gate",
                  [KB.P, KB.P, KB.P, KB.P, KB.I32, KB.P, KB.I32, KB.I32,
                   KB.U64, KB.P])


@functools.lru_cache(maxsize=1024)
def _sort_perm(qubits: tuple[int, ...]) -> tuple[tuple[int, ...], np.ndarray]:
    """Permutation taking U (bit m <-> qubits[m]) to sorted-qubit order."""
    qs_sorted = tuple(sorted(qubits))
    pos = {q: m for m, q in enumerate(qubits)}
    k = len(qubits)
    perm = np.zeros(1 << k, np.int32)
    for j in range(1 << k):
        j_orig = 0
        for m in range(k):
            if (j >> m) & 1:
                j_orig |= 1 << pos[qs_sorted[m]]
        perm[j] = j_orig
    return qs_sorted, perm


def _mask(qubits, n: int, what: str) -> int:
    m = 0
    for q in qubits:
        if not 0 <= q < n or (m >> q) & 1:
            raise ValueError(f"{what} {tuple(qubits)} invalid for n={n}")
        m |= 1 << q
    return m


def _check_state(data: torch.Tensor, n: int, v: int) -> int:
    """Validate a CUDA planar state; returns its batch extent."""
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("state must be a contiguous float32 tensor")
    if data.dim() not in (3, 4) or tuple(data.shape[-3:]) != (
            2, 1 << (n - v), 1 << v):
        raise ValueError(f"state shape {tuple(data.shape)} is not "
                         f"[B,] 2 x {1 << (n - v)} x {1 << v}")
    b = data.shape[0] if data.dim() == 4 else 1
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernels' grid limit 65535")
    return b


def _check_rows(t: torch.Tensor, like: torch.Tensor, b: int,
                tail: tuple[int, ...], what: str) -> int:
    """Validate per-row operands ([*tail] or [1|B, *tail]); returns 1 if
    they are batched per row, else 0."""
    if t.device != like.device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32 on {like.device}")
    if tuple(t.shape) == tail:
        return 0
    if t.dim() == len(tail) + 1 and tuple(t.shape[1:]) == tail \
            and t.shape[0] in (1, b):
        return int(t.shape[0] != 1)
    raise ValueError(f"{what} shape {tuple(t.shape)} is not [1|{b},] {tail}")


def apply_fused_gate(data: torch.Tensor, n: int, v: int,
                     qubits: tuple[int, ...], u_re: torch.Tensor,
                     u_im: torch.Tensor,
                     controls: tuple[int, ...] = ()) -> torch.Tensor:
    """Apply a (fused, optionally controlled) gate to the planar state.

    data: f32[2, R, V] or f32[B, 2, R, V] lane-tiled planar state.
    qubits: target qubit ids; bit m of u's index <-> qubits[m].
    u_re/u_im: f32[2**k, 2**k] or f32[1|B, 2**k, 2**k].
    Returns a new tensor; the input is not modified.
    """
    qubits = tuple(int(q) for q in qubits)
    controls = tuple(int(c) for c in controls)
    qs_sorted, perm = _sort_perm(qubits)
    if qs_sorted != qubits:
        p = torch.as_tensor(perm, dtype=torch.long, device=u_re.device)
        u_re = u_re[..., p, :][..., :, p]
        u_im = u_im[..., p, :][..., :, p]
    if data.device.type == "cpu":
        return R.apply_fused_gate_ref(data, n, v, qs_sorted, u_re, u_im,
                                      controls)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    k = len(qs_sorted)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused kernel takes 1..{MAX_K} gate qubits, got {k}")
    gmask = _mask(qs_sorted, n, "qubits")
    cmask = _mask(controls, n, "controls")
    if gmask & cmask:
        raise ValueError(f"qubits {qubits} overlap controls {controls}")
    b = _check_state(data, n, v)
    d = 1 << k
    u_re, u_im = u_re.contiguous(), u_im.contiguous()
    batched = _check_rows(u_re, data, b, (d, d), "u_re")
    if _check_rows(u_im, data, b, (d, d), "u_im") != batched \
            or u_im.shape != u_re.shape:
        raise ValueError("u_re and u_im shapes differ")
    out = torch.empty_like(data)
    with torch.cuda.device(data.device):
        FUSED(KB.ptr(data), KB.ptr(out), KB.ptr(u_re), KB.ptr(u_im), batched,
              b, n, gmask, cmask, KB.stream_of(data))
    return out


def apply_phase_gate(data: torch.Tensor, n: int, v: int,
                     qubits: tuple[int, ...], p_re: torch.Tensor | None,
                     p_im: torch.Tensor | None, perm=None) -> torch.Tensor:
    """Apply a diagonal/permutation (monomial) fused gate to the planar state.

    data: f32[2, R, V] or f32[B, 2, R, V] lane-tiled planar state.
    qubits: sorted cluster qubit ids; bit m of the ``2**w`` phase vector /
    ``perm`` index map corresponds to ``qubits[m]``.
    p_re/p_im: f32[2**w] or f32[1|B, 2**w] phase planes (``None`` for a pure
    permutation).
    perm: optional int[2**w] index map (numpy or tensor), ``out[r] =
    phase[r] * in[perm[r]]`` over the cluster rows.
    Returns a new tensor; the input is not modified.
    """
    qubits = tuple(int(q) for q in qubits)
    if qubits != tuple(sorted(qubits)):
        raise ValueError(f"apply_phase_gate needs sorted qubits, got {qubits}")
    if (p_re is None) != (p_im is None):
        raise ValueError("pass both phase planes or neither")
    if data.device.type == "cpu":
        return R.apply_phase_gate_ref(data, n, v, qubits, p_re, p_im,
                                      perm=perm)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    w = len(qubits)
    if not 1 <= w <= 31:
        raise ValueError(f"phase kernel takes 1..31 cluster qubits, got {w}")
    mask = _mask(qubits, n, "qubits")
    b = _check_state(data, n, v)
    batched = 0
    if p_re is not None:
        batched = _check_rows(p_re, data, b, (1 << w,), "p_re")
        if _check_rows(p_im, data, b, (1 << w,), "p_im") != batched \
                or p_im.shape != p_re.shape:
            raise ValueError("p_re and p_im shapes differ")
    perm_t = None
    if perm is not None:
        perm_t = torch.as_tensor(perm if torch.is_tensor(perm)
                                 else np.asarray(perm, np.int32),
                                 device=data.device).to(torch.int32)
        perm_t = perm_t.contiguous()
        if tuple(perm_t.shape) != (1 << w,):
            raise ValueError(f"perm shape {tuple(perm_t.shape)} is not "
                             f"({1 << w},)")
    out = torch.empty_like(data)
    with torch.cuda.device(data.device):
        PHASE(KB.ptr(data), KB.ptr(out), KB.ptr(p_re), KB.ptr(p_im), batched,
              KB.ptr(perm_t), b, n, mask, KB.stream_of(data))
    return out
