"""Dispatcher for the ``<Z_q>`` CUDA kernel, and its plain version.

``expectation_z`` takes the plain version for a tensor on the CPU and
launches the two-pass reduction kernel for a tensor on a CUDA device;
anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as KB

EXPECT = KB.Kernel("expectation", "rt_expectation_z",
                   [KB.P, KB.P, KB.P, KB.I32, KB.I32, KB.I32, KB.I32, KB.P])

THREADS = 256            # kernel block size (csrc/expectation.cu)
ITEMS_PER_THREAD = 64    # amplitudes each pass-1 thread sums in order


def partial_blocks(n: int) -> int:
    """Pass-1 blocks per row: each thread sums ``ITEMS_PER_THREAD``
    amplitudes."""
    return max(1, (1 << n) // (THREADS * ITEMS_PER_THREAD))


def expectation_z(data: torch.Tensor, n: int, v: int,
                  qubit: int) -> torch.Tensor:
    """<Z_qubit> of a planar state: f32 scalar for data f32[2, R, V],
    f32[B] for data f32[B, 2, R, V]."""
    if data.device.type == "cpu":
        return expectation_z_ref(data, n, v, qubit)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("state must be a contiguous float32 tensor")
    if data.dim() not in (3, 4) or data.shape[-3] != 2 \
            or data.shape[-2] * data.shape[-1] != 1 << n:
        raise ValueError(f"state shape {tuple(data.shape)} does not hold "
                         f"[B,] 2 x 2**{n} amplitudes")
    if not 0 <= qubit < n:
        raise ValueError(f"qubit {qubit} out of range for n={n}")
    b = data.shape[0] if data.dim() == 4 else 1
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    nblocks = partial_blocks(n)
    partials = torch.empty((b, nblocks), dtype=torch.float32,
                           device=data.device)
    out = torch.empty((b,), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        EXPECT(KB.ptr(data), KB.ptr(partials), KB.ptr(out), b, n, int(qubit),
               nblocks, KB.stream_of(data))
    return out if data.dim() == 4 else out[0]


def expectation_z_ref(data: torch.Tensor, n: int, v: int,
                      qubit: int) -> torch.Tensor:
    """Plain version: dense reduction with the qubit axis exposed by
    reshape."""
    lead = data.shape[:-3]
    p = data.reshape(lead + (2, 1 << n))
    probs = p[..., 0, :] * p[..., 0, :] + p[..., 1, :] * p[..., 1, :]
    probs = probs.reshape(lead + (1 << (n - qubit - 1), 2, 1 << qubit))
    return (torch.sum(probs[..., :, 0, :], dim=(-2, -1))
            - torch.sum(probs[..., :, 1, :], dim=(-2, -1)))
