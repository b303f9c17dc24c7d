"""Plain PyTorch versions of the two gate kernels.

The wrappers in ``ops.py`` take these for tensors on the CPU, and the chip
smoke test holds each CUDA kernel against them on the card.  They share no
index arithmetic with the kernels: the fused gate goes through the planar
tensor contraction of ``core.apply`` (qubit axes exposed by reshape and
moved together), and the diagonal/permutation gate exposes the cluster
qubits the same way and gathers/rotates along that one axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.apply import apply_gate_planar


def apply_fused_gate_ref(data: torch.Tensor, n: int, v: int,
                         qubits: tuple[int, ...], u_re: torch.Tensor,
                         u_im: torch.Tensor,
                         controls: tuple[int, ...] = ()) -> torch.Tensor:
    """data: f32[2, R, V] or f32[B, 2, R, V]; u_re/u_im: f32[2**k, 2**k]
    or [B|1, 2**k, 2**k]; bit m of U's index <-> ``qubits[m]``."""
    return apply_gate_planar(data, n, tuple(qubits), u_re, u_im,
                             tuple(controls))


def apply_phase_gate_ref(data: torch.Tensor, n: int, v: int,
                         qubits: tuple[int, ...], p_re, p_im,
                         perm=None) -> torch.Tensor:
    """``out[r] = phase[r] * in[perm[r]]`` over the ``2**w`` cluster rows
    (bit m of r <-> ``qubits[m]``), broadcast over the other qubits.

    p_re/p_im: f32[2**w] or [B|1, 2**w], or None (pure permutation);
    perm: int[2**w] (numpy or tensor) or None (pure phase).
    """
    w = len(qubits)
    b = data.shape[0] if data.dim() == 4 else 1
    t = data.reshape((b, 2) + (2,) * n)
    axes = [2 + (n - 1 - q) for q in reversed(qubits)]  # MSB cluster bit first
    t = torch.movedim(t, axes, list(range(2, 2 + w)))
    shape = t.shape
    t = t.reshape(b, 2, 1 << w, -1)
    if perm is not None:
        idx = torch.as_tensor(np.asarray(perm) if not torch.is_tensor(perm)
                              else perm, device=t.device).to(torch.long)
        t = t[:, :, idx]
    if p_re is not None:
        pr = p_re.reshape(-1, 1 << w, 1)
        pi = p_im.reshape(-1, 1 << w, 1)
        re, im = t[:, 0], t[:, 1]
        t = torch.stack([pr * re - pi * im, pr * im + pi * re], dim=1)
    t = torch.movedim(t.reshape(shape), list(range(2, 2 + w)), axes)
    return t.reshape(data.shape)
