"""Gate application in plain PyTorch.

Two implementations live here, both with an optional leading batch axis on
the state and on the matrix (a matrix with batch extent 1 broadcasts):

* ``apply_gate_dense`` — the naive baseline on the dense ``complex64[2**n]``
  vector.  It is the oracle for everything else and the ``dense`` backend.

* ``apply_gate_planar`` — the VLA design on the lane-tiled planar layout
  ``f32[2, R, V]``: explicit real arithmetic (four real matmuls per complex
  matvec, the paper's FMA formulation).  It is the ``planar`` backend and the
  plain version the fused-gate kernel is held against.

Both are out of place.  Conventions: see ``repro_torch.core.gates``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _apply_on_axes_complex(t: torch.Tensor, u: torch.Tensor,
                           axes: Sequence[int]) -> torch.Tensor:
    """Apply ``u`` ([B|1, 2^k, 2^k] complex) over tensor axes of ``t``
    ([B, 2, ..., 2]); ``axes[m]`` holds gate bit m."""
    k = len(axes)
    order = [axes[m] for m in reversed(range(k))]  # axis for MSB first
    t = torch.movedim(t, order, list(range(1, k + 1)))
    shape = t.shape
    t = torch.matmul(u, t.reshape(shape[0], 1 << k, -1))
    return torch.movedim(t.reshape(shape), list(range(1, k + 1)), order)


def _apply_on_axes_planar(t: torch.Tensor, u_re: torch.Tensor,
                          u_im: torch.Tensor,
                          axes: Sequence[int]) -> torch.Tensor:
    """Same on a planar tensor ``[B, 2(planes), 2, ..., 2]``; ``axes``
    exclude the batch and plane axes."""
    k = len(axes)
    order = [axes[m] for m in reversed(range(k))]
    t = torch.movedim(t, order, list(range(2, k + 2)))
    shape = t.shape
    t = t.reshape(shape[0], 2, 1 << k, -1)
    re, im = t[:, 0], t[:, 1]
    # complex matvec as 4 real matmuls (paper's FMA formulation)
    out_re = torch.matmul(u_re, re) - torch.matmul(u_im, im)
    out_im = torch.matmul(u_re, im) + torch.matmul(u_im, re)
    t = torch.stack([out_re, out_im], dim=1).reshape(shape)
    return torch.movedim(t, list(range(2, k + 2)), order)


def _subtensor_apply(t: torch.Tensor, lead: int, ctrl_axes: list[int],
                     tgt_axes: list[int], apply_fn) -> torch.Tensor:
    """Apply ``apply_fn`` on the subtensor where all control axes == 1;
    the first ``lead`` axes (batch, planes) are carried through."""
    if not ctrl_axes:
        return apply_fn(t, tgt_axes)
    dst = list(range(lead, lead + len(ctrl_axes)))
    idx = (slice(None),) * lead + (1,) * len(ctrl_axes)
    sub = torch.movedim(t, ctrl_axes, dst)[idx]
    rem = [a for a in range(t.dim()) if a not in set(ctrl_axes)]
    pos = {a: i for i, a in enumerate(rem)}
    new = apply_fn(sub, [pos[a] for a in tgt_axes])
    out = t.clone()
    torch.movedim(out, ctrl_axes, dst)[idx] = new
    return out


def _batched_matrix(u: torch.Tensor) -> torch.Tensor:
    return u if u.dim() == 3 else u.unsqueeze(0)


def apply_gate_dense(psi: torch.Tensor, n: int, qubits: tuple[int, ...],
                     u: torch.Tensor,
                     controls: tuple[int, ...] = ()) -> torch.Tensor:
    """Naive-baseline gate application on the dense complex vector.

    psi: c64[2**n] or c64[B, 2**n]; u: c64[2**k, 2**k] or [B|1, 2**k, 2**k].
    """
    batched = psi.dim() == 2
    b = psi.shape[0] if batched else 1
    t = psi.reshape((b,) + (2,) * n)
    axis = lambda q: 1 + (n - 1 - q)
    u = _batched_matrix(u)
    t = _subtensor_apply(
        t, 1, [axis(q) for q in controls], [axis(q) for q in qubits],
        lambda tt, ax: _apply_on_axes_complex(tt, u, ax))
    return t.reshape(psi.shape)


def apply_gate_planar(data: torch.Tensor, n: int, qubits: tuple[int, ...],
                      u_re: torch.Tensor, u_im: torch.Tensor,
                      controls: tuple[int, ...] = ()) -> torch.Tensor:
    """VLA gate application on the lane-tiled planar layout.

    data: f32[2, R, V] or f32[B, 2, R, V]; u_re/u_im: f32[2**k, 2**k] or
    [B|1, 2**k, 2**k].  Row qubits and lane qubits are handled uniformly:
    the (R, V) trailing axes are one contiguous ``2**n`` index space.
    """
    batched = data.dim() == 4
    b = data.shape[0] if batched else 1
    t = data.reshape((b, 2) + (2,) * n)
    axis = lambda q: 2 + (n - 1 - q)
    u_re, u_im = _batched_matrix(u_re), _batched_matrix(u_im)
    t = _subtensor_apply(
        t, 2, [axis(q) for q in controls], [axis(q) for q in qubits],
        lambda tt, ax: _apply_on_axes_planar(tt, u_re, u_im, ax))
    return t.reshape(data.shape)
