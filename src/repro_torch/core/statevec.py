"""Lane-tiled planar state vector — the paper's VLEN-adaptive memory layout.

The paper converts Qsim's interleaved complex array ``re0 im0 re1 im1 ...``
into blocks of ``numVals`` reals followed by ``numVals`` imaginaries so every
vector load is unit-stride (§IV-A).  The port keeps the same planar,
lane-tiled layout as a torch tensor::

    data : f32[2, R, V]     R = 2**n / V,  V = target.lanes

``data[0]`` holds real parts, ``data[1]`` imaginary parts.  Amplitude index
``x`` lives at ``(x // V, x % V)``, so the flat ``2**n`` axis of each plane
is contiguous and the kernels address it directly.  A batch of states is the
same layout with a leading axis, ``f32[B, 2, R, V]``.

Entry points take an explicit ``device`` and default to ``"cuda"``; they
raise when CUDA is absent unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.target import Target


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class State:
    """An n-qubit state in lane-tiled planar layout."""

    data: torch.Tensor  # f32[2, R, V]
    n: int              # number of qubits
    v: int              # log2(lanes)

    @property
    def lanes(self) -> int:
        return 1 << self.v

    @property
    def rows(self) -> int:
        return 1 << (self.n - self.v)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to_dense(self) -> torch.Tensor:
        """Return the c64[2**n] dense (interleaved) layout."""
        flat = self.data.reshape(2, 1 << self.n)
        return torch.complex(flat[0], flat[1])

    def probabilities(self) -> torch.Tensor:
        """|amplitude|^2 in dense basis order, f32[2**n]: the planar tile
        axes (R, V) flatten to the dense amplitude index ``x = r * V +
        lane``."""
        flat = self.data.reshape(2, 1 << self.n)
        return flat[0] * flat[0] + flat[1] * flat[1]

    def norm_sq(self) -> torch.Tensor:
        return torch.sum(self.data.to(torch.float64) ** 2)

    def numpy(self) -> np.ndarray:
        """The planar data as a host ``float32[2, R, V]`` array."""
        return self.data.detach().cpu().numpy()


def _check_sizes(n: int, lanes: int) -> int:
    v = lanes.bit_length() - 1
    if (1 << v) != lanes:
        raise ValueError(f"lanes must be a power of two, got {lanes}")
    if n < v:
        raise ValueError(f"need n >= log2(lanes): n={n}, lanes={lanes}")
    return v


def zero_state(n: int, target: Target,
               device: str | torch.device = "cuda") -> State:
    """|0...0> in lane-tiled layout."""
    dev = resolve_device(device)
    v = _check_sizes(n, target.lanes)
    data = torch.zeros((2, 1 << (n - v), 1 << v), dtype=torch.float32,
                       device=dev)
    data[0, 0, 0] = 1.0
    return State(data=data, n=n, v=v)


def from_dense(psi, n: int, target: Target,
               device: str | torch.device = "cuda") -> State:
    """Layout adjustment: interleaved complex -> planar lane-tiled (paper
    §IV-A).  ``psi`` is a complex numpy array or tensor of ``2**n``
    entries."""
    dev = resolve_device(device)
    v = _check_sizes(n, target.lanes)
    psi = torch.as_tensor(psi).to(device=dev, dtype=torch.complex64)
    psi = psi.reshape(1 << n)
    planes = torch.stack([psi.real, psi.imag]).to(torch.float32)
    return State(data=planes.reshape(2, 1 << (n - v), 1 << v).contiguous(),
                 n=n, v=v)


def random_state(n: int, target: Target,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda") -> State:
    """Normalized Gaussian random state.  It cannot match the JAX package's
    ``jax.random`` draw; tests feed the same numpy ``psi`` to both packages
    through :func:`from_dense` instead."""
    dev = resolve_device(device)
    re = torch.randn(1 << n, generator=generator, dtype=torch.float32)
    im = torch.randn(1 << n, generator=generator, dtype=torch.float32)
    nrm = torch.sqrt(torch.sum(re * re + im * im))
    return from_dense(torch.complex(re / nrm, im / nrm), n, target,
                      device=dev)
