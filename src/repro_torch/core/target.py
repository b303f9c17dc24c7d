"""Hardware target descriptors — the VLA "vector length query" analogue.

The paper resolves ``numVals = VLEN / ELEN`` at run time from the SVE register
width.  Here the same decision is made on the host, before a plan is lowered,
from a target descriptor: the planar state is tiled by ``target.lanes`` (the
fp32 lane tile, numVals analogue) and the fusion-degree chooser reads the
roofline constants (machine balance adaptation, paper §IV-D).

:data:`H100` is the port's device.  :data:`CPU_TEST` and the ARM descriptors
are kept so that the port picks the same fusion degrees as the JAX package for
the same descriptor; the parity tests run on :data:`CPU_TEST`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Target:
    """A vector-width + memory-hierarchy descriptor of one platform."""

    name: str
    lanes: int                 # fp32 elements per vector tile (numVals analogue)
    sublanes: int              # second-minor tile dim (1 where there is none)
    vmem_bytes: int            # fast scratch capacity (SVE: L1; GPU: shared memory of a block)
    hbm_bw: float              # bytes/s main-memory bandwidth
    peak_flops_f32: float      # FLOP/s, fp32 vector units
    peak_flops_bf16: float     # FLOP/s, matrix units (0 if none)
    mxu_dim: int               # systolic tile (0 if no matrix unit)
    ici_bw: float              # bytes/s per interconnect link (0 = single chip)

    @property
    def machine_balance_f32(self) -> float:
        """FLOPs per byte at which fp32 compute and HBM bandwidth balance."""
        return self.peak_flops_f32 / self.hbm_bw

    @property
    def machine_balance_bf16(self) -> float:
        return (self.peak_flops_bf16 or self.peak_flops_f32) / self.hbm_bw

    @property
    def lane_qubits(self) -> int:
        """log2(lanes): number of state qubits resident in the lane axis."""
        q = self.lanes.bit_length() - 1
        if (1 << q) != self.lanes:
            raise ValueError(f"lanes must be a power of two, got {self.lanes}")
        return q


def row_budget(n: int, target: Target) -> int:
    """Row-qubit budget of an ``n``-qubit lane-tiled state: ``max(2, n -
    target.lane_qubits)``.

    The canonical statement of the rule — every fused-cluster width cap
    derives from it.  The planar layout ``f32[2, R, V]`` keeps the bottom
    ``lane_qubits`` state qubits in the lane axis, so only ``n -
    lane_qubits`` qubits live on addressable rows.  The floor of 2 keeps
    two-qubit gates fusable on tiny states.

    Callers (they must agree on one number):
    :func:`repro_torch.engine.plan.resolve_f` (general fused-cluster cap) and
    :func:`repro_torch.engine.plan.resolve_diag_f` (wide-diagonal cluster cap
    handed to ``cluster_gates(diag_f=...)``).
    """
    return max(2, n - target.lane_qubits)


# NVIDIA H100 SXM (NVIDIA's data sheet): 32 fp32 lanes = one warp and one
# 128-byte transaction; 232,448 bytes of shared memory for one block; 80 GB
# HBM3 at 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores (the port's
# kernels use plain fp32 FMA, so the fp32 rate is the one that bounds them);
# 989 TFLOP/s dense bf16 on the tensor cores; 450 GB/s NVLink each way.
# choose_f(H100) = 4.
H100 = Target(
    name="h100",
    lanes=32,
    sublanes=1,
    vmem_bytes=232448,
    hbm_bw=3.35e12,
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    mxu_dim=0,
    ici_bw=450e9,
)

# Small descriptor for CPU tests: an 8-lane tile, the "short vector machine"
# end of the VLA sweep.  choose_f lands on f=3.
CPU_TEST = Target(
    name="cpu_test",
    lanes=8,
    sublanes=8,
    vmem_bytes=1 * 2**20,
    hbm_bw=20e9,
    peak_flops_f32=0.05e12,
    peak_flops_bf16=0.0,
    mxu_dim=0,
    ici_bw=0.0,
)

# ARM descriptors of the paper's platforms (lanes = numVals; achievable, not
# peak, FLOP/s).
ARM_GRACE = Target("arm_grace", 4, 1, 64 * 2**10, 380e9, 2.0e12, 0.0, 0, 0.0)
ARM_GRAVITON3 = Target("arm_graviton3", 8, 1, 64 * 2**10, 307.2e9, 1.2e12, 0.0, 0, 0.0)
ARM_A64FX = Target("arm_a64fx", 16, 1, 64 * 2**10, 1024e9, 3.4e12, 0.0, 0, 0.0)

TARGETS = {
    t.name: t
    for t in (H100, CPU_TEST, ARM_GRACE, ARM_GRAVITON3, ARM_A64FX)
}


def get_target(name: str) -> Target:
    try:
        return TARGETS[name]
    except KeyError:
        raise KeyError(f"unknown target {name!r}; have {sorted(TARGETS)}") from None
