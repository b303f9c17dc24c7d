"""Hand-written CUDA kernels of the port, one per Pallas kernel of the JAX
package, each with its plain PyTorch version beside it.

* ``apply_gate.ops.apply_fused_gate``  — fused dense gate (``csrc/apply_gate.cu``)
* ``apply_gate.ops.apply_phase_gate``  — diagonal/permutation gate (``csrc/phase_gate.cu``)
* ``expectation.ops.expectation_z``    — ``<Z_q>`` reduction (``csrc/expectation.cu``)

The kernels are built at their first launch (``_build.py``).
"""
from repro_torch.kernels.apply_gate.ops import (  # noqa: F401
    FUSED, PHASE, apply_fused_gate, apply_phase_gate)
from repro_torch.kernels.apply_gate.ref import (  # noqa: F401
    apply_fused_gate_ref, apply_phase_gate_ref)
from repro_torch.kernels.expectation.ops import (  # noqa: F401
    EXPECT, expectation_z, expectation_z_ref)

KERNELS = {"apply_fused_gate": FUSED, "apply_phase_gate": PHASE,
           "expectation_z": EXPECT}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel in this process since the last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
