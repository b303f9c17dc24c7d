from repro_torch.kernels.apply_gate.ops import (  # noqa: F401
    apply_fused_gate, apply_phase_gate)
from repro_torch.kernels.apply_gate.ref import (  # noqa: F401
    apply_fused_gate_ref, apply_phase_gate_ref)
