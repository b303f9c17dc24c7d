"""Core: the paper's VLA quantum state-vector simulation on PyTorch."""
from repro_torch.core.target import (  # noqa: F401
    Target, H100, CPU_TEST, get_target, row_budget,
)
from repro_torch.core.statevec import (  # noqa: F401
    State, zero_state, from_dense, random_state, resolve_device,
)
from repro_torch.core.gates import Gate  # noqa: F401
from repro_torch.core.circuits import (  # noqa: F401
    Circuit, build, build_circuit, qaoa, hardware_efficient,
)
from repro_torch.core.fusion import (  # noqa: F401
    fuse_circuit, choose_f, cluster_gates, realize_cluster, ClusterSpec,
)
from repro_torch.core.simulator import Simulator  # noqa: F401
