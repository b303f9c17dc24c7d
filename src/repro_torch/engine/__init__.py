"""Batched parameterized-circuit execution engine (single device).

Templates split circuits into static structure + parameter vector, plans
compile each structure once per backend, and the batch executor runs plans
over parameter sweeps with the batch axis carried through every kernel,
handing back states or, with a result spec, shots, Pauli expectations or
noisy-trajectory expectations.
"""
from repro_torch.engine.template import (  # noqa: F401
    CircuitTemplate, TemplateOp, fixed_op, template_of,
    qaoa_template, hea_template, PARAM_KINDS,
)
from repro_torch.engine.plan import (  # noqa: F401
    BACKENDS, CompiledPlan, PlanCache, PlanItem, CacheStats, compile_plan,
    resolve_f, resolve_diag_f, PARAM_OP_CLASS, GLOBAL_PLAN_CACHE,
)
from repro_torch.engine.results import (  # noqa: F401
    MODE_EXPECTATION, MODE_NOISY, MODE_SHOTS, MODE_STATEVECTOR, NoiseChannel,
    ResultSpec, amplitude_damping, bit_flip, depolarizing, phase_flip,
)
from repro_torch.engine.telemetry import (  # noqa: F401
    Histogram, VectorizationProfile, vectorization_profile,
)
from repro_torch.engine.batch import BatchExecutor  # noqa: F401
