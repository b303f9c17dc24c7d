from repro_torch.kernels.expectation.ops import (  # noqa: F401
    expectation_z, expectation_z_ref)
