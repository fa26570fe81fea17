from pde_inverse.density.flows import (
    MaskedNormalizingFlow,
    TimeConditionedLogDensity,
    build_realnvp,
)
from pde_inverse.density.estimation import estimate_log_density
