"""bundle_adjustment_tpu — accelerator-native rigorous bundle adjustment.

A from-scratch JAX/XLA re-design of the capabilities of the reference
JAICOV library (applied-geodesy/bundle-adjustment): rigorous least-squares
bundle adjustment for close-range photogrammetry with full stochastic
modelling — fully populated observation dispersion matrices and the fully
populated posterior dispersion of all estimated parameters, free-network
datum via rank-defect analysis and inner (Helmert) constraints.

Compute path: jit-compiled residuals/Jacobians (forward-mode AD of the
collinearity + distortion forward model), batched normal-equation assembly,
batched EO-block Schur complement, device meshes via jax.sharding for scale.
"""

from .constants import DEFAULT_MAX_ITERATIONS, EPS, SQRT_EPS
from .models.distortion import DistortionSpec, DistortionType
from .models.scene import (
    Camera,
    DirectlyObservedParameterGroup,
    DirectObservation,
    Image,
    ObjectCoordinate,
    Parameter,
    ScaleBar,
)
from .solver.adjustment import (
    BundleAdjustment,
    EstimationState,
    EstimationType,
    MatrixInversion,
)

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: the scale driver pulls in the whole parallel package
    if name == "ScaleBundleAdjustment":
        from .parallel.solver import ScaleBundleAdjustment

        return ScaleBundleAdjustment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BundleAdjustment",
    "ScaleBundleAdjustment",
    "Camera",
    "DistortionSpec",
    "DistortionType",
    "DirectObservation",
    "DirectlyObservedParameterGroup",
    "EstimationState",
    "EstimationType",
    "Image",
    "MatrixInversion",
    "ObjectCoordinate",
    "Parameter",
    "ScaleBar",
    "EPS",
    "SQRT_EPS",
    "DEFAULT_MAX_ITERATIONS",
]
