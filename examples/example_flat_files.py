"""Flat-file pipeline with a fully populated observation dispersion matrix —
the analogue of the reference's ExampleFlatFiles
(example/ExampleFlatFiles.java:67-233).

Usage: python examples/example_flat_files.py [basepath]
"""

import sys
import time

sys.path.insert(0, ".")

# Parity examples run double precision on the backend JAX picks
# (JAX_PLATFORMS=cpu selects the CPU).
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

from bundle_adjustment_tpu import (
    BundleAdjustment,
    DirectObservation,
    DirectlyObservedParameterGroup,
)
from bundle_adjustment_tpu.io.readers import (
    read_eor,
    read_ior,
    read_obc,
    read_phc,
    read_scale,
)
from bundle_adjustment_tpu.models.distortion import DistortionType
from bundle_adjustment_tpu.solver.adjustment import (
    EstimationState,
    EstimationType,
    MatrixInversion,
)

from common import print_listener, print_results


def main():
    base = sys.argv[1] if len(sys.argv) > 1 else \
        "/root/reference/JAICOV/example/example"
    t = time.time()

    coordinates = read_obc(base + ".obc")
    scale_bars = read_scale(base + ".scale", coordinates)
    camera = read_ior(base + ".ior")

    # fix some interior orientation parameters (ExampleFlatFiles.java:87-94)
    camera.distortion(DistortionType.RADIAL_DISTORTION).get(3).fixed = True
    camera.distortion(DistortionType.AFFINITY_AND_SHEAR).cx.fixed = True
    camera.distortion(DistortionType.AFFINITY_AND_SHEAR).cy.fixed = True

    read_eor(base + ".eor", camera)
    read_phc(base + ".phc", camera, coordinates)

    # observed datum coordinates with a random fully populated SPD dispersion
    # (demonstration stochastic model, :129-141)
    rng = np.random.default_rng()
    sigma0 = 0.001
    observed = []
    for image in camera:
        for ic in image:
            oc = ic.object_coordinate
            if len(oc.name) > 3:
                oc.set_datum(False)
            if oc.datum:
                oc.set_datum(False)
                observed.append(DirectObservation(oc.x, oc.x.value, 1.0, "OBJ_X", oc))
                observed.append(DirectObservation(oc.y, oc.y.value, 1.0, "OBJ_Y", oc))
                observed.append(DirectObservation(oc.z, oc.z.value, 1.0, "OBJ_Z", oc))
    n = len(observed)
    U = rng.normal(0, sigma0, (n, n))
    dispersion = U.T @ U
    group = DirectlyObservedParameterGroup(observed, dispersion)

    adjustment = BundleAdjustment()
    adjustment.add(camera)
    for sb in scale_bars:
        adjustment.add(sb)
    adjustment.add(group)

    adjustment.add_property_change_listener(print_listener)
    adjustment.set_estimation_type(EstimationType.L2NORM)
    adjustment.set_invert_normal_equation(MatrixInversion.REDUCED)

    status = adjustment.estimate_model()
    if status != EstimationState.ERROR_FREE_ESTIMATION:
        print("Error, bundle adjustment fails...", file=sys.stderr)
        return 1

    print("Bundle adjustment finished successfully...")
    print_results(adjustment, [camera],
                  datum_char=lambda oc: "n" if len(oc.name) > 3 else "o")
    print(f"Estimation time:                  {time.time() - t:.3f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
