"""Zernike-Gradient lens calibration — the analogue of the reference's
ExampleDistortionModel (example/ExampleDistortionModel.java:58-187):
the polynomial radial model is zeroed and fixed, c is fixed at 28 (because
of its correlation with Z(4)), and radially symmetric Zernike terms of
Fringe orders 4, 12, 24, 40, 60 are estimated instead.

Usage: python examples/example_distortion_model.py [basepath]
"""

import sys
import time

sys.path.insert(0, ".")

# Parity examples run double precision on the backend JAX picks
# (JAX_PLATFORMS=cpu selects the CPU).
import jax

jax.config.update("jax_enable_x64", True)

from bundle_adjustment_tpu import BundleAdjustment
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
    camera = read_ior(base + ".ior", (DistortionType.ZERNIKE_GRADIENT,))

    # fix c = 28 (correlation with Z(4); ExampleDistortionModel.java:82-84)
    camera.io.c.value = 28.0
    camera.io.c.fixed = True

    # zero + fix the polynomial radial model
    for p in camera.distortion(DistortionType.RADIAL_DISTORTION):
        p.value = 0.0
        p.fixed = True

    # radially symmetric Zernike terms: Fringe orders 4, 12, 24, 40, 60
    zernike = camera.distortion(DistortionType.ZERNIKE_GRADIENT)
    order = 0
    for i in range(1, 6):
        order += i * 4
        zernike.add(order)

    read_eor(base + ".eor", camera)
    read_phc(base + ".phc", camera, coordinates)

    adjustment = BundleAdjustment()
    adjustment.add(camera)
    for sb in scale_bars:
        adjustment.add(sb)

    for image in camera:
        for ic in image:
            if len(ic.object_coordinate.name) > 3:
                ic.object_coordinate.set_datum(False)

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
