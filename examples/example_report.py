"""Full pipeline from an AICON 3D Studio adjustment report — the analogue of
the reference's ExampleReport (example/ExampleReport.java:52-160).

Usage: python examples/example_report.py [path/to/example.htm]
"""

import sys
import time

sys.path.insert(0, ".")

# Parity examples run double precision on the backend JAX picks
# (JAX_PLATFORMS=cpu selects the CPU).
import jax

jax.config.update("jax_enable_x64", True)

from bundle_adjustment_tpu.io.readers import read_aicon_report
from bundle_adjustment_tpu.solver.adjustment import (
    EstimationState,
    EstimationType,
    MatrixInversion,
)

from common import print_listener, print_results


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        "/root/reference/JAICOV/example/example.htm"
    t = time.time()

    adjustment, reader = read_aicon_report(path)

    # datum selection: coded targets (short names) define the frame datum
    for camera in reader.cameras.values():
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
    print_results(adjustment, list(reader.cameras.values()))
    print(f"Estimation time:                  {time.time() - t:.3f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
