"""Benchmark: batched EO-block Schur complement throughput (GFLOP/s).

The parity-path flagship kernel (ops/schur.reduce_eo) is dominated by the
dense update S = N11 - W @ N12^T with W = N12 * blockdiag(inv N22) — a
matmul of shape [nR, 6M] x [6M, nR].  This bench measures its sustained
f32 GFLOP/s on one device (batched 6x6 inversions included).

Prints ONE JSON line:
  {"metric": "schur_gflops_per_chip", "value": N, "unit": "GFLOP/s",
   "vs_baseline": N / java_gflops, "device": {...}}
"device" holds the platform, device_kind and device count as JAX reports
them and each card's name and power limit from nvidia-smi.
The baseline denominator credits the reference's scalar per-image loops
(BundleAdjustment.java:1197-1342, single-threaded JVM) with 2 GFLOP/s —
generous for packed triple-loop Java.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu import device
    from bundle_adjustment_tpu.ops.schur import reduce_eo

    nR = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    M = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    dtype = jnp.float32

    rng = np.random.default_rng(0)
    T = nR + 6 * M
    # synthetic SPD-ish bordered system
    A = rng.normal(size=(T, T)).astype(np.float32) * 0.01
    N = jnp.asarray(A @ A.T + np.eye(T, dtype=np.float32) * 10)
    n = jnp.asarray(rng.normal(size=T).astype(np.float32))
    col_eo = jnp.asarray(
        (nR + np.arange(6 * M)).reshape(M, 6).astype(np.int32))

    f = jax.jit(lambda N, n: reduce_eo(N, n, col_eo, nR))
    out = f(N, n)
    jax.block_until_ready(out.S)

    reps = 10
    t0 = time.time()
    for _ in range(reps):
        out = f(N, n)
    jax.block_until_ready(out.S)
    dt = (time.time() - t0) / reps

    # dominant flops: W = N12 @ blockdiag (nR*M*6*6*2) + S -= W N12^T
    # (nR*nR*6M*2) + batched inverses (~M * 6^3 * 2)
    flops = 2 * nR * nR * 6 * M + 2 * nR * M * 36 + 2 * M * 216
    gflops = flops / dt / 1e9
    print(f"reduce_eo nR={nR} M={M}: {dt*1000:.1f} ms -> {gflops:.0f} GFLOP/s",
          file=sys.stderr)

    print(json.dumps({
        "metric": f"schur_gflops_per_chip_nr{nR}_m{M}",
        "value": round(gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / 2.0, 1),
        "device": device.describe(),
    }))


if __name__ == "__main__":
    main()
