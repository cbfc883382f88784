"""Device ms per tick in matrix-product kernels (names matching "gemm":
cuBLAS's f32 products and CUTLASS's sgemm), the calls' inits included."""
import re


def read(run):
    s = sum(row[1] for k, row in run.record.rows.items()
            if re.search("gemm", k, re.I))
    if not s or not run.ticks:
        return None
    return 1e3 * s / run.ticks
