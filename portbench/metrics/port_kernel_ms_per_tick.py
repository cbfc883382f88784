"""Device ms per tick in the port's own CUDA kernels (by their symbols,
`harness.trace.KERNEL_SYMBOLS`), the calls' inits included."""
from harness.trace import KERNEL_SYMBOLS, symbol_matches


def read(run):
    s = sum(row[1] for k, row in run.record.rows.items()
            if any(symbol_matches(p, k) for p in KERNEL_SYMBOLS.values()))
    if not s or not run.ticks:
        return None
    return 1e3 * s / run.ticks
