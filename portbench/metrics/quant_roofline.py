"""Share (%) of their HBM roofline that quantize_rows and dequantize_rows
reach, timed alone at one row of every leaf of the cell's tree: the sum of
the bounds (5 bytes a number and a 4-byte scale at 3.35 TB/s) over the
sum of the times."""


def read(run):
    if not run.quant:
        return None
    return 100.0 * sum(q[3] for q in run.quant) / sum(q[2] for q in run.quant)
