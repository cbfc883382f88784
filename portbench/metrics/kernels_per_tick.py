"""Device operations in the trace per tick traced (the calls' inits
included)."""


def read(run):
    n = sum(row[0] for row in run.record.rows.values())
    if not n or not run.ticks:
        return None
    return n / run.ticks
