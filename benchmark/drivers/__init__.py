"""One engine per kind of cell, found by the `engine` of the cell's
workload file: `drivers/<engine>.py` with `measure(ctx, tracer)` and `check(ctx)`."""
