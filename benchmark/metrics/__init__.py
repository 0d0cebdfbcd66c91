"""One reader per per-layer metric, found by the metric's name:
`metrics/<name>.py` with `read(run) -> float | None`. A reader that finds
nothing to read returns None and the metric is left out of the line."""
