"""One reader a per-layer metric: `metrics/<name>.py` defines
`read(trace) -> float | None` over a tracing.Trace.  A reader that finds
nothing to read returns None, and the run leaves the metric out."""
