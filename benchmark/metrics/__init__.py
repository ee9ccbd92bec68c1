"""Per-layer metric readers, one module a metric: ``read(trace)`` takes a
``benchmark.trace.Trace`` and returns the metric's value, or None where it
finds nothing to read."""
