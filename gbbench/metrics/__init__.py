"""Per-layer metric readers, one file a metric, named as the metric.

Each has ``read(readings)`` (``run.Readings``) and returns a number, or None
when the run gave it nothing to read (the harness then leaves the metric out).
"""
