"""One reader a metric, found by the metric's name: ``read(run, log)``
returns its value, or None where the run holds nothing to read (the
harness then leaves the metric out of the line; ``log`` says why)."""
