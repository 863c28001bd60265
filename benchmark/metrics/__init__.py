"""One reader a metric, named as in BENCHMARK.json: ``read(run)`` takes the
harness's ``Run`` and returns the metric's value, or None where the run has
nothing to read it from (the harness then leaves the metric out)."""
