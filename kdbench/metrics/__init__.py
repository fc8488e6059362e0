"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric.  Each has ``read(run) -> float | None``
(``run`` is ``kdbench.harness.Run``) and returns None where it finds
nothing to read, so the harness leaves the metric out of the line."""
