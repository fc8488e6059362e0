"""The benchmark of ``repro_torch``: exact kNN over a seeded catalogue on
the cards a cell asks for.

One command runs one cell (a configuration under a traffic mix, named in
``BENCHMARK.json`` at the repository root) once and prints one JSON line::

    python3 kdbench/run.py --workload sdss_psf_d10.batch_jit --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``.  ``data/`` makes the
points and queries from the seed, ``reference/`` is the plain brute force
that ``check.py`` judges the answers against, ``trace.py`` reduces the
profiler's events.  Nothing here imports ``jax``, ``jaxlib`` or ``repro``;
``reference/`` does not import ``repro_torch`` either.
"""
