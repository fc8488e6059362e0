"""Seconds of the host tree build in the run's set-up: the program's
``build.tree`` spans under its last ``build`` span (``KNNIndex.build``)."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    builds = [s for s in spans if s.name == "build"]
    if not builds:
        return None
    tree = [s.seconds for s in spans if s.name == "build.tree" and s.call == builds[-1].call]
    return sum(tree) if tree else None
