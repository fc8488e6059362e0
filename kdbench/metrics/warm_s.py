"""Seconds of ``KNNIndex.warm`` in the run's set-up: the program's last
``warm`` span (the jit engine's eager round and the capture of its CUDA
graph, ``warm.capture``, inside it)."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    warm = [s.seconds for s in tracing.spans() if s.name == "warm"]
    return warm[-1] if warm else None
