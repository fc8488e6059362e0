"""Kernels the device ran per round, on every card of the cell: the
profiler's kernel events in the traced window (graph-replayed kernels
included) over the window's rounds (``SearchStats.iterations``)."""


def read(run):
    rounds = sum(b.stats.iterations for b in run.batches)
    if run.trace is None or not rounds or not run.trace.kernel_launches:
        return None
    return run.trace.kernel_launches / rounds
