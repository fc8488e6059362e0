"""Seconds in which a card ran something, per batch: the union of its
kernel, copy and fill intervals in the traced window, the mean over the
cell's cards, over the window's batches.  It divides by batches, not by
the traced window's length, which the profiler's host work stretches."""


def read(run):
    if run.trace is None or not run.trace.busy_s or not run.batches:
        return None
    busy = [run.trace.busy_s.get(i, 0.0) for i in range(run.cell.chips)]
    return sum(busy) / len(busy) / len(run.batches)
