"""Share of the traced window in which a card ran nothing: 1 - (union of
its kernel, copy and fill intervals) / window, the mean over the cell's
cards, in %.  The window is the traced one, which the profiler's host work
stretches where the host sets the pace (``device_busy_s_per_batch`` beside
it is not divided by the window)."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    busy = [run.trace.busy_s.get(i, 0.0) for i in range(run.cell.chips)]
    return 100.0 * (1.0 - sum(busy) / len(busy) / run.window_s)
