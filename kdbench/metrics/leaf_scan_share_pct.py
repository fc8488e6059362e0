"""Device time of the leaf-scan library's kernels (``leaf_scan_*`` by
name) over the cards' busy time in the traced window, in %."""

NAME = "leaf_scan_"


def read(run):
    if run.trace is None:
        return None
    scan = sum(s for name, (_, s) in run.trace.kernels.items() if NAME in name)
    busy = sum(run.trace.busy_s.values())
    return 100.0 * scan / busy if scan and busy else None
