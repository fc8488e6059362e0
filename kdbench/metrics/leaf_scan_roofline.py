"""The leaf-scan kernels' share of their roofline, in %: the fp32
operations the window's scans needed, (2d + 3) for each (query, row) pair
the kernel computes (``SearchStats.scan_pairs``, counted on the device,
graph replays included), at the card's fp32 peak, over the device time of
the ``leaf_scan_*`` kernels in the traced window.  The kernel is bound by
fp32 throughput (``kernels/csrc/leaf_scan.cu``), so the operations set the
bound; d is the cell's."""

PEAK_FLOPS = 67e12   # fp32 outside the tensor cores, one H100 SXM (NVIDIA's data sheet)
NAME = "leaf_scan_"


def read(run):
    if run.trace is None:
        return None
    pairs = sum(getattr(b.stats, "scan_pairs", 0) for b in run.batches)
    scan_s = sum(s for name, (_, s) in run.trace.kernels.items() if NAME in name)
    if not pairs or not scan_s:
        return None
    return 100.0 * pairs * (2 * int(run.cell.config["d"]) + 3) / (PEAK_FLOPS * scan_s)
