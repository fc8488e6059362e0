"""Share of the leaf scan's (query, row) pairs that are real, in %: the
pairs of placed queries with the real rows of their leaves
(``SearchStats.useful_pairs``) over the pairs the kernel computes, every
occupied plan unit's TQ slots times L_pad rows (``scan_pairs``; an empty
slot scans a zero query), summed over the window's batches."""


def read(run):
    useful = sum(getattr(b.stats, "useful_pairs", 0) for b in run.batches)
    scanned = sum(getattr(b.stats, "scan_pairs", 0) for b in run.batches)
    return 100.0 * useful / scanned if useful and scanned else None
