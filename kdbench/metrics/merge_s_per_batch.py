"""Device seconds per batch of the round's ``merge`` phase: the merge of the
scan's lists into the running ones (``_merge``), the leaves' exit and the
live flag. Stamps on the card's clock inside the captured round
(``SearchStats.phase_s``), every replay included, the gaps between the
phase's kernels too; the mean over the window's batches."""

PHASE = "merge"


def read(run):
    got = [dict(getattr(b.stats, "phase_s", ())).get(PHASE) for b in run.batches]
    return sum(got) / len(got) if got and None not in got else None
