"""Device seconds per batch of the round's ``plan`` phase: the work plan
(``_build_plan``'s sort, cumulative max and scatters, and the round's
counts). Stamps on the card's clock inside the captured round
(``SearchStats.phase_s``), every replay included, the gaps between the
phase's kernels too; the mean over the window's batches."""

PHASE = "plan"


def read(run):
    got = [dict(getattr(b.stats, "phase_s", ())).get(PHASE) for b in run.batches]
    return sum(got) / len(got) if got and None not in got else None
