"""Share of the round loop's query slots that did work, in %: the queries
placed into a round's plan (``SearchStats.leaf_visits``, counted on the
device in every round, graph replays included) over the batch's m queries
times the rounds run (``steady_rounds``, the replays past the fixed point
included), summed over the window's batches.  Every round runs at the full
batch's shape, so the rest is work on queries that have retired."""


def read(run):
    visits = sum(getattr(b.stats, "leaf_visits", 0) for b in run.batches)
    slots = sum(b.m * getattr(b.stats, "steady_rounds", 0) for b in run.batches)
    return 100.0 * visits / slots if visits and slots else None
