"""Rounds of the round loop per batch, as the facade reports them
(``SearchStats.iterations``; the forest's largest over its cards), the
mean over the traced window's batches."""


def read(run):
    rounds = [b.stats.iterations for b in run.batches]
    return sum(rounds) / len(rounds) if rounds and all(rounds) else None
