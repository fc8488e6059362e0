"""Host seconds per batch after the round loop: the program's spans
``query.rescore`` (ending in a synchronize), ``query.readback`` (device to
host), ``query.certify`` and ``query.brute`` (the rows the certificate
leaves to brute force) of the window's batches (the spans whose ``call``
is a batch's ``SearchStats.call``), over those batches."""

STEPS = ("query.rescore", "query.readback", "query.certify", "query.brute")


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    calls = {getattr(b.stats, "call", 0) for b in run.batches} - {0}
    spent = sum(s.seconds for s in tracing.spans() if s.call in calls and s.name in STEPS)
    return spent / len(calls) if calls and spent else None
