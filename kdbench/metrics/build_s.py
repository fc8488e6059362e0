"""Seconds of ``KNNIndex.build`` (planner, host tree build, leaf store on
the cards), host clock ending in a synchronize of every card."""


def read(run):
    return run.build_s
