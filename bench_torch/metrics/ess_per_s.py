"""Effective samples per second: the sum over every fit in the window of its
mean multi-chain ESS of the reported parameter, over the sum of those fits'
wall times."""


def read(run):
    return sum(run.ess) / sum(run.walls) if run.walls else None
