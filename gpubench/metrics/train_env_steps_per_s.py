"""Env-steps a second through the fused train step: B·T of every step of
the window over the window's host seconds, all cards together."""


def read(run):
    return run.rate()
