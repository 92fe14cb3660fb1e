"""Env-steps a second on a random-layout family in regen mode: B·T of
every call of the window over the window's host seconds."""


def read(run):
    return run.rate()
