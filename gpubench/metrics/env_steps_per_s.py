"""Env-steps a second on a static or cached layout: B·T of every call of
the window over the window's host seconds."""


def read(run):
    return run.rate()
