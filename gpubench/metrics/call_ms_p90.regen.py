"""The 90th percentile of all the window's call times on a regen cell (host
clock), in ms: a launch-bound refresh follows the shared host's launch
rate, so this tail is a per-layer reading there."""


def read(run):
    return run.call_ms(90)
