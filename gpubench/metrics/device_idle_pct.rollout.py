"""The card's idle share in the traced calls of a rollout cell: the traced
window less the union of device activity, over the window, in %; over
several cards, the mean of theirs."""


def read(run):
    return run.idle_pct()
