"""Host reads that chunked regen waits on the card for, a call (the
program's counter `chunked_regen.host_syncs`)."""


def read(run):
    return run.per_call("chunked_regen.host_syncs")
