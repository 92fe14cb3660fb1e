"""The 90th percentile of all the window's call times (host clock, each
call ending at `torch.cuda.synchronize()`), in ms."""


def read(run):
    return run.call_ms(90)
