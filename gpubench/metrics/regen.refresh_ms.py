"""Chunked regen's chain advance and template refresh: ms a call summed
over the chunks' `refresh` pieces (the program's marks, CUDA events)."""


def read(run):
    return run.piece_ms("refresh")
