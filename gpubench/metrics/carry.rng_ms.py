"""The key-chain replay of a static-layout call (`_replay_rng_chain`): ms a
call between the program's `kernel` and `rng` marks (CUDA events); its
`.item()` holds the host, so the span also holds the gaps while the host
launches the replay's ops."""


def read(run):
    return run.piece_ms("rng")
