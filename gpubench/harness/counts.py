"""The work the kernels and the train step must do, counted from a cell's
shapes with the program's constants frozen at their values: the bytes and
operations that the rooflines and `train.mfu_pct` divide by."""

NUM_REGS = 42  # registers a lane
HIDDEN = 256  # the torso's width
HEAD_ROWS = 8  # the actor's rows and the critic's, padded


def state_bytes(hw: int, b: int, t: int) -> int:
    """A rollout call's state: words and registers in and out and the
    templates in, one action (or seed) a lane-step in, three int32 sums a
    lane out."""
    return 4 * (3 * hw * b + 3 * NUM_REGS * b + t * b) + 12 * b


def weight_bytes(v: int) -> int:
    """The model's weights: the bf16 torso and the f32 head rows."""
    return HIDDEN * v * v * 20 * 2 + HIDDEN * HIDDEN * 2 + 2 * HIDDEN * 2 + HEAD_ROWS * (HIDDEN + 1) * 4


def spill_rows(v: int) -> int:
    """Rows a lane-step of the trajectory spill: the view, five more, padded
    to eight."""
    return ((v * v + 5 + 7) // 8) * 8


def policy_flop(v: int) -> int:
    """The forward a sample: one W1 row of 256 adds per channel of each
    view cell, the 256 x 256 product, the head."""
    return 3 * v * v * HIDDEN + 2 * HIDDEN * HIDDEN + 2 * HEAD_ROWS * HIDDEN


def model_flop(v: int) -> int:
    """The forward once (layer 1 by its 3·V² active one-hot rows), the
    head, and the backward products dWa, Wa^T·dhead, dW2, W2^T·dh2 and
    dW1, a sample: 480,768 at V = 7. It counts no recompute."""
    h, k = HIDDEN, 3 * v * v
    return (k * h + 2 * h * h + 2 * HEAD_ROWS * h) + (4 * HEAD_ROWS * h + 4 * h * h + k * h)


def b2_counts(hw: int, v: int, b: int, t: int):
    """(bytes, operations) of one collecting call of the policy kernel."""
    return state_bytes(hw, b, t) + weight_bytes(v) + 4 * spill_rows(v) * b * t, policy_flop(v) * b * t


def b3_counts(v: int, b: int, t: int):
    """(bytes, operations) of the gradient kernel over a trajectory: each
    sample's obs words, action, advantage and return read once, the
    weights read and their gradients written; `model_flop` a sample."""
    return 4 * (v * v + 3) * b * t + 2 * weight_bytes(v), model_flop(v) * b * t
