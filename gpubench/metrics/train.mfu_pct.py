"""The whole train step's share of the card's bf16 peak: the model's
operations a sample (`counts.model_flop`), times the samples a second
through the window, over 989 TFLOP/s a card."""

from gpubench.harness.counts import model_flop
from gpubench.harness.stats import BF16_FLOP_PER_S


def read(run):
    return 100.0 * model_flop(run.cell.config["view"]) * run.rate() / (BF16_FLOP_PER_S * run.cell.chips)
