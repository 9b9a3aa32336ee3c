"""Model FLOPs of the sites a genome-wide map completes per second, as a
share of the card's float32 peak: the forward's FLOPs per site, counted
from the configuration's shapes, times the traced run's sites per
second (taken over its whole window, which the profiler slows a little),
over 67 TFLOP/s."""

from harness import flops


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    return (100.0 * flops.forward_flops(cell.config) * outcome.facts["rate"]
            / flops.F32_FLOP_PER_S)
