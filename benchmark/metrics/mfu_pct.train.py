"""Model FLOPs of the windows a train cell trains per second, as a share
of the card's float32 peak: a training step's FLOPs per window (forward,
weight and data gradients), counted from the configuration's shapes,
times the traced run's windows per second, over 67 TFLOP/s."""

from harness import flops


def read(outcome, cell):
    if outcome.facts.get("kind") != "train":
        return None
    return (100.0 * flops.train_flops(cell.config) * outcome.facts["rate"]
            / flops.F32_FLOP_PER_S)
