"""Early stopping with the reference's patience semantics (counterpart of
``mural_tpu/train/early_stopping.py``): the counter increments whenever
the score (-val_loss) fails to beat the best by > delta; stop at
patience."""

from __future__ import annotations


class EarlyStopping:
    def __init__(self, patience: int = 7, verbose: bool = False,
                 delta: float = 0.0, trace_func=print):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = float("inf")
        self.trace_func = trace_func

    def __call__(self, val_loss: float) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self._improved(val_loss)
        elif score < self.best_score + self.delta:
            self.counter += 1
            self.trace_func(
                f"EarlyStopping counter: {self.counter} out of "
                f"{self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self._improved(val_loss)
            self.counter = 0

    def _improved(self, val_loss: float) -> None:
        if self.verbose:
            self.trace_func(
                f"Validation loss decreased ({self.val_loss_min:.6f} --> "
                f"{val_loss:.6f}).  Saving model ...")
        self.val_loss_min = val_loss
