"""Host-side learning-rate control (``multi_modal_gnn_tpu/training/schedulers.py``).

The trainer writes the returned rate into the optimizer's param groups;
semantics follow torch's schedulers as the JAX package configures them.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """min-mode plateau scheduler: lr *= factor after ``patience`` epochs
    without relative improvement > threshold (torch defaults)."""

    def __init__(
        self,
        init_lr: float,
        factor: float = 0.5,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = float(init_lr)
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_lr = float(min_lr)
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record an epoch's validation metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


class StepLR:
    """lr *= gamma every ``step_size`` epochs."""

    def __init__(self, init_lr: float, step_size: int = 30, gamma: float = 0.1):
        self.init_lr = float(init_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.epoch = 0
        self.lr = float(init_lr)

    def step(self, metric: float | None = None) -> float:
        self.epoch += 1
        self.lr = self.init_lr * (self.gamma ** (self.epoch // self.step_size))
        return self.lr


class ConstantLR:
    def __init__(self, init_lr: float):
        self.lr = float(init_lr)

    def step(self, metric: float | None = None) -> float:
        return self.lr


def build_scheduler(train_config) -> object:
    """From :class:`~multi_modal_gnn_tpu_torch.config.TrainConfig` to a
    scheduler instance."""
    lr = train_config.optimizer.lr
    sc = train_config.lr_scheduler
    if not sc.enabled:
        return ConstantLR(lr)
    if sc.type == "reduce_on_plateau":
        return ReduceLROnPlateau(
            lr, factor=sc.factor, patience=sc.patience, threshold=sc.threshold, min_lr=sc.min_lr
        )
    if sc.type == "step":
        return StepLR(lr, step_size=sc.step_size, gamma=sc.gamma)
    raise ValueError(f"Unknown scheduler type: {sc.type}")
