"""Learning-rate schedules, port of train/schedulers.py (plain Python).

  * cosine:  the learning rate at a step of a cosine annealing from the base
    rate to eta_min=1e-5 over max_steps, stepped every iteration.
  * plateau: ReduceLROnPlateau(mode='min', patience=100, factor=0.5) stepped
    on the validation loss, a small host-side controller (threshold 1e-4,
    relative).

The Trainer writes the rate these give into every param group of its
torch optimizer.
"""

import math


def cosine_lr(step: int, base_lr: float, max_steps: int, eta_min: float = 1e-5) -> float:
    t = min(step, max_steps)
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / max_steps)) / 2


class ReduceLROnPlateau:
    def __init__(self, base_lr: float, patience: int = 100, factor: float = 0.5,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = base_lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        """Record a validation metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])
