"""Progressive layer dropping (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``; reference
``deepspeed/runtime/progressive_layer_drop.py``).

Keeps a theta value that decays toward ``theta`` over training; a model
that supports PLD reads ``get_theta()`` and skips layers stochastically.
As in the JAX package, the engine constructs it but never calls
``update_state``, and no model of either package reads theta: it moves
only when the user calls ``engine.progressive_layer_drop.update_state(step)``.
"""

from __future__ import annotations

import numpy as np


class ProgressiveLayerDrop:

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
