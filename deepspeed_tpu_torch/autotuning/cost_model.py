"""Learned cost model steering the autotuner's measure phase (counterpart
of ``deepspeed_tpu/autotuning/cost_model.py``, copied: host numpy only;
reference ``deepspeed/autotuning/tuner/model_based_tuner.py`` +
``tuner/cost_model.py``, which fit an XGBoost regressor). The JAX
features for the layer-scan and flash-block axes are left out: the port
searches neither (``autotuning/config.py``).

The search space is small and smooth (stage, log-micro-batch, remat
policy, loss chunk), so a ridge-regularised linear least-squares model
over ordinal features gives the same predict-then-measure loop with no
extra dependency.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_REMAT_ORD = {"none": 0.0, False: 0.0, "dots": 1.0, "selective": 2.0,
              "full": 3.0, True: 3.0}


def featurize(cand, est_bytes: int) -> List[float]:
    """Ordinal feature vector for one candidate (bias term included)."""
    return [
        1.0,
        float(cand.stage),
        float(np.log2(max(1, cand.micro_batch))),
        _REMAT_ORD.get(cand.remat, 1.5),
        float(np.log2(cand.loss_chunk + 1)),
        est_bytes / float(1024**3),
    ]


class CostModel:
    """Ridge-regularised least squares: refit after every measurement."""

    def __init__(self, l2: float = 1e-3):
        self.l2 = l2
        self._w = None

    def fit(self, feats: Sequence[Sequence[float]], metrics: Sequence[float]) -> None:
        X = np.asarray(feats, np.float64)
        y = np.asarray(metrics, np.float64)
        A = X.T @ X + self.l2 * np.eye(X.shape[1])
        self._w = np.linalg.solve(A, X.T @ y)

    def predict(self, feats: Sequence[Sequence[float]]) -> np.ndarray:
        if self._w is None:
            raise RuntimeError("CostModel.predict before fit")
        return np.asarray(feats, np.float64) @ self._w
