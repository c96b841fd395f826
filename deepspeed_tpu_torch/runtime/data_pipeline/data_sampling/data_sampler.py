"""Curriculum-aware distributed batch sampler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_sampler.py``;
reference
``runtime/data_pipeline/data_sampling/data_sampler.py``
``DeepSpeedDataSampler``).

Each global step, samples whose difficulty ≤ the curriculum scheduler's
current difficulty are eligible; the sampler draws a deterministic
(seeded, epoch-reshuffled) global batch and yields THIS data-parallel
rank's slice of micro-batch indices. Works with the difficulty files
produced by :class:`DataAnalyzer`, or a plain difficulty array.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler


class DeepSpeedDataSampler:

    def __init__(self, total_samples: int, *, micro_batch_size: int,
                 data_parallel_rank: int, data_parallel_size: int,
                 gradient_accumulation_steps: int = 1,
                 curriculum_scheduler: Optional[CurriculumScheduler] = None,
                 difficulties: Optional[Sequence[int]] = None,
                 drop_last: bool = True, seed: int = 1234):
        self.total_samples = total_samples
        self.micro_batch_size = micro_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.gas = gradient_accumulation_steps
        self.global_batch_size = micro_batch_size * data_parallel_size * gradient_accumulation_steps
        self.curriculum = curriculum_scheduler
        self.difficulties = None if difficulties is None else np.asarray(difficulties)
        self.drop_last = drop_last
        self.seed = seed
        self.consumed_samples = 0
        self.global_steps = 0
        self.np_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.total_samples // self.global_batch_size if self.drop_last else \
            (self.total_samples + self.global_batch_size - 1) // self.global_batch_size

    def _eligible_indices(self) -> np.ndarray:
        if self.curriculum is None or self.difficulties is None:
            return np.arange(self.total_samples)
        difficulty = self.curriculum.update_difficulty(self.global_steps)
        eligible = np.nonzero(self.difficulties <= difficulty)[0]
        if len(eligible) < self.global_batch_size:
            # too few easy samples yet: fall back to the easiest global batch
            order = np.argsort(self.difficulties, kind="stable")
            eligible = order[:self.global_batch_size]
        return eligible

    def state_dict(self) -> Dict:
        return {
            "consumed_samples": self.consumed_samples,
            "global_steps": self.global_steps,
            "seed": self.seed,
            "curriculum_state": self.curriculum.get_state() if self.curriculum else None,
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.consumed_samples = sd["consumed_samples"]
        self.global_steps = sd["global_steps"]
        self.seed = sd.get("seed", self.seed)
        if self.curriculum is not None and sd.get("curriculum_state"):
            self.curriculum.set_state(sd["curriculum_state"])

    def __iter__(self) -> Iterator[List[int]]:
        # resume-aware: a checkpoint-restored sampler only yields the
        # REMAINING global batches of the epoch
        done = self.consumed_samples // self.global_batch_size
        for _ in range(max(0, len(self) - done)):
            eligible = self._eligible_indices()
            rng = np.random.default_rng(self.seed + self.global_steps)
            batch = rng.choice(eligible, size=self.global_batch_size,
                               replace=len(eligible) < self.global_batch_size)
            self.global_steps += 1
            self.consumed_samples += self.global_batch_size
            # this rank's slice, one micro-batch at a time
            for micro in range(self.gas):
                lo = micro * self.micro_batch_size * self.dp_size
                chunk = batch[lo:lo + self.micro_batch_size * self.dp_size]
                mine = chunk[self.dp_rank::self.dp_size]
                yield mine.tolist()
