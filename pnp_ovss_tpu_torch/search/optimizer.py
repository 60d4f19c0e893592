"""Random-annealing hyper-parameter search (the port's copy of
``pnp_ovss_tpu/search/optimizer.py``, with ``run_search`` of
``pnp_ovss_tpu/cli/search.py``).

The reference drives its (layer, head, min_att) search with the external
Gradient-Free-Optimizers package's RandomAnnealingOptimizer, 34
iterations, a fixed seed (reference script :1381-1403). This is a
dependency-free version of the same algorithm class: random-restart hill
climbing whose neighbourhood radius anneals with the temperature. Every
draw comes from one explicit ``numpy.random.RandomState`` seeded from
``seed``, so a seed fixes the visited sequence (the JAX package's, draw
for draw).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SearchSpace:
    """Discrete grid per dimension, e.g. {"layer": [1..12], ...}."""

    dims: Dict[str, Sequence]

    def random_point(self, rng: np.random.RandomState) -> Dict:
        return {k: v[rng.randint(len(v))] for k, v in self.dims.items()}

    def neighbor(self, point: Dict, rng: np.random.RandomState,
                 radius: float) -> Dict:
        out = {}
        for k, vals in self.dims.items():
            idx = list(vals).index(point[k])
            span = max(1, int(round(radius * len(vals))))
            lo, hi = max(0, idx - span), min(len(vals) - 1, idx + span)
            out[k] = vals[rng.randint(lo, hi + 1)]
        return out


class RandomAnnealingOptimizer:
    """Maximise score_fn over the space. Deterministic for a given seed."""

    def __init__(self, space: SearchSpace, *,
                 seed: int = 1164005944,  # the reference's random_state
                 start_temp: float = 1.0, annealing_rate: float = 0.97):
        self.space = space
        self.rng = np.random.RandomState(seed % (2**32))
        self.start_temp = start_temp
        self.annealing_rate = annealing_rate
        self.history: List[Tuple[Dict, float]] = []

    def search(self, score_fn: Callable[[Dict], float], n_iter: int = 34):
        best_point = self.space.random_point(self.rng)
        best_score = score_fn(best_point)
        self.history.append((best_point, best_score))
        cur_point, cur_score = best_point, best_score
        temp = self.start_temp
        for _ in range(n_iter - 1):
            cand = self.space.neighbor(cur_point, self.rng, radius=temp)
            score = score_fn(cand)
            self.history.append((cand, score))
            accept = score > cur_score or self.rng.rand() < math.exp(
                min(0.0, (score - cur_score) / max(temp, 1e-9)))
            if accept:
                cur_point, cur_score = cand, score
            if score > best_score:
                best_point, best_score = cand, score
            temp *= self.annealing_rate
        return best_point, best_score


def run_search(score_fn, *, layers=range(1, 13), heads=range(0, 12),
               min_atts=None, n_iter: int = 34, seed: int = 1164005944):
    """The reference's search over {layer, head, min_att 0.05..0.45}:
    -> (best point, its score, [(point, score)] in visiting order)."""
    if min_atts is None:
        min_atts = [round(x, 2) for x in np.arange(0.05, 0.46, 0.05)]
    space = SearchSpace({"layer": list(layers), "head": list(heads),
                         "min_att": list(min_atts)})
    opt = RandomAnnealingOptimizer(space, seed=seed)
    best, score = opt.search(score_fn, n_iter=n_iter)
    return best, score, opt.history
