"""Search-space primitives and variant generation.

Reference surface: python/ray/tune/search/sample.py (grid_search, uniform,
loguniform, choice, randint) and search/basic_variant.py (grid expansion ×
num_samples stochastic sampling). Original implementation: spaces are small
declarative markers; `generate_variants` expands the cartesian product of
grid axes and draws the stochastic axes per sample.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List


class _Sampler:
    def sample(self, rng: random.Random) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


class Choice(_Sampler):
    def __init__(self, options: List[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class Uniform(_Sampler):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


class LogUniform(_Sampler):
    def __init__(self, lo: float, hi: float):
        import math

        self.log_lo, self.log_hi = math.log(lo), math.log(hi)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_lo, self.log_hi))


class RandInt(_Sampler):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randrange(self.lo, self.hi)


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def choice(options: List[Any]) -> Choice:
    return Choice(options)


def uniform(lo: float, hi: float) -> Uniform:
    return Uniform(lo, hi)


def loguniform(lo: float, hi: float) -> LogUniform:
    return LogUniform(lo, hi)


def randint(lo: int, hi: int) -> RandInt:
    return RandInt(lo, hi)


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: int | None = None) -> Iterator[Dict[str, Any]]:
    """Expand grid axes fully; draw stochastic axes `num_samples` times
    (reference: basic_variant.py — num_samples repeats the whole grid)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    grid_values = [space[k].values for k in grid_keys]
    grids = list(itertools.product(*grid_values)) if grid_keys else [()]
    for _ in range(max(1, num_samples)):
        for combo in grids:
            cfg = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, _Sampler):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            yield cfg
