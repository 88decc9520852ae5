"""The one traffic generator: it reads a mix's data file
(``traffic/<name>.json``) and makes the requests of a run from its seed.

Lengths are the mix's distribution at fixed quantiles, in an order that
the mix's own ``order_seed`` fixes, so every run of a cell gets the same
prompt and output lengths in the same order: the run's seed draws only
the token ids (and, elsewhere, the weights). A closed loop's tail depends
on which lengths meet in one window, so a seed that reordered them would
change the work. The order is stratified: each run of ``strata``
consecutive requests takes one length from each band of quantiles.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def torch_seed(seed: int, stream: int) -> int:
    """A torch.Generator seed for one stream of a run's seed."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0] & ((1 << 63) - 1))


def _ppf(spec: Dict, q: float) -> float:
    if spec["dist"] == "lognormal":
        return math.exp(math.log(spec["median"])
                        + spec["sigma"] * NormalDist().inv_cdf(q))
    if spec["dist"] == "uniform":
        return spec["min"] + q * (spec["max"] - spec["min"])
    if spec["dist"] == "fixed":
        return spec["value"]
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _lengths(spec: Dict, n: int, strata: int,
             gen: np.random.Generator) -> List[int]:
    vals = sorted(int(min(spec.get("max", math.inf),
                          max(spec.get("min", 1), round(_ppf(spec, (i + .5) / n)))))
                  for i in range(n))
    m = n // strata
    bands = [list(gen.permutation(vals[g * m:(g + 1) * m])) for g in range(strata)]
    out = []
    for b in range(m):
        out += [int(bands[g][b]) for g in gen.permutation(strata)]
    return out


@dataclass
class Request:
    prompt: List[int]
    max_tokens: int


def closed_loop_requests(mix: Dict, seed: int, vocab: int,
                         max_model_len: int) -> List[Request]:
    """The pool of requests a closed loop cycles through, in order. Each
    output is capped so that prompt and output fit ``max_model_len``."""
    n, strata = mix["pool"], mix["strata"]
    if n % strata:
        raise ValueError("pool must be a multiple of strata")
    order = rng(mix["order_seed"], 1)
    plens = _lengths(mix["prompt_len"], n, strata, order)
    outs = _lengths(mix["output_len"], n, strata, order)
    g = rng(seed, 1)
    return [Request(g.integers(0, vocab, p).tolist(),
                    max(1, min(o, max_model_len - p)))
            for p, o in zip(plens, outs)]


def first_request_tokens(max_tokens: int, client: int, clients: int) -> int:
    """The first request of each client is cut to a share of its output,
    (client + 1) / clients, so that the clients' requests end spread out
    from the start, as in a loop that has run for a while."""
    return max(1, math.ceil(max_tokens * (client + 1) / clients))
