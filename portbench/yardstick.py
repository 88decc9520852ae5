"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes of the kernels and steps it reads, model FLOPs, percentiles.

Nothing here imports torch or the program. The kernel bounds are
``chip_smoke.py``'s ``_k1_bound`` and ``_k23_bounds`` (training path: K2
fuses delta), copied and kept here so that a change to the program cannot
move the yardstick.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def dims(mc: Dict) -> Dict[str, int]:
    """The widths of a configuration file (Hugging Face keys)."""
    d, h = mc["hidden_size"], mc["num_attention_heads"]
    return dict(dim=d, n_layers=mc["num_hidden_layers"], n_heads=h,
                n_kv_heads=mc["num_key_value_heads"],
                head_dim=mc.get("head_dim") or d // h,
                ffn=mc["intermediate_size"], vocab=mc["vocab_size"])


def matmul_params(mc: Dict) -> int:
    """N: the parameters that take part in a product for every token, the
    layers' projections and the head (the embedding is a lookup)."""
    w = dims(mc)
    hd = w["head_dim"]
    layer = (w["dim"] * w["n_heads"] * hd * 2           # wq, wo
             + w["dim"] * w["n_kv_heads"] * hd * 2      # wk, wv
             + 3 * w["dim"] * w["ffn"])                 # w1, w2, w3
    return w["n_layers"] * layer + w["dim"] * w["vocab"]


def weight_bytes(mc: Dict, elem: int = 2) -> int:
    """Bytes a forward step reads of the weights once: every projection,
    the head and the norms (the embedding rows read are counted apart)."""
    w = dims(mc)
    norms = (2 * w["n_layers"] + 1) * w["dim"]
    return (matmul_params(mc) + norms) * elem


def kv_bytes_per_token(mc: Dict, elem: int = 2) -> int:
    """K and V of one token over all layers."""
    w = dims(mc)
    return w["n_layers"] * 2 * w["n_kv_heads"] * w["head_dim"] * elem


def train_flops_per_token(mc: Dict, seq: int) -> float:
    """PaLM's model FLOPs a trained token, 6N + 12 L dim s (no recompute)."""
    w = dims(mc)
    return 6.0 * matmul_params(mc) + 12.0 * w["n_layers"] * w["dim"] * seq


def forward_flops(mc: Dict, first_pos: int, count: int) -> float:
    """Model FLOPs of a forward over ``count`` tokens at positions
    first_pos .. first_pos+count-1, each attending to every key up to its
    own: 2N a token, plus 4 L (heads x head_dim) per (query, key) pair."""
    w = dims(mc)
    qk = w["n_heads"] * w["head_dim"]
    lo, hi = first_pos + 1, first_pos + count       # keys seen, first and last
    pairs = (lo + hi) * count / 2.0
    return 2.0 * matmul_params(mc) * count + 4.0 * w["n_layers"] * qk * pairs


def decode_least_bytes(mc: Dict, active: int, cached: int,
                       elem: int = 2) -> float:
    """The least bytes one decode step moves: the weights once, the
    ``cached`` tokens' K/V of its ``active`` sequences read once, each
    sequence's new K/V written and its embedding row read."""
    per_tok = kv_bytes_per_token(mc, elem)
    return (weight_bytes(mc, elem) + cached * per_tok
            + active * (per_tok + dims(mc)["dim"] * elem))


def k1_cost(b: int, h: int, kvh: int, s: int, hd: int,
            causal: bool) -> Tuple[float, float]:
    """(flops, bytes) of one K1 call: each input read once, each output
    written once (o and the fp32 lse); causal counts the s(s+1)/2 pairs
    the mask keeps."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 4.0 * b * h * s
    return flops, nbytes


def k23_cost(b: int, h: int, kvh: int, s: int,
             hd: int, causal: bool) -> Dict[str, Tuple[float, float]]:
    """{"k2": (flops, bytes), "k3": (flops, bytes)} of the training
    backward: K2 does 3 products and K3 4 of 2 b h hd a (q, k) pair; q, k,
    v, dO, lse and delta read once, except that K2 reads o and writes delta
    (fused delta), the bf16 gradients written once."""
    pairs = s * (s + 1) / 2 if causal else s * s
    qbytes, kvbytes, rows = 2.0 * b * h * s * hd, 2.0 * b * kvh * s * hd, \
        4.0 * b * h * s
    read = 2 * qbytes + 2 * kvbytes + 2 * rows
    return {"k2": (2.0 * 3 * b * h * hd * pairs, read + qbytes + qbytes),
            "k3": (2.0 * 4 * b * h * hd * pairs, read + 2 * kvbytes)}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def mean_ms(extents: Sequence) -> Optional[float]:
    """The mean of (start, seconds) extents, in milliseconds; None for none."""
    return 1e3 * sum(s for _, s in extents) / len(extents) if extents else None


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of a non-empty sample."""
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def tokens_per_s(records: List[Dict], t0: float, t1: float) -> float:
    """Output tokens that clients received inside [t0, t1], over its
    length (host clock)."""
    return sum(t0 <= t <= t1 for r in records for t in r["times"]) / (t1 - t0)


def itl_gaps(records: List[Dict], t0: float, t1: float) -> List[float]:
    """Every gap between two consecutive tokens of one request, both
    received inside [t0, t1], over all requests (seconds)."""
    return [b - a for r in records
            for a, b in zip(r["times"], r["times"][1:]) if a >= t0 and b <= t1]


def ttft_waits(records: List[Dict], t0: float, t1: float) -> List[float]:
    """Send to first token of every request sent inside [t0, t1); one with
    no first token by t1 counts at its wait so far (seconds)."""
    return [min(r["times"][0] if r["times"] else t1, t1) - r["send"]
            for r in records if t0 <= r["send"] < t1]


def spread(values: List[float]) -> float:
    """Interquartile distance as a share of the median, by
    ``statistics.quantiles(values, n=4)``."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
