"""CPU tests of the benchmark, at tiny sizes. Tests that need the card carry
the ``card`` marker and skip inside the ``card`` fixture where there is
none; on the card's machine run them with

    python3 -m pytest portbench/tests -m card
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256}

SERVE = {"config": TINY,
         "cell": {"engine": {"max_num_seqs": 4, "max_model_len": 64,
                             "kv_block_size": 16, "num_kv_blocks": 64,
                             "prefix_cache": None},
                  "trace_seconds": 0.5,
                  "check": {"served_tokens": 32, "min_compared_tokens": 8,
                            "widest_gap": 0.05}},
         "traffic": {"clients": 4, "pool": 32, "strata": 4,
                     "prompt_len": {"dist": "lognormal", "median": 20,
                                    "sigma": 0.5, "min": 8, "max": 40},
                     "output_len": {"dist": "uniform", "min": 4, "max": 16},
                     "order_seed": 0}}

TRAIN = {"config": TINY, "traffic": {"batch": 4, "seq": 32},
         "cell": {"trace_seconds": 0.5,
                  "check": {"grad_gap": 1e-2, "grad_diff": 0.1,
                            "change_gap": 1e-2, "change_diff": 1.0}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the card fixture")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
