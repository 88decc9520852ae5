"""ray_tpu_torch.data — distributed, block-based data pipelines feeding SPMD
training (reference surface: python/ray/data/__init__.py).

Datasets build a lazy LOGICAL PLAN; a rule-based optimizer (operator
fusion, limit/projection/predicate pushdown — ray_tpu_torch/data/_logical/)
rewrites it and the physical planner compiles it onto the streaming
executor: one fused remote task per block. Blocks are columnar
dict-of-numpy; `Dataset.split()` shards blocks across train workers and
`iter_batches(device_put=True)` prefetches host→device.
"""

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (
    from_items,
    from_numpy,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_parquet,
    read_sql,
)

__all__ = [
    "Block",
    "DataContext",
    "Dataset",
    "range",
    "from_items",
    "from_numpy",
    "read_parquet",
    "read_sql",
    "read_csv",
    "read_json",
    "read_binary_files",
    "read_images",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("data")
del _rlu
