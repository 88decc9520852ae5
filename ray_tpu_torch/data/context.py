"""Execution context for ray_tpu_torch.data (reference:
python/ray/data/context.py DataContext — the knobs the streaming executor
and resource manager read)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class DataContext:
    """Per-driver data-execution settings.

    streaming_block_window — max source blocks in flight end-to-end during
    streaming consumption (iter_batches / iter_rows / take on an
    unmaterialized dataset). The memory ceiling is roughly
    window × max block size; consumed blocks free their shm copies before
    new ones are admitted (reference: streaming_executor resource manager's
    bounded operator memory).
    """

    streaming_block_window: int = 8
    # the logical optimizer escape hatch: False compiles the plan naively
    # (one stage per op, no pushdowns, no metadata shortcuts — limit
    # SEMANTICS still hold, they are compilation, not optimization).
    # bench_data.py A/Bs this flag.
    optimizer_enabled: bool = True
    # max estimated bytes in flight per pipeline stage before admission
    # backpressure (reference: execution/resource_manager.py budgets)
    op_memory_budget_bytes: int = 128 << 20
    # shuffle-class ops: target partition size + fan-out cap (B blocks x
    # B partitions return-ref blowup guard)
    shuffle_target_partition_bytes: int = 64 << 20
    shuffle_max_partitions: int = 64
    # advisory target for readers choosing block splits
    target_max_block_size: int = 128 * 1024 * 1024

    _current: "Optional[DataContext]" = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = DataContext()
        return cls._current
