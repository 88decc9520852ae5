"""Block representation and batch slicing for ray_tpu_torch.data.

Reference: python/ray/data/block.py (Arrow/pandas/simple blocks). The
native block is **columnar dict-of-numpy** — the layout `iter_batches` can
copy straight onto the port's device (`iter_batches(device_put=True)`)
without conversion — with a plain row-list fallback for non-tabular data.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]


def block_num_rows(block: Block) -> int:
    if isinstance(block, dict):
        if not block:
            return 0
        return len(next(iter(block.values())))
    return len(block)


def block_slice(block: Block, start: int, stop: int) -> Block:
    if isinstance(block, dict):
        return {k: v[start:stop] for k, v in block.items()}
    return block[start:stop]


def block_concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return []
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out: List[Any] = []
    for b in blocks:
        out.extend(b)
    return out


def block_rows(block: Block) -> Iterator[Any]:
    """Iterate rows: dict blocks yield per-row dicts, list blocks yield items."""
    if isinstance(block, dict):
        n = block_num_rows(block)
        keys = list(block.keys())
        for i in range(n):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block


def rows_to_block(rows: List[Any]) -> Block:
    """Columnarize a row list when all rows are flat dicts of scalars/arrays
    of matching shape; otherwise keep the row list."""
    if not rows:
        return []
    if all(isinstance(r, dict) for r in rows):
        keys = rows[0].keys()
        if all(r.keys() == keys for r in rows):
            try:
                return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in keys}
            except (ValueError, TypeError):
                pass  # ragged: fall through to row list
    return list(rows)


def normalize_batch(block: Block) -> Block:
    """What a map_batches UDF receives: columnar dicts stay columnar; row
    lists of uniform dicts are columnarized; other rows stay a list."""
    if isinstance(block, dict):
        return block
    return rows_to_block(block)


def block_select_columns(block: Block, columns: List[str]) -> Block:
    """Project a block to a column subset (the Project logical op's task
    body). Missing columns raise KeyError — same surface the downstream
    UDF would have hit."""
    if isinstance(block, dict):
        return {c: block[c] for c in columns}
    return [{c: r[c] for c in columns} for r in block]


def _column_mask(col: np.ndarray, op: str, value) -> np.ndarray:
    if op in ("==", "="):
        return col == value
    if op == "!=":
        return col != value
    if op == "<":
        return col < value
    if op == "<=":
        return col <= value
    if op == ">":
        return col > value
    if op == ">=":
        return col >= value
    if op == "in":
        return np.isin(col, list(value))
    if op == "not in":
        return ~np.isin(col, list(value))
    raise ValueError(f"unknown predicate op {op!r}")


def block_filter_expr(block: Block, exprs) -> Block:
    """Apply a conjunction of (column, op, value) predicates — the same
    tuple shape pyarrow's parquet `filters=` takes, so a predicate that
    could not push into the reader evaluates identically here, vectorized
    over columnar blocks."""
    if isinstance(block, dict):
        n = block_num_rows(block)
        mask = np.ones(n, dtype=bool)
        for col, op, value in exprs:
            mask &= np.asarray(_column_mask(np.asarray(block[col]), op, value))
        return {c: np.asarray(v)[mask] for c, v in block.items()}

    def keep(row) -> bool:
        for col, op, value in exprs:
            if not bool(_column_mask(np.asarray([row[col]]), op, value)[0]):
                return False
        return True

    return [r for r in block if keep(r)]
