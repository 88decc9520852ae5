"""Datasource constructors for ray_tpu_torch.data.

Reference: python/ray/data/read_api.py (range, from_items, read_parquet,
read_csv, read_json, read_binary_files, read_images) and
data/datasource/*_datasource.py. Each reader builds a Dataset whose logical
plan is a single `Read` leaf over a Datasource object; file IO happens on
cluster workers, one fused task per block.

Datasources are the PUSHDOWN surface of the query planner
(ray_tpu_torch/data/_logical): a column-capable source accepts `with_columns`
(projection pushdown → `read_parquet(columns=)`, `read_sql` column lists),
a predicate-capable one accepts `with_filters` (pyarrow parquet
`filters=`), and metadata-capable ones answer `count_rows`/`schema` from
parquet footers or range arithmetic so `count()`/`schema()` read zero data
blocks.
"""

from __future__ import annotations

import builtins
import functools
import glob as glob_mod
import os
from typing import Any, List, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.data.dataset import Dataset


# ---------------------------------------------------------------------------
# datasource objects (the Read leaf's payload)
# ---------------------------------------------------------------------------


class Datasource:
    """Base datasource: a list of block producers plus optional metadata
    and pushdown hooks the optimizer rules drive."""

    supports_column_pushdown = False
    supports_predicate_pushdown = False
    columns: Optional[List[str]] = None
    filters: Optional[List[tuple]] = None

    def producers(self) -> List[Any]:
        raise NotImplementedError

    def num_blocks(self) -> Optional[int]:
        return len(self.producers())

    def count_rows(self) -> Optional[int]:
        """Exact row count from metadata only, or None (must execute)."""
        return None

    def schema(self) -> Optional[dict]:
        """{column: numpy-dtype-str} from metadata only, or None."""
        return None

    def with_columns(self, columns: List[str]) -> "Datasource":
        raise NotImplementedError(f"{type(self).__name__} cannot push columns")

    def with_filters(self, exprs: List[tuple]) -> "Datasource":
        raise NotImplementedError(
            f"{type(self).__name__} cannot push predicates")

    def describe(self) -> str:
        return type(self).__name__


class SimpleDatasource(Datasource):
    """A plain producer list (from_items / raw Dataset(producers) /
    readers without pushdown). `num_rows` is optional arithmetic metadata
    (from_items knows its length)."""

    def __init__(self, items: List[Any], *, num_rows: Optional[int] = None,
                 known_schema: Optional[dict] = None, label: str = "blocks"):
        self._items = list(items)
        self._num_rows = num_rows
        self._schema = known_schema
        self._label = label

    def producers(self) -> List[Any]:
        return list(self._items)

    def num_blocks(self) -> int:
        return len(self._items)

    def count_rows(self) -> Optional[int]:
        return self._num_rows

    def schema(self) -> Optional[dict]:
        return dict(self._schema) if self._schema else None

    def describe(self) -> str:
        return f"{self._label}: {len(self._items)} blocks"


class RangeDatasource(Datasource):
    """ray.data.range — all metadata is arithmetic: count, schema, and
    (with limit pushdown) even the covering block prefix need zero tasks."""

    def __init__(self, n: int, parallelism: int):
        self.n = int(n)
        self.parallelism = parallelism

    def producers(self) -> List[Any]:
        return [
            functools.partial(_range_block, lo, hi)
            for lo, hi in _chunk_bounds(self.n, self.parallelism)
        ]

    def num_blocks(self) -> int:
        return self.parallelism

    def count_rows(self) -> int:
        return self.n

    def schema(self) -> dict:
        return {"id": "int64"}

    def describe(self) -> str:
        return f"range({self.n}) x{self.parallelism}"


class ParquetDatasource(Datasource):
    """One block per parquet file. Projection pushdown narrows `columns`,
    predicate pushdown supplies pyarrow `filters=` (row-group pruning at
    the IO layer), and count/schema come from file FOOTERS."""

    supports_column_pushdown = True
    supports_predicate_pushdown = True

    def __init__(self, files: List[str], columns: Optional[List[str]] = None,
                 filters: Optional[List[tuple]] = None):
        self.files = list(files)
        self.columns = list(columns) if columns is not None else None
        self.filters = list(filters) if filters is not None else None
        # footer reads are serial driver IO; the instance is immutable so
        # repeat count()/schema()/explain() calls reuse the first answer
        self._count_cache: Optional[int] = None
        self._schema_cache: Optional[dict] = None

    def producers(self) -> List[Any]:
        return [
            functools.partial(_read_parquet_file, f, self.columns,
                              self.filters)
            for f in self.files
        ]

    def num_blocks(self) -> int:
        return len(self.files)

    def count_rows(self) -> Optional[int]:
        if self.filters is not None:
            return None  # footer counts pre-date row filtering
        if self._count_cache is not None:
            return self._count_cache
        try:
            import pyarrow.parquet as pq

            self._count_cache = sum(
                pq.ParquetFile(f).metadata.num_rows for f in self.files)
            return self._count_cache
        except Exception:  # noqa: BLE001 — metadata is best-effort
            return None

    def schema(self) -> Optional[dict]:
        if self._schema_cache is not None:
            out = self._schema_cache
        else:
            try:
                import pyarrow.parquet as pq

                sch = pq.read_schema(self.files[0])
                out = {
                    f.name: str(np.dtype(f.type.to_pandas_dtype()))
                    for f in sch
                }
                self._schema_cache = out
            except Exception:  # noqa: BLE001 — fall back to executing
                return None
        if self.columns is not None:
            try:
                return {c: out[c] for c in self.columns}
            except KeyError:
                return None
        return out

    def with_columns(self, columns: List[str]) -> "ParquetDatasource":
        return ParquetDatasource(self.files, columns, self.filters)

    def with_filters(self, exprs: List[tuple]) -> "ParquetDatasource":
        return ParquetDatasource(
            self.files, self.columns, (self.filters or []) + list(exprs))

    def describe(self) -> str:
        extra = ""
        if self.columns is not None:
            extra += f", columns={self.columns}"
        if self.filters is not None:
            extra += f", filters={self.filters}"
        return f"parquet: {len(self.files)} files{extra}"


class SQLDatasource(Datasource):
    """read_sql over a DB-API connection factory. Projection pushdown
    rewrites the column list of the wrapping SELECT (identifiers validated
    and quoted — never raw splicing)."""

    supports_column_pushdown = True

    def __init__(self, sql: str, connection_factory, parallelism: int,
                 partition_column: Optional[str], lower_bound, upper_bound,
                 columns: Optional[List[str]] = None):
        self.sql = sql
        self.connection_factory = connection_factory
        self.parallelism = parallelism
        self.partition_column = partition_column  # already validated/quoted
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.columns = list(columns) if columns is not None else None

    def _select(self, inner: str) -> str:
        if self.columns is None:
            return inner
        cols = ", ".join(_validate_sql_identifier(c) for c in self.columns)
        return f"SELECT {cols} FROM ({inner}) AS _rt_proj"

    def producers(self) -> List[Any]:
        # Partition predicate applies to the INNER query, the projection
        # wraps outside it: the pushed-down column list may exclude
        # partition_column, which must stay visible to the WHERE.
        if self.partition_column is None or self.parallelism <= 1:
            return [functools.partial(_sql_read, self._select(self.sql),
                                      self.connection_factory)]
        span = (float(self.upper_bound) - float(self.lower_bound)) \
            / self.parallelism
        producers = []
        for i in builtins.range(self.parallelism):
            # JDBC-style split: bounds set the STRIDE; the edge partitions
            # are unbounded so rows outside [lower_bound, upper_bound)
            # still land somewhere instead of silently vanishing
            lo = None if i == 0 else self.lower_bound + span * i
            hi = (None if i == self.parallelism - 1
                  else self.lower_bound + span * (i + 1))
            # numeric literals, not driver placeholders: paramstyle varies
            # across DB-API drivers (sqlite qmark, psycopg2 pyformat, ...)
            # and the bounds are framework-generated numbers, never user
            # strings
            preds = []
            if lo is not None:
                preds.append(f"{self.partition_column} >= {float(lo)!r}")
            if hi is not None:
                preds.append(f"{self.partition_column} < {float(hi)!r}")
            part = (f"SELECT * FROM ({self.sql}) AS _rt_sub "
                    f"WHERE {' AND '.join(preds)}")
            producers.append(functools.partial(
                _sql_read, self._select(part), self.connection_factory))
        return producers

    def num_blocks(self) -> int:
        if self.partition_column is None or self.parallelism <= 1:
            return 1
        return self.parallelism

    def with_columns(self, columns: List[str]) -> "SQLDatasource":
        for c in columns:
            _validate_sql_identifier(c)  # reject before it reaches a query
        return SQLDatasource(self.sql, self.connection_factory,
                             self.parallelism, self.partition_column,
                             self.lower_bound, self.upper_bound, columns)

    def describe(self) -> str:
        extra = f", columns={self.columns}" if self.columns else ""
        return f"sql: parallelism={self.parallelism}{extra}"


def _sql_read(sql, connection_factory):
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.execute(sql)
        cols = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    return {c: np.asarray([r[i] for r in rows])
            for i, c in enumerate(cols)}


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _chunk_bounds(n: int, k: int):
    # NB: module-level `range()` below shadows the builtin (API parity with
    # ray.data.range), hence builtins.range here
    return [((n * i) // k, (n * (i + 1)) // k) for i in builtins.range(k)]


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001 — API parity
    """Dataset of {"id": int64} rows 0..n-1 (reference: ray.data.range)."""
    k = parallelism if parallelism > 0 else min(max(1, n // 1000), 200)
    return Dataset._from_datasource(RangeDatasource(n, k))


def _range_block(lo: int, hi: int):
    return {"id": np.arange(lo, hi, dtype=np.int64)}


def from_items(items: Sequence[Any], *, parallelism: int = -1) -> Dataset:
    """Dataset from a local list (reference: ray.data.from_items)."""
    from ray_tpu_torch.data.block import rows_to_block

    items = list(items)
    k = parallelism if parallelism > 0 else min(max(1, len(items) // 1000), 200)
    k = max(1, min(k, len(items) or 1))
    blocks = [
        rows_to_block(items[lo:hi]) for lo, hi in _chunk_bounds(len(items), k)
    ]
    return Dataset._from_datasource(SimpleDatasource(
        [functools.partial(_identity, b) for b in blocks],
        num_rows=len(items), label="items"))


def _identity(b):
    return b


def from_numpy(arr: np.ndarray, *, column: str = "data",
               parallelism: int = -1) -> Dataset:
    k = parallelism if parallelism > 0 else min(max(1, len(arr) // 100_000), 200)
    return Dataset._from_datasource(SimpleDatasource(
        [
            functools.partial(_identity, {column: arr[lo:hi]})
            for lo, hi in _chunk_bounds(len(arr), k)
        ],
        num_rows=len(arr), label="numpy"))


def _expand_paths(paths: Union[str, Sequence[str]], suffixes=None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if suffixes:
        out = [p for p in out if any(p.endswith(s) for s in suffixes)]
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def read_parquet(paths: Union[str, Sequence[str]], *, columns=None) -> Dataset:
    """One block per parquet file, columnar numpy (reference: read_parquet).
    `columns=` narrows the read up front; projection/predicate pushdown
    narrow it further from the plan."""
    files = _expand_paths(paths, suffixes=[".parquet"])
    return Dataset._from_datasource(ParquetDatasource(files, columns))


def _read_parquet_file(path: str, columns, filters=None):
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=columns, filters=filters)
    return {
        name: col.to_numpy(zero_copy_only=False)
        for name, col in zip(table.column_names, table.columns)
    }


def read_csv(paths: Union[str, Sequence[str]], **pandas_kwargs) -> Dataset:
    files = _expand_paths(paths, suffixes=[".csv"])
    return Dataset._from_datasource(SimpleDatasource(
        [functools.partial(_read_csv_file, f, pandas_kwargs) for f in files],
        label="csv"))


def _read_csv_file(path: str, pandas_kwargs):
    import pandas as pd

    df = pd.read_csv(path, **pandas_kwargs)
    return {c: df[c].to_numpy() for c in df.columns}


def read_json(paths: Union[str, Sequence[str]], *, lines: bool = True) -> Dataset:
    files = _expand_paths(paths, suffixes=[".json", ".jsonl"])
    return Dataset._from_datasource(SimpleDatasource(
        [functools.partial(_read_json_file, f, lines) for f in files],
        label="json"))


def _read_json_file(path: str, lines: bool):
    import pandas as pd

    df = pd.read_json(path, lines=lines)
    return {c: df[c].to_numpy() for c in df.columns}


def read_binary_files(paths: Union[str, Sequence[str]],
                      *, include_paths: bool = False,
                      parallelism: int = -1) -> Dataset:
    files = _expand_paths(paths)
    k = parallelism if parallelism > 0 else min(len(files), 64)
    return Dataset._from_datasource(SimpleDatasource(
        [
            functools.partial(_read_binary_chunk, files[lo:hi], include_paths)
            for lo, hi in _chunk_bounds(len(files), k)
        ],
        label="binary"))


def _read_binary_chunk(files: List[str], include_paths: bool):
    rows = []
    for f in files:
        with open(f, "rb") as fh:
            data = fh.read()
        rows.append({"path": f, "bytes": data} if include_paths else {"bytes": data})
    return rows


def read_images(paths: Union[str, Sequence[str]], *, size=None,
                mode: str = "RGB", parallelism: int = -1) -> Dataset:
    """Decode images into {"image": uint8 HWC} rows; `size=(h, w)` resizes so
    blocks stack into one array (reference: ray.data.read_images)."""
    files = _expand_paths(
        paths, suffixes=[".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"]
    )
    k = parallelism if parallelism > 0 else min(len(files), 64)
    return Dataset._from_datasource(SimpleDatasource(
        [
            functools.partial(_read_image_chunk, files[lo:hi], size, mode)
            for lo, hi in _chunk_bounds(len(files), k)
        ],
        label="images"))


def _read_image_chunk(files: List[str], size, mode: str):
    from PIL import Image

    arrays = []
    for f in files:
        img = Image.open(f).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arrays.append(np.asarray(img))
    if size is not None:
        return {"image": np.stack(arrays)}
    return [{"image": a} for a in arrays]


def _validate_sql_identifier(name: str) -> str:
    """Quote `partition_column` (or a pushed-down column name) as a SQL
    identifier. Only plain identifiers (letters/digits/underscore, possibly
    dotted) are accepted — the name is spliced into the query text, so
    anything else is rejected rather than passed through."""
    import re

    if not isinstance(name, str) or not re.fullmatch(
            r"[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)?", name):
        raise ValueError(
            f"column {name!r} is not a plain SQL identifier "
            "(letters, digits, underscores, optional single dot)")
    # standard SQL double-quoting; the dotted form quotes each part
    return ".".join('"%s"' % part for part in name.split("."))


def _validate_sql_bound(value, which: str) -> float:
    """Range bounds must be real numbers: they are spliced as numeric
    literals (paramstyle varies across DB-API drivers), and range
    partitioning itself is numeric-only."""
    import numbers

    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise TypeError(
            f"read_sql {which} must be a real number for numeric range "
            f"partitioning, got {type(value).__name__}: {value!r}. "
            "String/timestamp/date partition columns are not supported — "
            "partition on a numeric key (e.g. an integer id) instead.")
    return float(value)


def read_sql(sql: str, connection_factory, *, parallelism: int = 1,
             partition_column: Optional[str] = None,
             lower_bound=None, upper_bound=None) -> Dataset:
    """Read a SQL query through a DB-API connection factory (reference:
    python/ray/data/read_api.py read_sql / datasource/sql_datasource.py).

    `connection_factory` is a zero-arg callable returning a DB-API 2.0
    connection (sqlite3.connect(...), psycopg2.connect(...), ...) — it runs
    INSIDE the read tasks, so the connection never pickles. With
    `partition_column` + bounds, `parallelism` tasks each read one range
    slice of the query (the standard JDBC-style range split); otherwise one
    task reads the whole result.

    Range partitioning is NUMERIC-ONLY: `partition_column` must hold real
    numbers and `lower_bound`/`upper_bound` must be numbers (they become
    numeric literals in the generated predicates). The column name must be
    a plain identifier; it is validated and quoted before being spliced
    into the query."""
    if parallelism > 1 and partition_column is None:
        raise ValueError("parallel read_sql needs partition_column + bounds")
    if partition_column is not None:
        partition_column = _validate_sql_identifier(partition_column)
    if partition_column is not None and parallelism > 1:
        if lower_bound is None or upper_bound is None:
            raise ValueError("parallel read_sql needs lower_bound/upper_bound")
        lower_bound = _validate_sql_bound(lower_bound, "lower_bound")
        upper_bound = _validate_sql_bound(upper_bound, "upper_bound")
        if upper_bound < lower_bound:
            raise ValueError(
                f"read_sql upper_bound ({upper_bound}) must be >= "
                f"lower_bound ({lower_bound})")
    return Dataset._from_datasource(SQLDatasource(
        sql, connection_factory, parallelism, partition_column,
        lower_bound, upper_bound))
