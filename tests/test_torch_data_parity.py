"""One seeded data program run on ``ray_tpu.data`` and then on
``ray_tpu_torch.data``, each on a cluster of its own package (``init`` ...
``shutdown``, the JAX one first): the random plan chains of
``test_data_equivalence.py`` with the optimizer on and off, sorts,
group-bys, joins, zips, seeded shuffles, repartitions, splits, aggregates,
batches across blocks, limits and the readers with their pushdowns. Every
result must be equal: the rows, in order, and the ``explain()`` text of
each plan (the logical plan, the rules that fired, the physical plan). The
data library and both runtimes import no torch, so this runs in the
pytest worker.

Then ``iter_batches(device_put=True)``: JAX's ``Dataset`` puts each
column through ``jax.device_put`` (x64 off: 64-bit types become 32-bit,
non-numeric columns raise ``TypeError``); the port's, with
``device="cpu"``, in a spawned child (it imports torch), must give the
same dtypes, values and errors.
"""

import functools
import gc
import random

import ml_dtypes
import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from _port_proc import spawn

CHAIN_SEEDS = (101, 202, 303, 404)


def _random_chain(rd, rng: random.Random, depth: int):
    """``test_data_equivalence.py``'s chain on the data module ``rd``."""
    n = rng.randint(5, 40)
    rows = [rng.randint(0, 99) for _ in range(n)]
    ds = rd.from_items(rows, parallelism=rng.randint(1, 6))
    for _ in range(depth):
        op = rng.choice(
            ["map", "filter", "flat_map", "limit", "union", "repartition"])
        if op == "map":
            c = rng.randint(1, 9)
            ds = ds.map(lambda x, c=c: x * 10 + c)
        elif op == "filter":
            m = rng.randint(2, 4)
            r = rng.randint(0, m - 1)
            ds = ds.filter(lambda x, m=m, r=r: x % m == r)
        elif op == "flat_map":
            ds = ds.flat_map(lambda x: [x, x + 1])
        elif op == "limit":
            ds = ds.limit(rng.randint(0, n + 3))
        elif op == "union":
            extra = [rng.randint(100, 199) for _ in range(rng.randint(1, 15))]
            ds = ds.union(rd.from_items(extra, parallelism=rng.randint(1, 3)))
        else:
            ds = ds.repartition(rng.randint(1, 5))
    return ds


def _plain(rows):
    """Rows as plain Python values (numpy scalars compare by value, and
    their types differ by nothing the packages choose)."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v
    return [one(r) for r in rows]


def _write_parquet(root):
    import pyarrow as pa
    import pyarrow.parquet as pq

    for i in range(3):
        pq.write_table(pa.table({
            "a": list(range(i * 10, i * 10 + 10)),
            "b": [float(x) for x in range(10)],
            "c": [f"s{x}" for x in range(10)]}),
            str(root / f"part{i}.parquet"))


def _program(rd, root) -> dict:
    out = {}
    ctx = rd.DataContext.get_current()
    for seed in CHAIN_SEEDS:
        rng = random.Random(seed)
        ds = _random_chain(rd, rng, rng.randint(2, 5))
        out[f"chain_{seed}"] = (ds.take_all(), ds.count(), ds.explain())
        ctx.optimizer_enabled = False
        try:
            out[f"chain_{seed}_unoptimized"] = (ds.take_all(), ds.explain())
        finally:
            ctx.optimizer_enabled = True

    nums = np.random.default_rng(7).permutation(60)
    items = [{"k": int(x), "g": int(x) % 3, "v": float(x) / 4} for x in nums]
    ds = rd.from_items(items, parallelism=4)
    out["sort"] = (ds.sort("k").take_all(),
                   ds.sort("v", descending=True).take(7))
    out["groupby"] = sorted(
        (r["g"], r["count()"]) for r in ds.groupby("g").count().take_all()
    ) + sorted(_plain(ds.groupby("g").sum("v").take_all()),
               key=lambda r: r["g"])
    out["aggregates"] = [ds.sum("v"), ds.min("k"), ds.max("k"),
                         ds.mean("v"), ds.std("v")]
    out["shuffle"] = [r["k"] for r in ds.random_shuffle(seed=11).take_all()]
    out["repartition"] = (ds.repartition(3).num_blocks(),
                          [r["k"] for r in ds.repartition(3).take_all()])
    out["split"] = [s.count() for s in ds.split(4, equal=True)]
    right = rd.from_items([{"k": i, "b": i * 10} for i in range(0, 60, 2)],
                          parallelism=3)
    out["join"] = sorted(
        (r["k"], r["b"]) for r in ds.join(right, on="k").take_all())
    out["join_left"] = sorted(
        (r["k"], r.get("b")) for r in ds.join(right, on="k",
                                               how="left").take_all())
    out["zip"] = rd.from_items([{"x": i} for i in range(12)],
                               parallelism=3).zip(rd.from_items(
                                   [{"y": i * 10} for i in range(12)],
                                   parallelism=4)).take_all()
    rg = rd.range(1000, parallelism=7)
    out["batches"] = [b["id"].tolist() for b in rg.map_batches(
        lambda b: {"id": b["id"] * 3}).iter_batches(batch_size=128)]
    lim = rg.limit(3).map_batches(
        lambda b: {"id": b["id"], "two": b["id"] * 2})
    out["limit"] = (lim.take_all(), lim.count(), lim.explain(),
                    rg.map(lambda r: r).limit(77).count())
    out["metadata"] = (rg.count(), rg.schema(), rg.num_blocks(),
                       rg.repartition(5).num_blocks())
    out["flat_map_filter"] = rd.from_items(list(range(20))).flat_map(
        lambda x: [x, -x]).filter(lambda x: x % 3 != 0).take_all()

    _write_parquet(root)
    pq = rd.read_parquet(str(root))
    proj = pq.select_columns(["a"]).filter(expr=("a", ">=", 25))
    out["parquet"] = (pq.count(), pq.schema(), sorted(
        r["a"] for r in proj.take_all()), proj.explain(), pq.sum("a"))
    (root / "t.csv").write_text("x,y\n1,a\n2,b\n3,c\n")
    out["csv"] = rd.read_csv(str(root / "t.csv")).take_all()
    import sqlite3

    db = str(root / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, v REAL, s TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?, ?)",
                     [(i, i * 0.5, f"x{i}") for i in range(50)])
    conn.commit()
    conn.close()
    sql = rd.read_sql("SELECT * FROM t", functools.partial(
        sqlite3.connect, db), parallelism=2, partition_column="id",
        lower_bound=0, upper_bound=50).select_columns(["id", "v"])
    out["sql"] = (sorted(r["id"] for r in sql.take_all()), sql.explain())
    return {k: _plain(v) if isinstance(v, list) and v and isinstance(
        v[0], dict) else v for k, v in out.items()}


def _on_cluster(rt, num_cpus, fn, *args):
    """``fn(*args)`` on a cluster of package ``rt`` with the cyclic GC off:
    garbage of earlier tests is collected before the cluster starts and
    this program's after it ends, so no ObjectRef finaliser runs inside
    the JAX package's ReferenceCounter lock (its deadlock, ROADMAP Queue
    3)."""
    gc.collect()
    gc.disable()
    rt.init(num_cpus=num_cpus)
    try:
        return fn(*args)
    finally:
        rt.shutdown()
        gc.enable()
        gc.collect()


def _run(rt, rd, root) -> dict:
    return _on_cluster(rt, 4, _program, rd, root)


KEYS = ([f"chain_{s}" for s in CHAIN_SEEDS]
        + [f"chain_{s}_unoptimized" for s in CHAIN_SEEDS]
        + ["sort", "groupby", "aggregates", "shuffle", "repartition", "split",
           "join", "join_left", "zip", "batches", "limit", "metadata",
           "flat_map_filter", "parquet", "csv", "sql"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {"jax": _run(ray_tpu, jdata, tmp_path_factory.mktemp("jax")),
            "port": _run(ray_tpu_torch, tdata,
                         tmp_path_factory.mktemp("port"))}


@pytest.mark.parametrize("key", KEYS)
def test_port_data_matches_jax(results, key):
    assert results["port"][key] == results["jax"][key]


def test_the_program_computed_something(results):
    """Both packages agree, and on results that are not empty."""
    got = results["port"]
    assert sorted(got) == sorted(KEYS)
    assert [r["k"] for r in got["sort"][0]] == list(range(60))
    assert got["split"] == [15, 15, 15, 15]
    assert got["limit"][:2] == ([{"id": i, "two": 2 * i} for i in range(3)],
                                3)
    assert "Rules fired:" in got["parquet"][3]
    assert sorted(got["shuffle"]) == list(range(60))


# -- iter_batches(device_put=True) ------------------------------------------

NUMERIC = ("int64", "int32", "int16", "int8", "uint64", "uint32", "uint16",
           "uint8", "float64", "float32", "float16", "bool", "complex128",
           "complex64", "bfloat16")
NOT_NUMERIC = {"str": np.array(["a", "bc", "d"]),
               "bytes": np.array([b"a", b"bc", b"d"]),
               "object": np.array([{"x": 1}, None, 3], dtype=object)}


def _columns():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 100, 3) - 40
    out = {}
    for name in NUMERIC:
        dt = ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)
        a = vals if name[0] not in "ub" else np.abs(vals)
        out[name] = (a % 2 == 0) if name == "bool" else a.astype(dt)
    return out


def _device_put_batches(rt, rd, columns) -> dict:
    """Each column as the one batch of a one-block Dataset, through
    ``iter_batches(device_put=True)``: (dtype name, values as numpy) or the
    error's type name. JAX's arrays come back as numpy by
    ``np.asarray``."""
    out = {}
    for name, col in columns.items():
        ds = rd.Dataset(_refs=[rt.put({"c": col})])
        try:
            (batch,) = list(ds.iter_batches(batch_size=None, device_put=True))
            got = np.asarray(batch["c"])
            out[name] = (str(got.dtype), got.tolist())
        except Exception as e:  # the type of the refusal is compared
            out[name] = type(e).__name__
    return out


@pytest.fixture(scope="module")
def jax_device_put():
    return _on_cluster(ray_tpu, 2, _device_put_batches, ray_tpu, jdata,
                       {**_columns(), **NOT_NUMERIC})


@pytest.fixture(scope="module")
def port_device_put():
    with spawn(timeout=300) as call:
        yield call("data_device_put", {**_columns(), **NOT_NUMERIC})


@pytest.mark.parametrize("name", NUMERIC)
def test_device_put_gives_jax_dtypes(jax_device_put, port_device_put, name):
    assert port_device_put["batches"][name] == jax_device_put[name]
    assert jax_device_put[name][0] == {
        "int64": "int32", "uint64": "uint32", "float64": "float32",
        "complex128": "complex64"}.get(name, name)


@pytest.mark.parametrize("name", sorted(NOT_NUMERIC))
def test_device_put_refuses_what_jax_refuses(jax_device_put,
                                             port_device_put, name):
    assert jax_device_put[name] == "TypeError"
    assert port_device_put["batches"][name] == "TypeError"


def test_device_put_has_no_cpu_fallback(port_device_put):
    """Without ``device`` the batches go to CUDA; where there is none,
    ``iter_batches`` raises instead of keeping them on the CPU."""
    got = port_device_put["default_device"]
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    assert got["error"] is not None and "CUDA" in got["error"]
