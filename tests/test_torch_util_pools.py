"""The port's util pools (``ray_tpu_torch.util``: ``ActorPool``, the
distributed ``Queue``, ``multiprocessing.Pool`` and the joblib backend),
copies of the JAX package's: the cases of ``test_util_ecosystem.py`` (7)
and ``test_mp_joblib.py`` (5) on one cluster of the port's runtime for the
module (JAX's second file starts one a test). The runtime imports no torch, so these run
in the pytest worker."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def ray_init():
    info = ray_tpu_torch.init(num_cpus=8)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Doubler:
    def double(self, x):
        return x * 2


def test_actor_pool_map_ordered(ray_init):
    pool = ActorPool([_Doubler.remote() for _ in range(3)])
    results = list(pool.map(lambda a, v: a.double.remote(v), range(10)))
    assert results == [i * 2 for i in range(10)]


def test_actor_pool_map_unordered(ray_init):
    pool = ActorPool([_Doubler.remote() for _ in range(3)])
    results = list(
        pool.map_unordered(lambda a, v: a.double.remote(v), range(10)))
    assert sorted(results) == [i * 2 for i in range(10)]


def test_actor_pool_submit_get(ray_init):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    pool.submit(lambda a, v: a.double.remote(v), 1)
    pool.submit(lambda a, v: a.double.remote(v), 2)
    assert not pool.has_free()
    assert pool.get_next(timeout=60) == 2
    assert pool.get_next(timeout=60) == 4
    assert pool.has_free()
    assert not pool.has_next()


def test_queue_basic(ray_init):
    q = Queue()
    q.put("a")
    q.put("b")
    assert q.qsize() == 2
    assert q.get(timeout=30) == "a"
    assert q.get(timeout=30) == "b"
    assert q.empty()
    with pytest.raises(Empty):
        q.get_nowait()
    q.shutdown()


def test_queue_maxsize_and_batches(ray_init):
    q = Queue(maxsize=3)
    q.put_nowait_batch([1, 2, 3])
    assert q.full()
    with pytest.raises(Full):
        q.put_nowait(4)
    assert q.get_nowait_batch(2) == [1, 2]
    assert q.get_nowait_batch(5) == [3]
    q.shutdown()


def test_queue_across_tasks(ray_init):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return n

    @ray_tpu_torch.remote
    def consumer(q, n):
        return [q.get(timeout=60) for _ in range(n)]

    pref = producer.remote(q, 5)
    cref = consumer.remote(q, 5)
    assert ray_tpu_torch.get(pref, timeout=60) == 5
    assert sorted(ray_tpu_torch.get(cref, timeout=60)) == [0, 1, 2, 3, 4]
    q.shutdown()


def test_queue_blocking_timeout(ray_init):
    q = Queue()
    with pytest.raises(Empty):
        q.get(timeout=0.5)
    q.shutdown()


# -- test_mp_joblib.py ------------------------------------------------------


def test_pool_map_and_apply(ray_init):
    from ray_tpu_torch.util.multiprocessing import Pool

    sq = lambda x: x * x  # noqa: E731 — by-value pickling for workers
    add = lambda a, b: a + b  # noqa: E731

    with Pool(processes=2) as p:
        assert p.map(sq, range(10)) == [x * x for x in range(10)]
        assert p.apply(add, (3, 4)) == 7
        r = p.apply_async(add, (10, 20))
        assert r.get(timeout=30) == 30
        assert r.successful()


def test_pool_starmap_imap(ray_init):
    from ray_tpu_torch.util.multiprocessing import Pool

    sq = lambda x: x * x  # noqa: E731
    add = lambda a, b: a + b  # noqa: E731

    with Pool(processes=2) as p:
        assert p.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        assert list(p.imap(sq, range(6), chunksize=2)) == [0, 1, 4, 9, 16, 25]
        assert sorted(p.imap_unordered(sq, range(6), chunksize=2)) == [
            0, 1, 4, 9, 16, 25
        ]


def test_pool_error_propagates(ray_init):
    from ray_tpu_torch.util.multiprocessing import Pool

    def boom(x):
        raise RuntimeError("pool boom")

    with Pool(processes=1) as p:
        with pytest.raises(Exception, match="pool boom"):
            p.map(boom, [1])


def test_pool_initializer(ray_init):
    from ray_tpu_torch.util.multiprocessing import Pool

    def init_env(val):
        import os

        os.environ["POOL_INIT"] = val

    def read_env(_):
        import os

        return os.environ.get("POOL_INIT")

    with Pool(processes=2, initializer=init_env, initargs=("yes",)) as p:
        assert p.map(read_env, range(4)) == ["yes"] * 4


def test_joblib_backend(ray_init):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray_tpu

    sq = lambda x: x * x  # noqa: E731

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=4):
        out = joblib.Parallel()(joblib.delayed(sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]
