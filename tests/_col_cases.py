"""Collective cases run inside the member actors of a cluster of either
package: the JAX package's ``ray_tpu.util.collective`` (backend "xla") and
the port's ``ray_tpu_torch.util.collective`` (backend "gloo").

Imports neither torch nor JAX at the top: the tests register this module
with ``cloudpickle.register_pickle_by_value`` and ship ``Member`` and the
cases by value (``Member.call`` takes a case as cloudpickled bytes), so the
members of both clusters run the same code on the same numpy inputs.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

OPS = ("sum", "product", "max", "min")


class Member:
    """One rank; ``pkg`` is "ray_tpu" or "ray_tpu_torch"."""

    def __init__(self, rank, pkg):
        self.rank, self.pkg = rank, pkg
        if pkg == "ray_tpu":
            # single-device CPU jax in this fresh worker (drop any inherited
            # device-count flag before jax is imported)
            os.environ["JAX_PLATFORMS"] = "cpu"
            flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f]
            os.environ["XLA_FLAGS"] = " ".join(flags)
            import jax

            jax.config.update("jax_platforms", "cpu")
        else:
            import torch

            torch.set_num_threads(1)

    def call(self, case_bytes, *args):
        import cloudpickle

        return cloudpickle.loads(case_bytes)(self.rank, self.pkg, *args)


def _col(pkg):
    return importlib.import_module(f"{pkg}.util.collective")


def parity_ops(rank, pkg, world, backend, group, inputs):
    """Every op of the collective API on ``inputs[rank]`` (numpy): {name:
    numpy result}. The same program in both packages."""
    col = _col(pkg)
    x, xi = inputs[rank]["x"], inputs[rank]["xi"]
    col.init_collective_group(world, rank, backend=backend, group_name=group)
    out = {}
    for op in OPS:
        out[f"allreduce_{op}"] = col.allreduce(x[0], op=op, group_name=group)
        out[f"reducescatter_{op}"] = col.reducescatter(x, op=op,
                                                       group_name=group)
    out["allreduce_int"] = col.allreduce(xi, group_name=group)
    out["reduce"] = col.reduce(x[1], dst_rank=1, op="sum", group_name=group)
    out["broadcast"] = col.broadcast(x[2 % world], src_rank=world - 1,
                                     group_name=group)
    out["allgather"] = col.allgather(x[0], group_name=group)
    ring = [(r, (r + 1) % world) for r in range(world)]
    out["permute_ring"] = col.permute(x[0], ring, group_name=group)
    out["permute_one"] = col.permute(x[1], [(0, world - 1)],
                                     group_name=group)
    col.barrier(group_name=group)
    if rank == 0:
        for dst in range(1, world):
            col.send(x * (dst + 1), dst_rank=dst, group_name=group)
    else:
        got = col.recv(src_rank=0, group_name=group)
        out["recv"] = (got.dtype.str, got.shape, got.tobytes())
    col.barrier(group_name=group)
    col.destroy_collective_group(group)
    return {k: (np.asarray(v) if k != "recv" else v) for k, v in out.items()}


def world_one(rank, pkg, backend, group, x):
    """Each op at world 1, and whether it handed back the input itself."""
    col = _col(pkg)
    col.init_collective_group(1, 0, backend=backend, group_name=group)
    out = {}
    for name, fn in (
            ("allreduce", lambda: col.allreduce(x, group_name=group)),
            ("reduce", lambda: col.reduce(x, group_name=group)),
            ("broadcast", lambda: col.broadcast(x, group_name=group)),
            ("allgather", lambda: col.allgather(x, group_name=group)),
            ("reducescatter", lambda: col.reducescatter(x, group_name=group)),
            ("permute", lambda: col.permute(x, [(0, 0)], group_name=group))):
        got = fn()
        out[name] = (got is x, np.asarray(got))
    col.destroy_collective_group(group)
    return out


# -- the port's own cases (torch imported inside) ----------------------------


def port_allreduce_multiprocess(rank, pkg, world, group):
    """test_collective_tpu.py::test_collective_allreduce_multiprocess."""
    col = _col(pkg)
    col.init_collective_group(world, rank, backend="gloo", group_name=group)
    x = np.arange(4.0, dtype=np.float32) + rank * 10
    s = col.allreduce(x, group_name=group)
    bc = col.broadcast(np.full((2,), float(rank), np.float32),
                       src_rank=1, group_name=group)
    ag = col.allgather(np.array([float(rank)], np.float32),
                       group_name=group)
    col.barrier(group_name=group)
    rs_in = np.stack([np.full((2,), float(rank), np.float32)
                      for _ in range(world)])
    rs = col.reducescatter(rs_in, group_name=group)
    col.destroy_collective_group(group)
    return s.tolist(), bc.tolist(), ag.ravel().tolist(), rs.tolist()


def port_tensors(rank, pkg, world, group):
    """test_collective_tpu.py::test_collective_device_arrays_no_host_
    roundtrip: a tensor in gives a tensor out (bf16 kept), and an ObjectRef
    of a tensor this process put resolves through rdt to the tensor
    itself (a device hit, no rebuild)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental.rdt import device_object_manager

    col = _col(pkg)
    col.init_collective_group(world, rank, backend="gloo", group_name=group)
    x = torch.arange(4.0) + rank * 10
    s = col.allreduce(x, group_name=group)
    xb = x.to(torch.bfloat16)
    sb = col.allreduce(xb, group_name=group)
    doubled = (s * 2).tolist()
    stats = device_object_manager().stats
    hits = stats["device_hits"]
    ones = torch.ones(3) * (rank + 1)
    ref = rt.put(ones)
    s2 = col.allreduce(ref, group_name=group)
    hit = stats["device_hits"] - hits
    ag = col.allgather(xb, group_name=group)
    rs = col.reducescatter(torch.stack([x] * world), group_name=group)
    col.destroy_collective_group(group)
    return {"types": [type(v).__name__ for v in (s, sb, s2, ag, rs)],
            "dtypes": [str(v.dtype) for v in (s, sb, ag, rs)],
            "doubled": doubled, "bf16": sb.float().tolist(),
            "s2": s2.tolist(), "rdt_hits": hit, "ag": ag.float().tolist(),
            "rs": rs.tolist()}


def port_send_recv(rank, pkg, group):
    """test_collective_tpu.py::test_collective_send_recv, and a bf16 tensor
    that arrives as a CPU tensor of its own dtype."""
    import torch

    col = _col(pkg)
    col.init_collective_group(2, rank, backend="gloo", group_name=group)
    if rank == 0:
        col.send(np.arange(6.0).reshape(2, 3), dst_rank=1, group_name=group)
        col.send(torch.arange(4, dtype=torch.bfloat16) / 4, dst_rank=1,
                 group_name=group)
        out = None
    else:
        a = col.recv(src_rank=0, group_name=group)
        t = col.recv(src_rank=0, group_name=group)
        out = (type(a).__name__, a.tolist(), type(t).__name__, str(t.dtype),
               str(t.device), t.float().tolist())
    col.barrier(group_name=group)
    col.destroy_collective_group(group)
    return out


def port_reducescatter_permute(rank, pkg, world, group):
    """test_collective_tpu.py::test_reducescatter_output_never_replicated_
    and_permute: rank j gets the reduced row j, permute swaps, a rank that
    is no destination gets zeros, and permute's validation errors."""
    col = _col(pkg)
    col.init_collective_group(world, rank, backend="gloo", group_name=group)
    rs_in = np.stack([np.full((2,), float(rank + j), np.float32)
                      for j in range(world)])
    rs = col.reducescatter(rs_in, group_name=group)
    swap = col.permute(np.full((2,), float(rank), np.float32),
                       perm=[(0, 1), (1, 0)], group_name=group)
    errors = []
    for bad in ([(0, world)], [(0, 1), (2 % world, 1)]):
        try:
            col.permute(np.zeros(2, np.float32), bad, group_name=group)
        except ValueError as e:
            errors.append(str(e))
    try:
        col.reducescatter(np.zeros((world + 1, 2)), group_name=group)
    except ValueError as e:
        errors.append(str(e))
    col.destroy_collective_group(group)
    return rs.tolist(), swap.tolist(), errors


def port_device_channel(rank, pkg, group):
    """test_collective_tpu.py::test_device_channel_stage_handoff on a gloo
    pair: 3 sequential typed transfers (a torch dtype; a numpy dtype for
    the second channel), the shape checked."""
    import torch

    from ray_tpu_torch.experimental.device_channel import DeviceChannel

    col = _col(pkg)
    col.init_collective_group(2, rank, backend="gloo", group_name=group)
    ch = DeviceChannel(group, src_rank=0, dst_rank=1, shape=(4, 8),
                       dtype=torch.bfloat16)
    ch_np = DeviceChannel(group, src_rank=0, dst_rank=1, shape=(2,),
                          dtype=np.float32)
    if rank == 0:
        for i in range(3):
            ch.write(np.full((4, 8), float(i + 1), np.float32))
        ch_np.write(np.array([5.0, 6.0]))
        try:
            ch.write(torch.zeros(4, 9))
            err = None
        except ValueError as e:
            err = str(e)
        col.destroy_collective_group(group)
        return err
    got = []
    for _ in range(3):
        out = ch.read()
        got.append((type(out).__name__, str(out.dtype), str(out.device),
                    float(out[0, 0]), tuple(out.shape)))
    v = ch_np.read()
    col.destroy_collective_group(group)
    return got, (str(v.dtype), v.tolist())


def port_inputs_unchanged(rank, pkg, world, group):
    """Every op leaves its input as it was (torch's collectives write in
    place; the port copies first), for numpy and for CPU tensors."""
    import torch

    col = _col(pkg)
    col.init_collective_group(world, rank, backend="gloo", group_name=group)
    rng = np.random.default_rng(rank)
    x = rng.standard_normal((world, 5)).astype(np.float32)
    t = torch.from_numpy(x.copy())
    keep_x, keep_t = x.copy(), t.clone()
    same = {}
    for name, fn in (
            ("allreduce", lambda v: col.allreduce(v[0], group_name=group)),
            ("reduce", lambda v: col.reduce(v[0], dst_rank=0,
                                            group_name=group)),
            ("broadcast", lambda v: col.broadcast(v[0], src_rank=1,
                                                  group_name=group)),
            ("allgather", lambda v: col.allgather(v[0], group_name=group)),
            ("reducescatter", lambda v: col.reducescatter(
                v, group_name=group)),
            ("permute", lambda v: col.permute(
                v[0], [(0, 1), (1, 0)], group_name=group))):
        fn(x)
        fn(t)
        same[name] = (bool(np.array_equal(x, keep_x)),
                      bool(torch.equal(t, keep_t)))
    col.destroy_collective_group(group)
    return same


def port_refusals(rank, pkg):
    """backend "xla" refused with both backends named; "nccl" refused on a
    host without CUDA."""
    col = _col(pkg)
    out = {}
    for backend in ("xla", "nccl"):
        try:
            col.init_collective_group(1, 0, backend=backend,
                                      group_name=f"refused-{backend}")
            out[backend] = None
        except (ValueError, RuntimeError) as e:
            out[backend] = (type(e).__name__, str(e))
    return out


def port_groups_beside_default(config=None):
    """A TorchTrainer train fn (world 2): the default group from
    ``setup_torch_distributed``, two collective groups beside it; the
    first's destroy leaves the second and the default group working."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train import setup_torch_distributed
    from ray_tpu_torch.util import collective as col

    setup_torch_distributed(backend="gloo")
    rank = train.get_context().get_world_rank()
    tag = config["tag"]
    for g in ("a", "b"):
        col.init_collective_group(2, rank, backend="gloo",
                                  group_name=f"{tag}-{g}")
    before = [float(col.allreduce(torch.ones(1) * (rank + 1),
                                  group_name=f"{tag}-{g}")) for g in "ab"]
    col.destroy_collective_group(f"{tag}-a")
    after_b = float(col.allreduce(torch.ones(1) * (rank + 1),
                                  group_name=f"{tag}-b"))
    t = torch.ones(1) * (rank + 1)
    dist.all_reduce(t)
    col.destroy_collective_group(f"{tag}-b")
    t2 = torch.ones(1)
    dist.all_reduce(t2)
    train.report({"step": 0, "rank": rank, "before": before,
                  "after_b": after_b, "default": float(t),
                  "default_after": float(t2),
                  "a_alive": col.is_group_initialized(f"{tag}-a"),
                  "default_alive": dist.is_initialized()})
