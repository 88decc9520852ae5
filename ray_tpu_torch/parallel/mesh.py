"""Device meshes and sharding for the PyTorch port — counterpart of
``ray_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.DeviceMesh`` with the JAX package's axis
names, outermost first:

    pp    — pipeline parallel
    dp    — data parallel (gradient all-reduce)
    fsdp  — fully-sharded data parallel (ZeRO-3: weights gathered at use)
    tp    — tensor parallel (Megatron column / row parallel)
    sp    — sequence/context parallel (ring attention / Ulysses)

Each process is one mesh position. The processes start the default process
group themselves (``torch.distributed.init_process_group`` with an address,
a world size and a rank: the counterpart of JAX's ``jax.distributed``
bootstrap), and ``MeshSpec.build`` lays the mesh over that group, one
sub-group per axis.

Sharding is explicit, in JAX's terms: a spec (``P``, JAX's
``PartitionSpec``) names, for each dim of a global tensor, the mesh axes it
is split over, and ``shard_of`` cuts out the block that JAX's
``NamedSharding`` places on this rank's mesh position (``gather_full`` is
the inverse). Where the axes do not divide a dim, the blocks are GSPMD's:
ceil(n / k) long, the last ones short or empty (``block_range``); the
gathers then pad each block for the collective and cut the padding off.
Each rank holds only its blocks; the models (``models/llama.py``,
``models/vit.py``) move data between them with the collectives below,
where GSPMD would insert them:

* ``all_gather`` — tiled all-gather whose backward reduce-scatters: the
  fsdp gather of a weight at use, and the K/V all-gather of plain
  attention on a sequence sharded over sp;
* ``copy_to`` / ``reduce_from`` — Megatron's pair around a column- then
  row-parallel product: identity forward and all-reduce backward, and the
  reverse;
* ``gather_from`` — all-gather of an activation that every rank of the
  axis needs whole, whose backward keeps this rank's slice: the gradient
  is already whole on each rank, so summing it would count it once a rank;
* ``AllToAll`` — chunk j of the first dim to rank j, its own gradient
  (Ulysses, the MoE exchange);
* ``AxisRing`` — point-to-point transfers between neighbours of one axis
  (JAX's ``ppermute``): ring attention's K/V rotation over sp, the
  pipeline's stage hand-offs over pp.

``ShardingRules`` and ``host_local_mesh_info`` are the JAX package's.
``logical_to_sharding``, ``constrain`` and ``to_varying`` have no
counterpart: a spec is placed by ``shard_of`` with no sharding object
between, no compiler propagates a constraint (the models call the
collectives themselves), and no ``shard_map`` marks values as varying.

A gloo group's transport takes host memory only, so collectives on a gloo
group stage CUDA tensors through the host (``stage``): that is how several
ranks share one GPU, where NCCL refuses two ranks on one device. On an
NCCL group the same code runs with no staging; that path is untested until
a host with several cards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "tp", "sp")

# Batch is sharded over both data axes; sequence over sp.
BATCH_AXES = ("dp", "fsdp")


def P(*dims) -> tuple:
    """JAX's ``PartitionSpec``, as a plain tuple: for each dim of a global
    tensor, the mesh axis it is split over, a tuple of axes (split over
    their product, the first outermost) or None (whole on every rank).
    Dims past its length are whole."""
    return dims


def data_spec() -> tuple:
    """(batch, seq) token arrays."""
    return P(BATCH_AXES, "sp")


def activation_spec() -> tuple:
    """(batch, seq, model) activations."""
    return P(BATCH_AXES, "sp", None)


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axis size 1 = that parallelism disabled."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.pp, self.dp, self.fsdp, self.tp, self.sp)

    @property
    def num_devices(self) -> int:
        return self.pp * self.dp * self.fsdp * self.tp * self.sp

    def build(self):
        """A ``DeviceMesh`` with dim names ``AXES`` over the initialised
        default process group, rank r at row-major position r (sp
        innermost, as the JAX package orders devices). The group must hold
        exactly ``num_devices`` ranks. The mesh is a "cuda" one on an NCCL
        group and a "cpu" one otherwise (a gloo group moves host
        tensors)."""
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError(
                "MeshSpec.build needs torch.distributed.init_process_group "
                "first (its address, world size and rank)")
        world = dist.get_world_size()
        if world != self.num_devices:
            raise ValueError(f"mesh {self.shape} needs {self.num_devices} "
                             f"ranks, the process group has {world}")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device_type, self.shape, mesh_dim_names=AXES)

    @classmethod
    def for_devices(cls, n: int, tp: int = 1, sp: int = 1) -> "MeshSpec":
        """A sensible default: fill remaining devices with fsdp."""
        rest = n // (tp * sp)
        return cls(dp=1, fsdp=rest, tp=tp, sp=sp)


@dataclass
class ShardingRules:
    """Logical name -> spec (``P``) table, the JAX package's: ``spec(name)``
    is the named entry's spec, ``P()`` (whole on every rank) for a name
    the table does not hold. JAX's ``sharding(mesh, name)`` (a
    ``NamedSharding``) has no counterpart: ``shard_of`` takes the spec and
    the mesh as they are."""

    rules: Dict[str, tuple] = field(default_factory=dict)

    def spec(self, name: str) -> tuple:
        return self.rules.get(name, P())


def host_local_mesh_info(mesh) -> dict:
    """Which mesh coordinates this process holds, with the JAX package's
    keys: ``process_index`` (this process's rank in the default group),
    ``process_count`` (the group's size) and ``local_coords`` (the mesh
    coordinates, in ``AXES`` order, of the devices it drives). A process of
    the port is one mesh position, so ``local_coords`` holds one coordinate
    and ``process_count`` is the mesh's size; in JAX one process drives
    every device of its host (8 CPU devices in the tests: one process, 8
    coordinates)."""
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": (dist.get_world_size() if dist.is_initialized()
                          else 1),
        "local_coords": [tuple(int(i) for i in mesh.get_coordinate())],
    }


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, as the JAX package's ``mesh.shape``; every axis 1
    for no mesh."""
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    if mesh is None or mesh_shape(mesh)[axis] == 1:
        return 0
    return mesh.get_local_rank(axis)


def _dim_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec splits its dim over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_range(n: int, k: int, i: int) -> Tuple[int, int]:
    """(start, length) of block ``i`` of a dim of ``n`` split into ``k``
    blocks as JAX's GSPMD splits it: blocks of ceil(n / k), so where k does
    not divide n the last blocks are short or empty (GSPMD pads them at
    the end)."""
    size = -(-n // k)
    start = min(i * size, n)
    return start, min(size, n - start)


def is_split(spec, mesh) -> bool:
    """Whether an axis of size > 1 splits a dim under ``spec``: otherwise
    every rank holds the whole tensor."""
    shape = mesh_shape(mesh)
    return any(shape[a] > 1 for entry in spec for a in _dim_axes(entry))


def block_bounds(global_shape, spec, mesh) -> list:
    """[start, stop) of this rank's block in each dim of a tensor of
    ``global_shape`` under ``spec``: the region JAX's
    ``NamedSharding(mesh, spec)`` puts on the device at this rank's mesh
    position, as its shards' ``index`` gives it. A dim split over several
    axes is cut into their product of blocks, the first axis outermost; a
    dim they do not divide is cut as GSPMD cuts it (``block_range``), so
    a block may be short or empty."""
    shape = mesh_shape(mesh)
    bounds = [[0, int(d)] for d in global_shape]
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        n = math.prod(shape[a] for a in axes)
        if n == 1:
            continue
        block = 0
        for a in axes:
            block = block * shape[a] + axis_index(mesh, a)
        start, length = block_range(int(global_shape[dim]), n, block)
        bounds[dim] = [start, start + length]
    return bounds


def shard_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``
    (``block_bounds``), a view."""
    for dim, (start, stop) in enumerate(block_bounds(t.shape, spec, mesh)):
        if stop - start != t.shape[dim]:
            t = t.narrow(dim, start, stop - start)
    return t


def global_shapes(blocks, specs, mesh) -> list:
    """The global shape of each tensor of ``blocks``, this rank's blocks
    under ``specs`` (one spec each): a split dim's length summed over the
    ranks that hold its other blocks, one all-reduce for each combination
    of axes. Every rank calls it together."""
    shapes = [list(t.shape) for t in blocks]
    by_axes = {}
    for i, spec in enumerate(specs):
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in _dim_axes(entry)
                         if mesh_shape(mesh)[a] > 1)
            if axes:
                by_axes.setdefault(axes, []).append((i, dim))
    for axes, where in by_axes.items():
        lengths = [torch.tensor(float(shapes[i][dim]),
                                device=blocks[i].device) for i, dim in where]
        all_reduce_sum(lengths, mesh, axes)
        for (i, dim), n in zip(where, lengths):
            shapes[i][dim] = int(n.item())
    return [tuple(s) for s in shapes]


def gather_full(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block ``t`` under ``spec``, on
    every rank (``shard_of``'s inverse, uneven blocks included; no
    gradient). For tests, checks and checkpoints: the model itself never
    holds a whole weight."""
    shape = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        # the innermost axis's blocks are adjacent: gather it first
        for a in reversed(_dim_axes(entry)):
            if shape[a] > 1:
                group = mesh.get_group(a)
                lengths = _gather(torch.tensor([t.shape[dim]],
                                               device=t.device), group, 0)
                t = _gather(t, group, dim, lengths.tolist())
    return t


def axes_group(mesh, axes):
    """The process group of the ranks that differ from this one only on
    ``axes``: e.g. ("dp", "fsdp", "sp"), the ranks whose data this rank's
    loss and gradients are summed with. Every rank must call it together
    the first time for each ``axes`` (it creates one group per combination
    of the other axes' coordinates, in one order); the groups are kept on
    the mesh."""
    groups = mesh.__dict__.setdefault("_axes_groups", {})
    key = tuple(axes)
    if key not in groups:
        names = list(mesh.mesh_dim_names)
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(len(names)) if i not in inner]
        n = math.prod(mesh.mesh.shape[i] for i in inner)
        rows = mesh.mesh.permute(*outer, *inner).reshape(-1, n).tolist()
        me = dist.get_rank()
        for ranks in rows:
            group = dist.new_group(ranks)
            if me in ranks:
                groups[key] = group
    return groups[key]


def all_reduce_sum(tensors, mesh, axes):
    """Sum each tensor over the ranks that differ from this one on
    ``axes`` (those of size 1 dropped), in place, as one flat fp32 buffer
    (one collective; through host memory on gloo). Nothing to do when the
    axes are all of size 1."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in axes if shape[a] > 1)
    if not axes or not tensors:
        return
    group = axes_group(mesh, axes)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    wire = to_wire(flat, stage(group))
    dist.all_reduce(wire, group=group)
    flat = wire.to(flat.device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def tree_map(fn, tree, *rest):
    """``fn(leaf, *others)`` over a nested dict of tensors, as a dict of the
    same nesting; each of ``rest`` is a dict with the same keys (e.g. the
    specs of ``param_specs``) whose entry at the leaf's key path is passed
    along, whatever it holds there."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def shard_train_state(params, optimizer, specs, mesh):
    """Place a (params, optimizer) state of global tensors on ``mesh``, in
    place — the counterpart of the JAX package's ``shard_train_state``:
    each parameter keeps its identity and its data becomes this rank's
    block (``shard_of``, a copy), and each optimizer state tensor of the
    parameter's shape (AdamW's moments) is cut the same way. The moments
    are keyed by their parameter, so they follow it with no key-path
    matching; scalars (the step) stay. Returns (params, optimizer)."""
    def place(leaf, spec):
        whole = leaf.shape
        leaf.grad = None
        leaf.data = shard_of(leaf.data, spec, mesh).clone()
        moments = optimizer.state.get(leaf, {})
        for name, value in moments.items():
            if torch.is_tensor(value) and value.shape == whole:
                moments[name] = shard_of(value, spec, mesh).clone()

    tree_map(place, params, specs)
    return params, optimizer


def stage(group) -> bool:
    """Whether collectives on ``group`` must take CUDA tensors through host
    memory: ProcessGroupGloo hands a tensor's raw pointer to its TCP
    transport."""
    return dist.get_backend(group) == "gloo"


def to_wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` as a collective on a (``staged``) group takes it: contiguous,
    and in host memory when staged."""
    t = t.contiguous()
    return t.cpu() if staged else t


class AxisRing:
    """The ranks of the mesh's ``axis`` as a ring, in axis order: this
    rank's index on it and the transfer of tensors between neighbours
    (JAX's ``ppermute`` over the axis). Ring attention rotates K/V one step
    around it (``start``); the pipeline hands activations to the next
    stage and gradients to the previous one (``exchange``, either way
    alone)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.size = mesh_shape(mesh)[axis]
        self.idx = axis_index(mesh, axis)
        # global ranks of the axis's positions, in axis order
        self.ranks = dist.get_process_group_ranks(self.group)
        self.staged = stage(self.group)

    def start(self, *tensors, tag: int = 0) -> "Transfer":
        """Post the sends of ``tensors`` to the next rank and the receives
        of the previous rank's, of the same shapes (tags from ``tag`` up,
        so two transfers may be in flight); ``wait()`` on the result
        returns them."""
        return self.exchange(tensors, [(t.shape, t.dtype, t.device)
                                       for t in tensors], tag=tag)

    def exchange(self, sends=(), recvs=(), step: int = 1,
                 tag: int = 0) -> "Transfer":
        """Post the sends of the tensors ``sends`` to the rank ``step``
        places on along the axis, and receives of tensors of
        ``recvs``' (shape, dtype, device) from the rank ``step`` places
        back (tags from ``tag`` up); ``wait()`` on the result returns the
        received tensors, each on its device. Either list may be empty;
        each pair of ranks must post their sends and receives in one
        order."""
        to = self.ranks[(self.idx + step) % self.size]
        frm = self.ranks[(self.idx - step) % self.size]
        sends = [to_wire(t, self.staged) for t in sends]
        bufs = [torch.empty(shape, dtype=dtype,
                            device="cpu" if self.staged else device)
                for shape, dtype, device in recvs]
        ops = [dist.P2POp(dist.isend, t, to, self.group, tag=tag + n)
               for n, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group, tag=tag + n)
                for n, t in enumerate(bufs)]
        works = dist.batch_isend_irecv(ops) if ops else []
        return Transfer(works, sends, bufs, [d for _, _, d in recvs])


class Transfer:
    """Posted sends and receives; the send buffers live until ``wait``."""

    def __init__(self, works, sends, recvs, devices):
        self.works, self.sends, self.recvs = works, sends, recvs
        self.devices = devices

    def wait(self) -> tuple:
        for w in self.works:
            w.wait()
        return tuple(t.to(d) for t, d in zip(self.recvs, self.devices))


def _gather(x: torch.Tensor, group, dim: int, lengths=None) -> torch.Tensor:
    """The blocks ``x`` of every rank of ``group`` concatenated along
    ``dim`` in rank order. ``lengths`` (each rank's length along ``dim``)
    where they differ: each block is padded to the longest for the
    collective and cut back after it."""
    wire = to_wire(x, stage(group))
    if lengths is not None:
        wire = _pad_to(wire, dim, max(lengths))
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    if lengths is not None:
        parts = [p.narrow(dim, 0, n) for p, n in zip(parts, lengths)]
    return torch.cat(parts, dim=dim).to(x.device)


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``dim`` to length ``n``."""
    if x.shape[dim] == n:
        return x
    pad = list(x.shape)
    pad[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim=dim)


def _block_lengths(size, group):
    """Each rank's block length of a dim of global length ``size`` split
    over ``group`` (``block_range``), or None where the split is even or
    ``size`` is None: the collectives then take equal blocks as they
    are."""
    k = dist.get_world_size(group)
    if size is None or size % k == 0:
        return None
    return [block_range(size, k, i)[1] for i in range(k)]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, as a new tensor."""
    wire = to_wire(x, stage(group))
    if wire is x:  # the collective writes its input
        wire = x.clone()
    dist.all_reduce(wire, group=group)
    return wire.to(x.device)


class _AllGather(torch.autograd.Function):
    """The blocks of every rank of ``group`` concatenated along ``dim`` in
    rank order (``size`` the global length where the blocks are uneven);
    the backward reduce-scatters: each rank gets the sum, over the ranks in
    rank order, of the gradient of its own block. gloo has no
    reduce-scatter, so it is an all-to-all and a local sum."""

    @staticmethod
    def forward(ctx, x, group, dim, size):
        ctx.group, ctx.dim = group, dim
        ctx.lengths = _block_lengths(size, group)
        return _gather(x, group, dim, ctx.lengths)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        if ctx.lengths is not None:
            g = _pad_to(g, ctx.dim, n * max(ctx.lengths))
        send = to_wire(torch.stack(g.chunk(n, dim=ctx.dim)), stage(ctx.group))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=ctx.group)
        total = recv[0]
        for part in recv[1:]:
            total = total + part
        if ctx.lengths is not None:
            total = total.narrow(
                ctx.dim, 0, ctx.lengths[dist.get_rank(ctx.group)])
        return total.to(g.device), None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over ``group`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The blocks of every rank of ``group`` concatenated along ``dim``
    (``size`` the global length where the blocks are uneven); the backward
    keeps this rank's block of the gradient and sums nothing."""

    @staticmethod
    def forward(ctx, x, group, dim, size):
        ctx.dim, ctx.length = dim, x.shape[dim]
        lengths = _block_lengths(size, group)
        index = dist.get_rank(group)
        ctx.start = (index * x.shape[dim] if lengths is None
                     else sum(lengths[:index]))
        return _gather(x, group, dim, lengths)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.length), None, None, None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``x``'s first dim goes to rank j of ``group``; the result
    stacks the chunks received, in rank order."""
    send = to_wire(x, stage(group))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device)


class AllToAll(torch.autograd.Function):
    """``_all_to_all`` on ``group`` with its gradient: exchanging chunk j
    with rank j is its own inverse, so the backward is the same exchange.
    Ulysses' head scatter and the MoE bucket exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
               size: Optional[int] = None) -> torch.Tensor:
    """``x`` of every rank on the mesh's ``axis``, concatenated along
    ``dim`` in axis order (``lax.all_gather(..., tiled=True)``), with the
    reduce-scatter as its gradient. ``size``: the global length of ``dim``
    where the axis does not divide it (the blocks ``shard_of`` cuts)."""
    return _AllGather.apply(x, mesh.get_group(axis), dim, size)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's "copy to the tensor-parallel region", in front of a
    column-parallel product: ``x`` (whole on every rank of ``axis``)
    unchanged; its gradient, of which each rank holds the part from its
    own columns, summed over ``axis``. Identity on an axis of size 1."""
    if mesh_shape(mesh)[axis] == 1:
        return x
    return _CopyTo.apply(x, mesh.get_group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's "reduce from the tensor-parallel region", after a
    row-parallel product: the partial sums ``x`` summed over ``axis``; the
    gradient, whole on every rank, passes unchanged. Identity on an axis
    of size 1."""
    if mesh_shape(mesh)[axis] == 1:
        return x
    return _ReduceFrom.apply(x, mesh.get_group(axis))


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int,
                size: Optional[int] = None) -> torch.Tensor:
    """``x`` of every rank on ``axis`` concatenated along ``dim``, for an
    activation every rank then uses whole (a tp rank's embedding columns
    or logits columns). Its gradient is whole and equal on every rank, so
    the backward keeps this rank's block: ``all_gather``'s reduce-scatter
    would count it once a rank. ``size`` as for ``all_gather``. Identity
    on an axis of size 1."""
    if mesh_shape(mesh)[axis] == 1:
        return x
    return _GatherFrom.apply(x, mesh.get_group(axis), dim, size)
