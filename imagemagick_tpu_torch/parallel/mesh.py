"""Device meshes: an image or a batch held as per-device blocks.

Port of ``imagemagick_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over its devices and lets ``shard_map`` run one
program on every device.  Here one process drives a grid of per-device
tensors itself (single controller, as the JAX mesh is):

  * batch data-parallelism  -> mesh axis "dp"
  * spatial sharding        -> mesh axes "sy"/"sx" over image H/W, with
    halo exchange between neighbouring blocks (``parallel/spatial.py``)

A mesh may name one device several times: ``make_mesh(1, 2, 2,
devices=[cuda:0] * 4)`` runs every exchange and every reduction on one
card, as the JAX tests' 8 virtual CPU devices do.  On a machine with
several cards the same code copies blocks between cards.

``torch.distributed`` joins processes along "dp" only (the JAX docstring
sends batch parallelism across hosts and keeps halos within one host):
with a group started, process ``r`` of ``W`` owns the dp rows
``[r*dp/W, (r+1)*dp/W)``, and the reductions over dp of a mesh made
under the group finish with ``dist.all_reduce`` on it.

``device_put`` and ``ShardedArray`` stand in for ``jax.device_put`` and
the global ``jax.Array`` that ``shard_map`` takes and returns.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("dp", "sy", "sx")


class PartitionSpec(tuple):
    """Which mesh axis splits each tensor dimension (None: not split);
    dimensions past the spec's end are not split."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A (dp, sy, sx) grid of devices.  ``devices`` holds this process's
    rows of it (all of them without a process group); ``shape`` is the
    global extent of each axis, as ``mesh.shape["sy"]`` reads in JAX.
    ``grouped`` says whether the mesh was made under a started process
    group of ``world`` processes, whose reductions finish over it."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray, dp_offset: int = 0,
                 world: int = 1, grouped: bool = False):
        self.devices = devices
        self.dp_offset = dp_offset
        self.world = world
        self.grouped = grouped
        dp, sy, sx = devices.shape
        self.shape = {"dp": dp * world, "sy": sy, "sx": sx}

    def reduces_over_group(self) -> bool:
        """Whether a reduction over this mesh finishes with an
        ``all_reduce`` on the default group: yes for a mesh made under a
        group (a world of one included), which must still be running with
        the mesh's number of processes."""
        if not self.grouped:
            return False
        world, _ = _group()
        if not _started() or world != self.world:
            raise ValueError(
                f"the mesh was made under a process group of {self.world} "
                f"processes; " + (f"the group now has {world}" if _started()
                                  else "no group is started now"))
        return True

    @property
    def first_device(self) -> torch.device:
        """Where reductions and gathers land (JAX's replicated ``P()``
        outputs)."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sy={self.shape['sy']}, "
                f"sx={self.shape['sx']}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class NamedSharding:
    """A mesh and a ``PartitionSpec`` over it."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _started() -> bool:
    """Whether ``torch.distributed``'s default group is started."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _group():
    """The default process group's (world size, rank), or (1, 0)."""
    import torch.distributed as dist

    if _started():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_devices(device="cuda") -> list:
    """This process's devices of ``device``'s type: the cards for
    ``"cuda"`` (none without one), one CPU device for ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no devices of type {kind!r}")


def make_mesh(dp: int = 1, sy: int = 1, sx: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (dp, sy, sx) mesh over ``devices`` (this process's cards
    by default).  With a process group of ``W`` processes each holds
    ``dp / W`` rows on its own devices, and the count checked is the
    global one, ``W * len(devices)``."""
    devices = list(devices if devices is not None else local_devices("cuda"))
    world, rank = _group()
    need = dp * sy * sx
    have = len(devices) * world
    if need > have:
        raise ValueError(f"mesh {dp}x{sy}x{sx} needs {need} devices, "
                         f"have {have}")
    if dp % world:
        raise ValueError(f"mesh dp={dp} is not a multiple of the {world} "
                         f"processes of the group")
    rows = dp // world
    arr = np.empty(rows * sy * sx, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:rows * sy * sx]]
    return Mesh(arr.reshape(rows, sy, sx), rank * rows, world, _started())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC batch-parallel: N over dp, H over sy, W over sx."""
    return NamedSharding(mesh, P("dp", "sy", "sx", None))


def spatial_sharding(mesh: Mesh) -> NamedSharding:
    """HWC single-image spatial: H over sy, W over sx."""
    return NamedSharding(mesh, P("sy", "sx", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> int:
    """Start ``torch.distributed``'s default group, once per process:
    ``tcp://`` + ``coordinator_address`` (``host:port``), NCCL for the
    card and gloo for the CPU.  With no address it reads torch's own
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, and
    does nothing when none is set; a group already started is left
    alone.  Returns the global device count: the world size times this
    process's devices of ``device``'s type."""
    import torch.distributed as dist

    if not dist.is_initialized():
        addr = coordinator_address
        if addr is None and "MASTER_ADDR" in os.environ:
            addr = (f"{os.environ['MASTER_ADDR']}:"
                    f"{os.environ.get('MASTER_PORT', '29500')}")
        if addr is not None:
            world = num_processes if num_processes is not None else \
                int(os.environ.get("WORLD_SIZE", "1"))
            rank = process_id if process_id is not None else \
                int(os.environ.get("RANK", "0"))
            backend = "nccl" if torch.device(device).type == "cuda" \
                else "gloo"
            dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                    world_size=world, rank=rank)
    return _group()[0] * len(local_devices(device))


def auto_mesh(batch: int = 1) -> Mesh:
    """Pick a mesh for the global card count: batch parallelism first
    (no exchange), the rest of the devices over image rows."""
    n = _group()[0] * len(local_devices("cuda"))
    dp = 1
    # largest power-of-two dp dividing both batch and n
    while dp * 2 <= n and batch % (dp * 2) == 0:
        dp *= 2
    # at least one row, so that a machine without a card gets
    # make_mesh's error rather than an empty mesh
    rest = max(1, n // dp)
    return make_mesh(dp=dp, sy=rest, sx=1)


def _full_spec(spec: Sequence, ndim: int) -> tuple:
    if len(spec) > ndim:
        raise ValueError(f"partition spec {tuple(spec)} has more entries "
                         f"than the array's {ndim} dimensions")
    return tuple(spec) + (None,) * (ndim - len(spec))


class ShardedArray:
    """A global tensor held as blocks of a mesh: ``blocks[i, j, k]`` is
    the block on ``mesh.devices[i, j, k]``.  A mesh axis the spec does not
    name holds copies (JAX's replication).  ``shape`` is the global
    shape; ``gather()`` returns the global tensor on the mesh's first
    device."""

    def __init__(self, blocks: np.ndarray, sharding: NamedSharding,
                 shape: Sequence[int]):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = torch.Size(shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return _full_spec(self.sharding.spec, len(self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, sharding={self.sharding!r})")

    def _local(self) -> torch.Tensor:
        """This process's part: its blocks joined on the first device,
        one copy of each replicated block."""
        spec, dev = self.spec, self.mesh.first_device
        grid = self.blocks
        for ax in (2, 1, 0):
            name = AXIS_NAMES[ax]
            if name not in spec:
                grid = grid.take([0], axis=ax)
                continue
            dim = spec.index(name)
            moved = np.moveaxis(grid, ax, -1)
            out = np.empty(moved.shape[:-1] + (1,), dtype=object)
            for idx in np.ndindex(moved.shape[:-1]):
                out[idx + (0,)] = torch.cat(
                    [t.to(dev) for t in moved[idx]], dim)
            grid = np.moveaxis(out, -1, ax)
        return grid.flat[0]

    def gather(self) -> torch.Tensor:
        """The global tensor on the mesh's first device; for a mesh made
        under a process group and a spec that splits dp, the other
        processes' rows come by ``dist.all_gather``."""
        local = self._local()
        if "dp" in self.spec and self.mesh.reduces_over_group():
            import torch.distributed as dist

            parts = [torch.empty_like(local) for _ in range(self.mesh.world)]
            dist.all_gather(parts, local.contiguous())
            local = torch.cat(parts, self.spec.index("dp"))
        return local

    def sum(self) -> torch.Tensor:
        """The sum of every element of the global array (one copy of each
        replicated block), taken in float64, over the group's processes
        too when the mesh was made under a group and the spec splits dp;
        in the array's dtype on the first device."""
        spec = self.spec
        sel = tuple(slice(None) if n in spec else slice(0, 1)
                    for n in AXIS_NAMES)
        dev = self.mesh.first_device
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for blk in self.blocks[sel].flat:
            total += blk.sum(dtype=torch.float64).to(dev)
        if "dp" in spec and self.mesh.reduces_over_group():
            import torch.distributed as dist

            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total.to(self.dtype)


def sharded_from_blocks(blocks: np.ndarray, sharding: NamedSharding
                        ) -> ShardedArray:
    """A ShardedArray of ``blocks`` (one per local mesh position, all
    alike in shape), its global shape from the spec."""
    first = blocks.flat[0]
    spec = _full_spec(sharding.spec, first.dim())
    mesh = sharding.mesh
    shape = [s * (mesh.shape[n] if n else 1)
             for s, n in zip(first.shape, spec)]
    return ShardedArray(blocks, sharding, shape)


def device_put(x, sharding: NamedSharding) -> ShardedArray:
    """Split ``x`` (a tensor, a numpy array or a ShardedArray) into the
    blocks of ``sharding`` on their devices.  A block that is already on
    its device stays a view of ``x`` (no copy); a numpy array goes to
    each device block by block."""
    if isinstance(x, ShardedArray):
        if x.sharding.mesh is sharding.mesh and \
                x.spec == _full_spec(sharding.spec, x.ndim):
            return x
        x = x.gather()
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    mesh = sharding.mesh
    spec = _full_spec(sharding.spec, t.dim())
    for d, name in enumerate(spec):
        if name is not None and t.shape[d] % mesh.shape[name]:
            raise ValueError(
                f"dimension {d} of shape {tuple(t.shape)} is not divisible "
                f"by the {mesh.shape[name]} devices of mesh axis {name!r}")
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        pos = (idx[0] + mesh.dp_offset, idx[1], idx[2])
        sl = [slice(None)] * t.dim()
        for d, name in enumerate(spec):
            if name is not None:
                size = t.shape[d] // mesh.shape[name]
                k = pos[AXIS_NAMES.index(name)]
                sl[d] = slice(k * size, (k + 1) * size)
        blk = t[tuple(sl)]
        dev = mesh.devices[idx]
        blocks[idx] = blk if blk.device == dev else blk.to(dev)
    return ShardedArray(blocks, NamedSharding(mesh, spec), t.shape)
