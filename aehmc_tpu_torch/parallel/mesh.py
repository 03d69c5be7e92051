"""Device meshes and chain-axis sharding (port of
:mod:`aehmc_tpu.parallel.mesh`).

One process drives every device of a mesh, as one JAX controller drives a
``jax.sharding.Mesh``: a mesh is a grid of ``torch.device``s with named
axes, and a chain batch splits over all of them in slice-major device
order.  A mesh may name one device more than once (``[cuda:0] * 4``, or
``[cpu] * 8``): the shards then run one after the other on it, which is
how one card, or the CPU, runs a 4- or 8-shard mesh.

A shard launches its kernel with its global chain offset (the Philox
counter carries the global chain index, :mod:`aehmc_tpu_torch.ops.philox`),
and every cross-chain statistic is reduced over the chains gathered back
in global order, so a sharded run equals the unsharded one bit for bit
wherever a chain's arithmetic does not depend on the batch width (the
fused kernels').  Multi-process and multi-host meshes are not ported (the
JAX package has none either).
"""

import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

CHAIN_AXIS = "chains"
SLICE_AXIS = "slice"


class Mesh:
    """A grid of devices with named axes: ``devices`` an object array of
    ``torch.device`` (``.size`` devices), ``axis_names``, and ``shape``
    mapping each axis name to its size, as a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> List[torch.device]:
        """The devices in slice-major order: shard ``i`` of a chain batch
        lies on the ``i``-th."""
        return list(self.devices.flat)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.device_list()})"


def _devices(devices) -> List[torch.device]:
    """``devices`` as ``torch.device``s, by default every CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=, e.g. "
                "[torch.device('cpu')] * 8 for a CPU mesh")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _grid(devices: List[torch.device], shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = CHAIN_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-d mesh over the chain axis: ``devices`` (every ``cuda:i`` by
    default; it raises when there is no CUDA device), the first
    ``num_devices`` of them when given."""
    devices = _devices(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(_grid(devices, -1), (axis_name,))


def make_multislice_mesh(
    num_slices: int,
    devices: Optional[Sequence] = None,
    axis_names: Sequence[str] = (SLICE_AXIS, CHAIN_AXIS),
) -> Mesh:
    """A 2-d ``(slice, chains)`` mesh: ``devices`` (every ``cuda:i`` by
    default) in slice-major order, ``num_slices`` rows of them.  Chains
    shard over both axes (:func:`chain_sharding`)."""
    devices = _devices(devices)
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {num_slices} slices"
        )
    return Mesh(_grid(devices, (num_slices, -1)), tuple(axis_names))


def _tree(fn, x):
    """``fn`` on every leaf of a tree of tuples and named tuples."""
    if isinstance(x, tuple):
        values = [_tree(fn, v) for v in x]
        return type(x)(*values) if hasattr(x, "_fields") else tuple(values)
    return fn(x)


# how a shard adapter passes each argument to a shard (Shard.args)
SHARDED = "sharded"  # the shard's chains along the batch's chain axis
SHARED = "shared"    # the whole value, on the shard's device
VECTOR, ROWS = 1, 2  # per chain as a (chains,) vector or (chains, ·) rows
                     # (the shard's, along axis 0), else shared


class Shard(NamedTuple):
    """Chains ``[start, stop)`` of a batch, on ``device``."""

    device: torch.device
    start: int
    stop: int

    def take(self, x, axis: int = 0):
        """This shard's chains along ``axis`` of every tensor of ``x`` (a
        tree of tuples and named tuples), contiguous, on the shard's
        device; a 0-d tensor or another leaf is replicated, None stays
        None."""
        def leaf(t):
            if isinstance(t, torch.Tensor) and t.ndim:
                return (t.narrow(axis, self.start, self.stop - self.start)
                        .contiguous().to(self.device))
            return self.put(t)

        return _tree(leaf, x)

    def put(self, x):
        """``x`` replicated: every tensor of the tree on the shard's
        device."""
        return _tree(lambda t: t.to(self.device)
                     if isinstance(t, torch.Tensor) else t, x)

    def args(self, spec, values, axis: int = 0) -> tuple:
        """``values`` as this shard takes them, by one rule each of
        ``spec``: :data:`SHARDED` (its chains along ``axis``),
        :data:`SHARED`, or :data:`VECTOR` / :data:`ROWS` (its chains along
        axis 0 of a tensor of one / two dims and more than one element, a
        per-chain ε or M⁻¹; anything else shared)."""
        def one(rule, x):
            if rule == SHARDED:
                return self.take(x, axis)
            if (rule != SHARED and isinstance(x, torch.Tensor)
                    and x.ndim == rule and x.numel() > 1):
                return self.take(x)
            return self.put(x)

        return tuple(one(rule, x) for rule, x in zip(spec, values))


def _shard_index(mesh: Mesh, axes) -> List[int]:
    """The shard each device of ``mesh`` holds (slice-major) when a batch
    splits over ``axes`` and is replicated over the others."""
    index = np.indices(mesh.devices.shape)
    shard = np.zeros(mesh.devices.shape, dtype=np.int64)
    for i, name in enumerate(mesh.axis_names):
        if name in axes:
            shard = shard * mesh.shape[name] + index[i]
    return shard.reshape(-1).tolist()


def chain_shards(mesh: Mesh, num_chains: int, block_chains: int = None,
                 axes=None) -> List[Shard]:
    """The shard of a ``num_chains`` batch on each device of ``mesh``,
    slice-major: split over ``axes`` (every axis by default) and replicated
    over the others.  Raises ``ValueError`` as the JAX adapters do: when
    the chains do not split evenly, or a given ``block_chains`` (the JAX
    kernels' block) does not tile a shard.  The CUDA kernels need no
    tiling: their last block is masked, and the Philox streams follow the
    global chain index."""
    axes = mesh.axis_names if axes is None else tuple(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    if num_chains % n:
        raise ValueError(f"{num_chains} chains do not shard over {n} shards")
    local = num_chains // n
    if block_chains is not None and local % min(block_chains, local):
        raise ValueError(
            f"block_chains={block_chains} does not tile the per-device "
            f"chain count {local}"
        )
    return [Shard(dev, k * local, (k + 1) * local) for k, dev in
            zip(_shard_index(mesh, axes), mesh.device_list())]


def _join(parts, device, axis):
    """The shards' trees joined: each tensor leaf along ``axis`` in chain
    order on ``device`` (a 0-d leaf is the first shard's), None as None."""
    first = parts[0]
    if isinstance(first, tuple):
        values = [_join([p[i] for p in parts], device, axis)
                  for i in range(len(first))]
        return (type(first)(*values) if hasattr(first, "_fields")
                else tuple(values))
    if not isinstance(first, torch.Tensor):
        return first
    if first.ndim == 0:
        return first.to(device)
    return torch.cat([p.to(device) for p in parts], dim=axis)


def map_shards(fn: Callable, shards: Sequence[Shard], device, axis=0):
    """``fn(shard)`` for every shard, the outputs (a tree of tensors)
    joined in chain order on ``device`` along ``axis``, or, for a tuple of
    outputs, along one axis each of a sequence."""
    outs = [fn(s) for s in shards]
    if len(outs) == 1 and shards[0].device == device:  # nothing to join
        return outs[0]
    if isinstance(axis, int):
        return _join(outs, device, axis)
    return tuple(_join(list(parts), device, ax)
                 for parts, ax in zip(zip(*outs), axis))


class Sharding(NamedTuple):
    """How a chain-axis tensor lies on ``mesh``: split into one shard per
    combination of the ``axes`` (in mesh order), each shard on every
    device whose position on those axes is its own; no axes replicates
    it."""

    mesh: Mesh
    axes: tuple

    @property
    def num_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def shard_of(self) -> List[int]:
        """The shard each device holds, in slice-major device order."""
        return _shard_index(self.mesh, self.axes)

    def split(self, x: torch.Tensor, axis: int = 0) -> List[torch.Tensor]:
        """``x`` cut along its chain ``axis`` into equal shards, one tensor
        for each device of the mesh (slice-major), on that device."""
        return [s.take(x, axis) for s in
                chain_shards(self.mesh, x.shape[axis], axes=self.axes)]

    def gather(self, shards: Sequence[torch.Tensor],
               axis: int = 0) -> torch.Tensor:
        """The tensor :meth:`split` cut: each shard once, joined along
        ``axis`` in global chain order, on the mesh's first device."""
        num_chains = shards[0].shape[axis] * self.num_shards
        first = {}
        for s, t in zip(chain_shards(self.mesh, num_chains, axes=self.axes),
                        shards):
            first.setdefault(s.start, t)
        home = self.mesh.device_list()[0]
        return torch.cat([first[k].to(home) for k in sorted(first)],
                         dim=axis)


def chain_sharding(mesh: Mesh, axis_name: str = None) -> Sharding:
    """The sharding that splits the chain axis over every axis of the mesh
    (a ``(slice, chains)`` mesh splits the chains over every device), or
    over ``axis_name`` alone (replicated over the others)."""
    axes = mesh.axis_names if axis_name is None else (axis_name,)
    return Sharding(mesh, tuple(axes))


def replicated(mesh: Mesh) -> Sharding:
    """The sharding that puts a whole value on every device."""
    return Sharding(mesh, ())


def device_replicas(tensors: Sequence) -> Callable:
    """``on(device) -> tensors`` on ``device``: the tensors themselves where
    they lie, else a copy made once and kept (what ``shard_map`` does to
    the values a sharded function closes over)."""
    tensors = tuple(tensors)
    copies = {}

    def on(device):
        if all(not isinstance(t, torch.Tensor) or t.device == device
               for t in tensors):
            return tensors
        if device not in copies:
            copies[device] = tuple(
                t.to(device) if isinstance(t, torch.Tensor) else t
                for t in tensors)
        return copies[device]

    return on
