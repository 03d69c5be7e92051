"""The port's device meshes (aehmc_tpu_torch.parallel.mesh) against the JAX
package's (tests/test_parallel.py): the same shapes and axis names on the
same device counts, the same errors, and the chain sharding that splits a
batch into per-device shards and joins it back.  The port's meshes name
the CPU several times; JAX's are the 8 virtual devices of
tests/conftest.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from aehmc_tpu.parallel import mesh as jax_mesh
from aehmc_tpu_torch.parallel import (
    Mesh,
    chain_sharding,
    make_mesh,
    make_multislice_mesh,
    replicated,
)
from aehmc_tpu_torch.parallel.mesh import (
    chain_shards,
    device_replicas,
    map_shards,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("num_devices", [None, 4, 1])
def test_make_mesh_is_the_jax_mesh(num_devices):
    port = make_mesh(num_devices, devices=[CPU] * 8)
    ref = jax_mesh.make_mesh(num_devices)
    assert port.devices.shape == ref.devices.shape
    assert port.devices.size == ref.devices.size == port.size
    assert port.axis_names == ref.axis_names == ("chains",)
    assert dict(port.shape) == dict(ref.shape)
    assert port.device_list() == [CPU] * port.size
    named = make_mesh(devices=["cpu", "cpu"], axis_name="x")
    assert named.axis_names == ("x",) and named.shape == {"x": 2}


def test_make_multislice_mesh_is_the_jax_mesh():
    port = make_multislice_mesh(2, devices=[CPU] * 8)
    ref = jax_mesh.make_multislice_mesh(2, devices=jax.devices()[:8])
    assert port.devices.shape == ref.devices.shape == (2, 4)
    assert port.axis_names == ref.axis_names == ("slice", "chains")
    assert dict(port.shape) == dict(ref.shape)


def test_multislice_mesh_validation():
    """8 devices do not split into 3 slices: both packages raise."""
    with pytest.raises(ValueError, match="do not split into 3 slices"):
        make_multislice_mesh(3, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jax_mesh.make_multislice_mesh(3)
    with pytest.raises(ValueError, match="axis names"):
        Mesh([[CPU, CPU]], ("chains",))


def test_make_mesh_takes_every_cuda_device_or_raises():
    """With no ``devices``, a mesh of every CUDA device; with none, it
    raises rather than build a CPU mesh."""
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh.device_list() == [torch.device("cuda", i) for i in
                                      range(torch.cuda.device_count())]
        return
    for build in (make_mesh, lambda: make_multislice_mesh(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_chain_sharding_splits_and_joins_like_jax():
    """The sharding of JAX's test_make_mesh_and_sharding: 16 chains over 8
    devices, 2 a shard; the shards join back to the batch, along either
    chain axis."""
    mesh = make_mesh(devices=[CPU] * 8)
    x = torch.arange(64.0).reshape(16, 4)
    shards = chain_sharding(mesh).split(x)
    ref = jax.device_put(jnp.zeros((16, 4)),
                         jax_mesh.chain_sharding(jax_mesh.make_mesh()))
    assert len(shards) == len(ref.addressable_shards) == 8
    assert shards[0].shape == ref.addressable_shards[0].data.shape == (2, 4)
    assert torch.equal(shards[3], x[6:8])
    assert torch.equal(chain_sharding(mesh).gather(shards), x)
    cols = chain_sharding(mesh).split(x.T, axis=1)
    assert torch.equal(cols[3], x.T[:, 6:8])
    assert torch.equal(chain_sharding(mesh).gather(cols, axis=1), x.T)
    with pytest.raises(ValueError, match="do not shard"):
        chain_sharding(mesh).split(x[:12])


def test_chain_sharding_over_one_axis_replicates_over_the_other():
    """On a (slice, chains) mesh: every device its own shard by default;
    over "chains" alone, the two slices hold the same four shards;
    replicated, every device the whole batch."""
    mesh = make_multislice_mesh(2, devices=[CPU] * 8)
    x = torch.arange(32.0).reshape(32, 1)
    both = chain_sharding(mesh)
    assert both.num_shards == 8 and both.shard_of() == list(range(8))
    inner = chain_sharding(mesh, "chains")
    assert inner.num_shards == 4 and inner.shard_of() == [0, 1, 2, 3] * 2
    parts = inner.split(x)
    assert torch.equal(parts[1], parts[5]) and parts[1].shape == (8, 1)
    assert torch.equal(inner.gather(parts), x)
    rep = replicated(mesh)
    assert rep.num_shards == 1
    assert all(torch.equal(p, x) for p in rep.split(x))
    assert torch.equal(rep.gather(rep.split(x)), x)


def test_chain_shards_and_their_join():
    """A batch's shards in slice-major order with their global offsets; the
    JAX adapters' errors; outputs joined in chain order along each one's
    chain axis."""
    mesh = make_multislice_mesh(2, devices=[CPU] * 8)
    shards = chain_shards(mesh, 32, 4)
    assert [(s.start, s.stop) for s in shards] == [
        (4 * i, 4 * i + 4) for i in range(8)]
    with pytest.raises(ValueError, match="36 chains do not shard over 8"):
        chain_shards(mesh, 36)
    with pytest.raises(ValueError, match="block_chains=3 does not tile"):
        chain_shards(mesh, 32, 3)
    assert len(chain_shards(mesh, 32, 1024)) == 8  # a block past the shard
    q = torch.arange(96.0).reshape(32, 3)
    out = map_shards(lambda s: (s.take(q) + s.start, s.take(q.T, -1), None),
                     shards, CPU, (0, -1, 0))
    offsets = torch.arange(8.0).repeat_interleave(4)[:, None] * 4
    assert torch.equal(out[0], q + offsets)
    assert torch.equal(out[1], q.T) and out[2] is None


def test_device_replicas_copy_once_and_only_across_devices():
    data = (torch.ones(3), 2.5)
    on = device_replicas(data)
    assert on(CPU) is data
    meta = torch.device("meta")
    moved = on(meta)
    assert moved[0].device == meta and moved[1] == 2.5
    assert on(meta) is moved
