"""Checkpoint / resume (aehmc_tpu_torch.checkpoint and the segmented runs of
``parallel.sample_sharded`` and ``ops.sample_fused_adaptive``): a run killed
after a sampling or a warmup segment and resumed equals the uninterrupted
run bit for bit, for every driver; the ports of the JAX package's
validation errors (tests/test_checkpoint.py)."""

import os

import pytest
import torch

from aehmc_tpu_torch import checkpoint, keys
from aehmc_tpu_torch.chees import AdamState
from aehmc_tpu_torch.ops.chees_fused import make_fused_chees_kernel
from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
from aehmc_tpu_torch.ops.ghmc_fused import (
    make_fused_meads_segment,
    make_fused_meads_transition,
)
from aehmc_tpu_torch.parallel import sample_sharded
from aehmc_tpu_torch.types import ChainState

VAR = torch.tensor([[1.0], [2.0]])


def _lp(q):
    return -0.5 * torch.sum(q * q / VAR[:, 0].to(q.dtype))


def _pg(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_npz_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    tree = {
        "f32": torch.arange(4.0),
        "f64": torch.tensor([[1.5, -2.0]], dtype=torch.float64),
        "bf16": torch.tensor([1.0, 3.140625, -0.0078125],
                             dtype=torch.bfloat16),
        "i32": torch.tensor([3, -7], dtype=torch.int32),
        "bool": torch.tensor([True, False]),
        "nested": (ChainState(torch.ones(2, 2), torch.zeros(2),
                              torch.ones(2, 2)), 7, 0.25, None, [True, "x"]),
        "key": keys.Key(123, 4),
        "gen": gen,
        "adam": AdamState(torch.zeros(()), torch.ones(()),
                          torch.zeros((), dtype=torch.int32)),
    }
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, tree)
    assert not os.path.exists(path + ".tmp")
    for restored in (checkpoint.restore(path), checkpoint.restore(path, tree)):
        for name in ("f32", "f64", "bf16", "i32", "bool"):
            assert restored[name].dtype == tree[name].dtype
            assert torch.equal(restored[name], tree[name])
        assert isinstance(restored["nested"][0], ChainState)
        _assert_bitwise(restored["nested"][0], tree["nested"][0])
        assert restored["nested"][1:] == (7, 0.25, None, [True, "x"])
        assert restored["key"] == keys.Key(123, 4)
        assert isinstance(restored["key"], keys.Key)
        assert isinstance(restored["adam"], AdamState)
        # the generator continues where the saved one stands
        assert torch.equal(torch.rand(3, generator=restored["gen"]),
                           torch.rand(3, generator=gen.clone_state()))
    # the example's device and dtype win
    example = dict(tree, f32=torch.zeros(1, dtype=torch.float64))
    out = checkpoint.restore(path, example)
    assert out["f32"].dtype == torch.float64


def test_only_npz_is_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="item 1.13"):
        checkpoint.save(str(tmp_path / "orbax_dir"), {"a": torch.ones(2)})
    with pytest.raises(NotImplementedError, match="item 1.13"):
        checkpoint.restore(str(tmp_path / "orbax_dir"))


def _chees_fused_kernel():
    return make_fused_chees_kernel(None, (VAR,), potential_and_grad_t=_pg)


def _meads_fused(kind):
    build = (make_fused_meads_transition if kind == "transition"
             else make_fused_meads_segment)
    return build(None, (VAR,), potential_and_grad_t=_pg)


_SAMPLERS = {
    "nuts": dict(algorithm="nuts"),
    "hmc": dict(algorithm="hmc", num_integration_steps=4),
    "mala": dict(algorithm="mala"),
    "ghmc": dict(algorithm="ghmc"),
    "chees": dict(algorithm="chees"),
    "chees_fused": dict(algorithm="chees", chees_kernel_fn="fused"),
    "meads": dict(algorithm="meads", meads_recompute_every=3),
    "meads_fused": dict(algorithm="meads", meads_transition_fn="fused"),
}


def _run(name, path, num_warmup=40, seed=5, **kw):
    opts = dict(_SAMPLERS[name])
    fused = name.endswith("_fused")
    if opts.get("chees_kernel_fn") == "fused":
        opts["chees_kernel_fn"] = _chees_fused_kernel()
    if opts.get("meads_transition_fn") == "fused":
        opts["meads_transition_fn"] = _meads_fused("transition")
    dtype = torch.float32 if fused else torch.float64
    q0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(6),
                     dtype=dtype)
    rng = (torch.Generator().manual_seed(seed) if opts["algorithm"] == "chees"
           else seed)
    return sample_sharded(rng, _lp, q0, num_samples=30, num_warmup=num_warmup,
                          checkpoint_every=10, checkpoint_path=path,
                          **opts, **kw)


def _assert_results_bitwise(full, resumed):
    assert torch.equal(full.positions, resumed.positions)
    _assert_bitwise(full.final_state, resumed.final_state)
    _assert_bitwise(full.diagnostics, resumed.diagnostics)
    assert torch.equal(full.step_size, resumed.step_size)
    assert torch.equal(full.inverse_mass_matrix, resumed.inverse_mass_matrix)


@pytest.mark.parametrize("name", list(_SAMPLERS))
def test_sample_sharded_resumes_after_a_crash_in_sampling(tmp_path, name):
    full = _run(name, str(tmp_path / "full.npz"))
    path = str(tmp_path / "run.npz")
    assert _run(name, path, _crash_after_segments=1) is None
    # another seed: only the snapshot's keys and states can give the bits
    resumed = _run(name, path, resume=True, seed=77)
    assert full.positions.shape == (30, 8, 2)
    _assert_results_bitwise(full, resumed)


@pytest.mark.parametrize("name", ["nuts", "chees", "meads"])
def test_sample_sharded_resumes_after_a_crash_in_warmup(tmp_path, name):
    full = _run(name, str(tmp_path / "full.npz"), num_warmup=35)
    path = str(tmp_path / "run.npz")
    assert _run(name, path, num_warmup=35,
                _crash_after_warmup_segments=2) is None
    assert os.path.exists(path[: -len(".npz")] + "_warmup.npz")
    assert not os.path.exists(path)
    resumed = _run(name, path, num_warmup=35, resume=True, seed=77)
    _assert_results_bitwise(full, resumed)


@pytest.mark.parametrize("name", ["nuts", "ghmc", "chees"])
def test_checkpointed_run_equals_the_unsegmented_run(tmp_path, name):
    """Segments take the keys the one-piece run takes: the same result."""
    opts = dict(_SAMPLERS[name])
    q0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(6),
                     dtype=torch.float64)

    def rng():
        return (torch.Generator().manual_seed(5) if name == "chees" else 5)

    plain = sample_sharded(rng(), _lp, q0, 30, 40, **opts)
    segmented = sample_sharded(rng(), _lp, q0, 30, 40, checkpoint_every=10,
                               checkpoint_path=str(tmp_path / "c.npz"), **opts)
    _assert_results_bitwise(plain, segmented)


def _fused_nuts(path=None, **kw):
    q0 = 0.5 * torch.randn(16, 2, generator=torch.Generator().manual_seed(2))
    return sample_fused_adaptive(
        torch.Generator().manual_seed(9), None, (VAR,), q0, 20, 30,
        potential_and_grad_t=_pg, max_num_expansions=3,
        checkpoint_path=path, **kw)


@pytest.mark.parametrize("internal", [True, False])
def test_fused_nuts_driver_resumes(tmp_path, internal):
    kw = dict(checkpoint_every=10, use_internal_prng=internal)
    full = _fused_nuts(str(tmp_path / "full.npz"), **kw)
    path = str(tmp_path / "run.npz")
    assert _fused_nuts(path, _crash_after_segments=1, **kw) is None
    resumed = _fused_nuts(path, resume=True, **kw)
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)
    path = str(tmp_path / "warm.npz")
    assert _fused_nuts(path, _crash_after_warmup_segments=1, **kw) is None
    resumed = _fused_nuts(path, resume=True, **kw)
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)
    # the checkpointed run draws what the unsegmented per-draw run draws
    for a, b in zip(full, _fused_nuts(use_internal_prng=internal)):
        assert torch.equal(a, b)


def test_validation_errors(tmp_path):
    qs = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        sample_sharded(0, _lp, qs, num_samples=4, num_warmup=0,
                       checkpoint_every=2)
    with pytest.raises(ValueError, match="requires an .npz"):
        sample_sharded(0, _lp, qs, num_samples=4, num_warmup=0,
                       checkpoint_every=2, checkpoint_path=str(tmp_path))
    with pytest.raises(ValueError, match="does not compose"):
        sample_sharded(0, _lp, torch.zeros(8, 2), algorithm="meads",
                       checkpoint_every=2,
                       checkpoint_path=str(tmp_path / "m.npz"),
                       meads_segment_fn=_meads_fused("segment"))
    with pytest.raises(ValueError, match="loop_in_kernel"):
        _fused_nuts(str(tmp_path / "f.npz"), checkpoint_every=10,
                    loop_in_kernel=True)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        _fused_nuts(checkpoint_every=10)
