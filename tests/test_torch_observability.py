"""Progress logging, profiler spans, finite guards and the throughput counter
(aehmc_tpu_torch.observability; the ports of tests/test_observability.py),
and ``progress_every`` on the drivers."""

import torch

from aehmc_tpu_torch import hmc, nuts, observability
from aehmc_tpu_torch.models.gaussian import std_normal
from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
from aehmc_tpu_torch.parallel import sample_sharded
from aehmc_tpu_torch.types import Diagnostics


def _info(accept=0.9, diverging=False, steps=3):
    return Diagnostics(
        acceptance_probability=torch.tensor(accept),
        num_doublings=torch.tensor(2, dtype=torch.int32),
        is_turning=torch.tensor(True),
        is_diverging=torch.tensor(diverging),
        energy=torch.tensor(1.0),
        num_integration_steps=torch.tensor(steps, dtype=torch.int32),
    )


def test_progress_callback_fires_on_schedule():
    lines = []

    def printer(step, acceptance, divergences):
        lines.append((int(step), float(acceptance), int(divergences)))

    for step in range(25):
        observability.progress_callback(step, _info(), every=10,
                                        printer=printer)
    assert [s for s, _, _ in lines] == [0, 10, 20]
    assert lines[0][1] == float(torch.tensor(0.9)) and lines[0][2] == 0


def test_guard_finite_flags_nan(capsys):
    assert bool(observability.guard_finite(torch.tensor([1.0, 2.0])))
    assert capsys.readouterr().err == ""
    ok = observability.guard_finite(torch.tensor([1.0, float("nan")]),
                                    where="test batch")
    assert not bool(ok)
    assert "non-finite values detected in test batch" in capsys.readouterr().err


def test_annotate_span_runs():
    with observability.annotate("warmup"):
        x = torch.sum(torch.ones(8))
    assert float(x) == 8.0
    with torch.profiler.profile() as prof:
        with observability.annotate("sampling"):
            torch.ones(4).sum()
    assert any(e.name == "sampling" for e in prof.events())


def test_grad_evals_counter_consistent():
    logprob_fn = std_normal()
    kernel = nuts.new_kernel(logprob_fn)
    state = hmc.new_state(torch.zeros(2, dtype=torch.float64), logprob_fn)
    _, info = kernel(0, state, 0.5, torch.ones(2, dtype=torch.float64))
    # the counter sums the subtrees' leaves: at most 2^d - 1 over d doublings
    steps, depth = int(info.num_integration_steps), int(info.num_doublings)
    assert 1 <= steps <= 2**depth - 1
    assert observability.grad_evals_per_sec(info, 2.0) == steps / 2.0


def _progress_steps(err):
    return [int(line.split()[2]) for line in err.splitlines()
            if line.startswith("[aehmc_tpu_torch] step")]


def test_progress_every_on_the_drivers(capsys):
    q0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    lp = std_normal()
    sample_sharded(0, lp, q0, 12, 10, algorithm="hmc", progress_every=5,
                   num_integration_steps=2)
    # pooled warmup steps 0, 5, then draws 0, 5, 10
    assert _progress_steps(capsys.readouterr().err) == [0, 5, 0, 5, 10]
    sample_sharded(0, lp, q0, 12, 10, algorithm="meads", progress_every=4)
    assert _progress_steps(capsys.readouterr().err) == [0, 4, 8]
    sample_fused_adaptive(
        torch.Generator().manual_seed(2), None, (torch.ones(2, 1),),
        q0.float(), 6, 6, max_num_expansions=3, progress_every=3,
        potential_and_grad_t=lambda q_t, v: (
            0.5 * torch.sum(q_t * q_t / v, dim=0, keepdim=True), q_t / v))
    assert _progress_steps(capsys.readouterr().err) == [0, 3, 0, 3]
