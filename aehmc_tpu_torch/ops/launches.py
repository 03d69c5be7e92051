"""Launch counts of the port's CUDA kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else, so a run can show that its path went through the kernels.
Kernels 1 and 2 count each device functor apart: ``nuts_transition`` and
``nuts_sampling`` with the logistic potential, the ``_funnel`` and
``_eight_schools`` names with the hierarchical ones; kernels 1-7 count
their launches on a generated functor under ``_generic`` names.
"""

LAUNCHES = {
    "nuts_transition": 0,
    "nuts_sampling": 0,
    "nuts_transition_funnel": 0,
    "nuts_sampling_funnel": 0,
    "nuts_transition_eight_schools": 0,
    "nuts_sampling_eight_schools": 0,
    "nuts_transition_generic": 0,
    "nuts_sampling_generic": 0,
    "nuts_transition_std": 0,
    "nuts_sampling_std": 0,
    "nuts_transition_std_generic": 0,
    "nuts_sampling_std_generic": 0,
    "chees_transition": 0,
    "ghmc_transition": 0,
    "ghmc_segment": 0,
    "chees_transition_generic": 0,
    "ghmc_transition_generic": 0,
    "ghmc_segment_generic": 0,
    "fused_logistic_hmc": 0,
    "batched_leapfrog": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
