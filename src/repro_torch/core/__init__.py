"""The heSRPT scheduler in PyTorch: ranking, policies, closed forms, the
event loop, scenarios, online wrappers and sweeps (see the package doc).

The package exports the reference's names (``repro.core.__all__``), but two
that name the JAX implementation: ``quantize_allocation_jax`` and
``snap_to_slices_jax`` are the port's ``quantize_allocation`` and
``snap_to_slices``.  A name is imported from its module at first use
(``kernels/alloc.py`` imports ``core.policies``, which ``core.engine``'s
import of the kernel would otherwise meet half made)."""

from __future__ import annotations

import importlib

#: The submodules the package exports.
_MODULES = ('engine', 'estimation', 'scenarios')
#: Each other exported name, by the submodule that defines it.
_NAMES = {
    "analysis": ("per_class_count", "per_class_mean", "per_class_summary", "seed_axis_stats"),
    "arrivals": ("OnlineSimResult", "load_sweep", "load_sweep_raw", "simulate_online",
        "simulate_online_quantized", "simulate_online_ranked", "simulate_online_superstep",
        "simulate_scenario", "simulate_stream"),
    "engine": ("DEFAULT_SLICES", "EngineResult", "EngineTrace", "Observation", "PDrift",
        "StatefulRule", "StreamResult", "StreamSource", "as_stateful", "continuous_rule",
        "poisson_source", "quantize_allocation", "quantized_rule", "run_ranked", "run_stream",
        "run_stream_ranked", "run_stream_source", "snap_to_slices", "tape_source"),
    "estimation": ("EstState", "blended_p_hat", "estimating_class_rule", "estimating_rule",
        "init_est_state", "p_hat_classes", "p_hat_jobs", "simulate_scenario_estimated"),
    "flowtime": ("epoch_schedule", "hesrpt_completion_times", "hesrpt_mean_flowtime",
        "hesrpt_sd_mean_slowdown", "hesrpt_total_flowtime", "omega_star", "omega_weighted",
        "optimal_makespan", "rank_bracket_powers", "speedup", "weighted_total_flowtime"),
    "multiclass": ("ClassSpec", "MULTICLASS_POLICY_NAMES", "class_rule", "class_theta",
        "multiclass_sweep", "per_class_metrics", "policy_weights", "simulate_multiclass"),
    "policies": ("POLICY_NAMES", "RANK_POLICIES", "equi", "hell", "helrpt", "hesrpt",
        "hesrpt_per_class", "knee", "make_policy", "make_rank_policy", "size_ranks_desc",
        "srpt", "waterfill", "weighted_hesrpt"),
    "scenarios": ("SCENARIOS", "Scenario", "bursty_arrivals", "deterministic_arrivals",
        "make_scenario", "pareto_sizes", "poisson_arrivals", "stream_tape", "trace_scenario"),
    "simulator": ("SimResult", "simulate", "total_flowtime"),
    "superstep": ("BatchClosedForm", "SUPERSTEP_POLICIES", "batch_result_closed_form",
        "run_superstep"),
    "sweeps": ("STREAM_METRICS", "Sweep", "SweepResult", "run_sweep", "write_bench_json"),
}
_HOME = {name: module for module, names in _NAMES.items() for name in names}

__all__ = sorted(_MODULES + tuple(_HOME))


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
