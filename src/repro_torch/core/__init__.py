"""The cross-level adaptation loop: monitor → profiler → optimizer →
``Middleware``."""
from .actions import Action, OffloadChoice, default_action_space
from .loop import AdaptationLoop, Decision
from .middleware import Middleware
from .monitor import (ResourceContext, ResourceMonitor, budget_sweep_trace,
                      case_study_trace, constant_trace, dvfs_spike_trace,
                      shape_context, shaped_trace)
from .optimizer import (ActionEvaluator, Budgets, Evaluation, ahp_weights,
                        context_ahp, evolve_pareto, nondominated_front,
                        select_online)
from .profiler import (H100_SXM, MOBILE_CPU, Calibration, HardwareProfile,
                       LayerCost, RooflineTerms, analytic_step_costs,
                       collective_bytes_from_hlo,
                       collective_bytes_scan_corrected, estimate_energy,
                       estimate_latency, layer_costs, model_flops_estimate,
                       rank_consistency, roofline_terms, scan_trip_count)

__all__ = ["analytic_step_costs", "Action", "OffloadChoice",
           "default_action_space", "AdaptationLoop", "Calibration",
           "Decision", "Middleware", "ResourceContext", "ResourceMonitor",
           "budget_sweep_trace", "case_study_trace", "constant_trace",
           "dvfs_spike_trace", "shape_context", "shaped_trace",
           "ActionEvaluator", "Budgets", "Evaluation", "ahp_weights",
           "context_ahp", "evolve_pareto", "nondominated_front",
           "select_online", "HardwareProfile", "H100_SXM", "LayerCost",
           "MOBILE_CPU", "RooflineTerms", "estimate_energy",
           "estimate_latency", "layer_costs", "model_flops_estimate",
           "rank_consistency", "roofline_terms",
           "collective_bytes_from_hlo", "collective_bytes_scan_corrected",
           "scan_trip_count"]
