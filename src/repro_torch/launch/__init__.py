"""Drivers: the train / prefill / serve steps, the training and serving
loops (``train.py``, ``serve.py``), the sharding rules and meshes (for
one card) and the one-card planner (``dryrun.py``)."""
from .mesh import batch_axes, make_debug_mesh, make_production_mesh
from .sharding import (batch_specs, cache_specs, opt_state_specs,
                       param_specs, to_shardings)
from .steps import (cache_spec_struct, input_specs, make_prefill_step,
                    make_serve_step, make_step, make_train_step, options_for,
                    params_spec_struct)

__all__ = ["batch_axes", "make_debug_mesh", "make_production_mesh",
           "batch_specs", "cache_specs", "opt_state_specs", "param_specs",
           "to_shardings", "cache_spec_struct", "input_specs",
           "make_prefill_step", "make_serve_step", "make_step",
           "make_train_step", "options_for", "params_spec_struct"]
