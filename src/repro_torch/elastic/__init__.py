"""Elastic inference: the η1–η6 operators, the weight-recycled supernet,
early exits, ensemble training and test-time adaptation."""
from .operators import (FULL_SPEC, NAMED_COMBOS, OPERATOR_NAMES, VariantSpec,
                        derive_variant, variant_cost)
from .supernet import ElasticSupernet
from .early_exit import (attach_exits, early_exit_predict,
                         expected_exit_flops, forward_with_exits)
from .ensemble import ensemble_loss, sample_variant_specs, sliced_forward
from .tta import NORM_KEYS, tta_grads, tta_loss, tta_step

__all__ = ["FULL_SPEC", "NAMED_COMBOS", "OPERATOR_NAMES", "VariantSpec",
           "derive_variant", "variant_cost", "ElasticSupernet",
           "attach_exits", "early_exit_predict", "expected_exit_flops",
           "forward_with_exits", "ensemble_loss", "sample_variant_specs",
           "sliced_forward", "NORM_KEYS", "tta_grads", "tta_loss",
           "tta_step"]
