"""The deterministic half of ``test_profiler_calibration.py`` in the port.

The reference test ranks a ladder of 4 paper-backbone variants (full,
width 0.75, width 0.5 at depth 0.75, width 0.5 at depth 0.5) by their
``MOBILE_CPU`` estimates at tokens (2, 256) against jitted CPU wall
times, and asserts ``rank_consistency >= 0.79``.  Its wall-clock half
reads a loaded machine's clock and is flaky under a parallel run (R6 in
ROADMAP.md), so it has no twin here; on the card ``chip_smoke.py``
phase 6 ranks the same ladder's ``H100_SXM`` estimates against device
time, and a ``gpu``-marked test holds that ranking.

Here the ladder is derived in both packages from the same weights: the
variant configs are equal, and so are the estimates the ranking is made
of (``estimate_latency(layer_costs(cfg, 2, 256), 0.5, MOBILE_CPU)``,
pure arithmetic), and the port's ``H100_SXM`` estimates, which the card
ranks, fall down the ladder as the reference's do.
"""
import numpy as np
import pytest

import jax

from repro.configs import get_config as j_get_config
from repro.core import MOBILE_CPU as J_MOBILE
from repro.core import estimate_latency as j_estimate
from repro.core import layer_costs as j_layer_costs
from repro.core import rank_consistency as j_rank
from repro.elastic import VariantSpec as JSpec
from repro.elastic import derive_variant as j_derive
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config
from repro_torch.core import (H100_SXM, MOBILE_CPU, estimate_latency,
                              layer_costs, rank_consistency)
from repro_torch.elastic import VariantSpec, derive_variant
from repro_torch.weights import params_from_numpy

LADDER = (dict(), dict(width_ratio=0.75),
          dict(width_ratio=0.5, depth_ratio=0.75),
          dict(width_ratio=0.5, depth_ratio=0.5))


def _ladders():
    jcfg = j_get_config("paper-backbone")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    cfg = get_config("paper-backbone")
    j_ladder = [j_derive(jcfg, jp, JSpec(**kw))[0] for kw in LADDER]
    t_ladder = [derive_variant(cfg, tp, VariantSpec(**kw))[0]
                for kw in LADDER]
    return j_ladder, t_ladder


J_LADDER, T_LADDER = _ladders()


def test_ladder_variant_configs_match_reference():
    """Each rung's config equals the reference's field by field (the
    JAX package's configs module is its own copy)."""
    for jv, tv in zip(J_LADDER, T_LADDER):
        assert vars(tv) == vars(jv)
    assert len(set(T_LADDER)) == 4


def test_ladder_estimates_match_reference():
    """``estimate_latency(layer_costs(vcfg, 2, 256), 0.5, MOBILE_CPU)``
    equals the reference's on every rung, and the estimates fall down
    the ladder (the order the measured times must follow)."""
    est = [estimate_latency(layer_costs(v, 2, 256), 0.5, MOBILE_CPU)
           for v in T_LADDER]
    j_est = [j_estimate(j_layer_costs(v, 2, 256), 0.5, J_MOBILE)
             for v in J_LADDER]
    assert est == pytest.approx(j_est, rel=1e-12, abs=0.0)
    assert est == sorted(est, reverse=True)
    assert rank_consistency(est, est) == j_rank(j_est, j_est) == 1.0


def test_ladder_h100_estimates_fall_down_the_ladder():
    """The port's own ``H100_SXM`` profile (no JAX counterpart), which
    phase 6 ranks on the card, orders the ladder as ``MOBILE_CPU``
    does."""
    est = [estimate_latency(layer_costs(v, 2, 256), 0.5, H100_SXM)
           for v in T_LADDER]
    assert est == sorted(est, reverse=True) and len(set(est)) == 4
