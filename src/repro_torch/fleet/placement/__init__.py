"""Fleet-aware cross-device offload placement.

Turns the live fleet — calibrated latency, DVFS state, serving load,
multi-tenant hosting — into the device pool the scalable-offloading
search places partitions onto, replacing the static ``DEVICE_POOLS``
for fleet members.  See :class:`FleetPlacer` for the search + hysteresis
+ migration model, :class:`SiteTopology` for first-class links, and
:func:`synthesize_profile` for how a member's measured state becomes an
offloading :class:`DeviceProfile`.
"""
from .placer import (FALLBACK, HOLD, INFEASIBLE, LOCAL, PLACED,
                     FleetPlacer, PlacementAudit, PlacementDecision)
from .profiles import MIN_CAPACITY_FRAC, MemberState, synthesize_profile
from .topology import (DEFAULT_LAN, DEFAULT_WAN, LAN, SELF_LINK, WAN,
                       LinkSpec, SiteTopology)

__all__ = ["FALLBACK", "HOLD", "INFEASIBLE", "LOCAL", "PLACED",
           "FleetPlacer", "PlacementAudit", "PlacementDecision",
           "MIN_CAPACITY_FRAC", "MemberState", "synthesize_profile",
           "DEFAULT_LAN", "DEFAULT_WAN", "LAN", "SELF_LINK", "WAN",
           "LinkSpec", "SiteTopology"]
