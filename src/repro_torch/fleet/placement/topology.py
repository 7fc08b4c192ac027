"""Fleet link topology: who can reach whom, and how fast.

The static ``DEVICE_POOLS`` chains carried a single ``link_bw`` scalar
per hop; a live fleet needs links between *members* to be first-class.
Every :class:`~repro_torch.fleet.registry.DeviceSpec` carries a ``site``;
devices sharing a site talk over the site's LAN, cross-site hops pay the
WAN's lower bandwidth and higher RTT.  :class:`SiteTopology` maps any
ordered pair of sites to a :class:`LinkSpec` (with optional per-pair
overrides — e.g. two campuses joined by a fat fiber link), which the
fleet placer turns into per-hop ``DeviceProfile.link_bw`` values for the
offloading DP and into the migration-cost model (parameter bytes moved
over the actual link when a placement changes hosts).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.fleet.registry import DeviceSpec

LAN, WAN, LOOPBACK = "lan", "wan", "loopback"


@dataclass(frozen=True)
class LinkSpec:
    """One directed network link: sustained bandwidth plus round-trip
    latency.  ``transfer_s`` is the wire time of one tensor (RTT + bytes
    over bandwidth); ``effective_bw`` folds the RTT into an equivalent
    flat bandwidth for a *nominal* transfer size, which is what the
    bandwidth-only placement DP consumes."""
    bandwidth_bytes_s: float
    rtt_s: float = 0.0
    kind: str = LAN

    def transfer_s(self, nbytes: float) -> float:
        return self.rtt_s + nbytes / max(self.bandwidth_bytes_s, 1.0)

    def effective_bw(self, nominal_bytes: float) -> float:
        """Flat bytes/s equivalent for transfers of ``nominal_bytes``:
        small tensors over a high-RTT WAN see far less than the wire
        rate.  This is the value handed to ``DeviceProfile.link_bw``."""
        t = self.transfer_s(nominal_bytes)
        return nominal_bytes / max(t, 1e-12)


# order-of-magnitude defaults: a home/office LAN (Wi-Fi 6 / GbE class)
# and a metered uplink between sites
DEFAULT_LAN = LinkSpec(bandwidth_bytes_s=125e6, rtt_s=2e-4, kind=LAN)
DEFAULT_WAN = LinkSpec(bandwidth_bytes_s=12.5e6, rtt_s=2e-2, kind=WAN)
# a device talking to itself (placement chain of length 1)
SELF_LINK = LinkSpec(bandwidth_bytes_s=float("inf"), rtt_s=0.0,
                     kind=LOOPBACK)


@dataclass
class SiteTopology:
    """Site-pair → link map for one fleet.

    Same-site pairs resolve to ``lan``, cross-site pairs to ``wan``,
    unless an explicit override exists for the (unordered) site pair.
    The topology is deliberately ignorant of individual devices — a
    device's location is its :attr:`DeviceSpec.site`, so membership
    churn never touches the topology."""
    lan: LinkSpec = DEFAULT_LAN
    wan: LinkSpec = DEFAULT_WAN
    overrides: Dict[Tuple[str, str], LinkSpec] = field(default_factory=dict)

    def link(self, site_a: str, site_b: str) -> LinkSpec:
        """The link between two sites (loopback if they are one device's
        own site paired with itself is *not* special-cased — same site
        means LAN; use :data:`SELF_LINK` for a degenerate 1-chain)."""
        key = (site_a, site_b) if site_a <= site_b else (site_b, site_a)
        if key in self.overrides:
            return self.overrides[key]
        return self.lan if site_a == site_b else self.wan

    def link_between(self, a: DeviceSpec, b: DeviceSpec) -> LinkSpec:
        return self.link(a.site, b.site)

    def same_site(self, a: DeviceSpec, b: DeviceSpec) -> bool:
        return a.site == b.site
