from .graph_ir import Graph, OpNode, build_model_graph, execute
from .partition import PrePartition, Unit, independent_flows, pre_partition
from .placer import (DEVICE_POOLS, NO_NEXT_LINK, DeviceProfile, Placement,
                     local_only, place_cas, place_dads, place_dp)
from .transform import (classify_constants, convert, eliminate_dead,
                        eliminate_duplicates, fold_constants,
                        fuse_linear_chains)

__all__ = ["Graph", "OpNode", "build_model_graph", "execute", "PrePartition",
           "Unit", "independent_flows", "pre_partition", "DEVICE_POOLS",
           "NO_NEXT_LINK", "DeviceProfile", "Placement", "local_only",
           "place_cas",
           "place_dads", "place_dp", "classify_constants", "convert",
           "eliminate_dead", "eliminate_duplicates", "fold_constants",
           "fuse_linear_chains"]
