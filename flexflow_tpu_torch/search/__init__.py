"""The cost model and the strategy search (counterpart of
flexflow_tpu/search/): machine models, CostModel / Simulator /
OpCostCache, the Unity and MCMC searches, the plan cache and the graph
rewrites."""
from .machine_model import (MachineModel, NetworkedMachineModel,
                            SimpleMachineModel, TpuPodModel)
from .mcmc import mcmc_optimize
from .simulator import CostModel, OpCostCache, Simulator
from .unity import GraphSearchHelper, unity_optimize

__all__ = [
    "MachineModel",
    "SimpleMachineModel",
    "TpuPodModel",
    "NetworkedMachineModel",
    "CostModel",
    "Simulator",
    "OpCostCache",
    "GraphSearchHelper",
    "unity_optimize",
    "mcmc_optimize",
]
