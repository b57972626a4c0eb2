"""Schedule Engine planners (paper §4): dataflow, graph, DVFS and RNG, plus
the MoE expert-placement extension."""
from .dataflow import DataflowPlan, plan_dataflow
from .graph import GraphPlan, minimax_layer_partition, brute_force_partition
from .dvfs import DvfsPlan, plan_dvfs, bisect_min_feasible
from .rng import RngPlan, plan_rng_reshard
from .expert import ExpertPlan, plan_expert_reshard, lpt_placement
