"""Sampling-based motion planning with device-batched evaluation.

JAX-native re-design of the reference's planner stack
(ref: ctrl/graph_alg/rr_tree.hpp:179, rrt_star.hpp:530,
probabilistic_roadmap.hpp:309, sbastar_search.hpp:869,
ctrl/path_planning/rrt_path_planner.hpp:64, metric_space_search.hpp:172
dvp_tree, planner_exec_engines.hpp:86-324).

Architecture (SURVEY.md §7.7): tree bookkeeping stays on the host (cheap,
pointer-heavy), while EVERYTHING expensive runs on device in large batches —
K samples per iteration, K nearest-neighbor searches against the whole vertex
set (one masked distance matrix), K steer/collision evaluations.  This
replaces the reference's one-sample-at-a-time loop (rr_tree.hpp:194) with a
batch-parallel expansion wave, and the DVP-tree with masked brute-force NN on
device (exact, and faster than tree traversal below ~10⁶ vertices).
"""
from reak_tpu.planning.workspace import (
    Workspace,
    NoObstacleWorkspace,
    ChainWorkspace,
    bitmap_workspace,
)
from reak_tpu.planning.rrt import rrt_plan, birrt_plan
from reak_tpu.planning.rrt_star import rrt_star_plan
from reak_tpu.planning.prm import prm_plan
from reak_tpu.planning.sbastar import sbastar_plan
from reak_tpu.planning.queries import PlanningQuery, PlanResult, path_cost
from reak_tpu.planning.engines import monte_carlo_engine
from reak_tpu.planning.adstar import ADStar, adstar_search
from reak_tpu.planning.fadprm import FADPRMPlanner, fadprm_plan
from reak_tpu.planning.rrg import rrg_plan
from reak_tpu.planning.dvp_tree import DVPTree, linear_nn
from reak_tpu.planning.intercept import (InterceptQuery, intercept_plan,
                                         RendezvousQuery, intercept_plan_1st_order)

__all__ = [
    "ADStar",
    "adstar_search",
    "FADPRMPlanner",
    "fadprm_plan",
    "rrg_plan",
    "DVPTree",
    "linear_nn",
    "InterceptQuery",
    "intercept_plan",
    "RendezvousQuery",
    "intercept_plan_1st_order",
    "Workspace",
    "NoObstacleWorkspace",
    "ChainWorkspace",
    "rrt_plan",
    "birrt_plan",
    "rrt_star_plan",
    "prm_plan",
    "sbastar_plan",
    "PlanningQuery",
    "PlanResult",
    "path_cost",
    "monte_carlo_engine",
]
from reak_tpu.planning.sbastar_rrtstar import sbastar_rrtstar_plan
from reak_tpu.planning.lazy_prm import lazy_prm_plan, bnb_prune
from reak_tpu.planning.reach_sort import ReachabilitySortedSet
