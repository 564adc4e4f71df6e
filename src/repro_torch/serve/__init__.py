"""BPMF posterior-predictive serving: retained draws -> recommendations.

  ensemble.py  PosteriorEnsemble: stacked draws, posterior-mean scores and
               predictive variance, the (M, S*K) / (N, S*K) scoring pair
  cluster.py   the serving tier: ShardHost (resident V' item shard and the
               U table) and ClusterCoordinator (candidate gather and merge,
               channel fan-out, quorum epoch barrier, per-shard replicas and
               failover), hosts placed over devices (`devices=`, `mesh=`)
  faults.py    deterministic chaos: FaultPlan (seeded kill/hang/delay/drop
               schedules at named seams), injectable clocks, HostHealth
  topn.py      SeenIndex and TopNRecommender, the colocated special case
  foldin.py    cold-start fold-in over a stacked draw axis through the
               sweep's kernels; FoldInPlanCache keeps batch shapes stable
  publish.py   PublicationChannel: the in-memory trainer -> server hand-off
  frontend.py  RecommendFrontend: request micro-batching, refreshed by
               channel subscription (push) or store poll
"""
from repro_torch.serve.cluster import ClusterCoordinator, ShardHost
from repro_torch.serve.ensemble import PosteriorEnsemble
from repro_torch.serve.faults import (
    Clock,
    FaultEvent,
    FaultPlan,
    HostHealth,
    StepClock,
    assert_holds,
    debug_locks_enabled,
)
from repro_torch.serve.foldin import FoldInPlanCache, fold_in, fold_in_loop
from repro_torch.serve.frontend import RecommendFrontend, RecommendResult
from repro_torch.serve.publish import ChannelSnapshot, PublicationChannel
from repro_torch.serve.topn import SeenIndex, TopNRecommender

__all__ = [
    "ChannelSnapshot",
    "Clock",
    "ClusterCoordinator",
    "FaultEvent",
    "FaultPlan",
    "FoldInPlanCache",
    "HostHealth",
    "ShardHost",
    "StepClock",
    "PosteriorEnsemble",
    "PublicationChannel",
    "fold_in",
    "fold_in_loop",
    "RecommendFrontend",
    "RecommendResult",
    "SeenIndex",
    "TopNRecommender",
    "assert_holds",
    "debug_locks_enabled",
]
