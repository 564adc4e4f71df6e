"""BPMF posterior-predictive serving: retained draws -> recommendations.

  ensemble.py  PosteriorEnsemble: stacked draws, posterior-mean scores and
               predictive variance, the (M, S*K) / (N, S*K) scoring pair
  cluster.py   ShardHost and ClusterCoordinator: per-shard candidates from
               the topn_scores kernel and their stable merge
  topn.py      SeenIndex and TopNRecommender, the single-host recommender
"""
from repro_torch.serve.cluster import ClusterCoordinator, ShardHost
from repro_torch.serve.ensemble import PosteriorEnsemble
from repro_torch.serve.topn import SeenIndex, TopNRecommender

__all__ = [
    "ClusterCoordinator",
    "PosteriorEnsemble",
    "SeenIndex",
    "ShardHost",
    "TopNRecommender",
]
