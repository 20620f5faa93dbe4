"""GNN substrate: the paper's own experimental domain (GCN / GraphSAGE),
full-graph and partition-sampled mini-batch training."""
from repro_torch.graph.analysis import collect_layer_stats
from repro_torch.graph.data import (Graph, arxiv_like, cora_like, flickr_like,
                                    papers100m_like, stream_edge_chunks,
                                    synthetic_graph, synthetic_graph_streamed)
from repro_torch.graph.models import GNN, GNNConfig, params_from_numpy
from repro_torch.graph.sampling import (SubgraphBatch, bfs_partition,
                                        make_subgraph_batches,
                                        random_partition)
from repro_torch.graph.train import (activation_memory_report, train_gnn,
                                     train_gnn_batched)

__all__ = [
    "Graph", "arxiv_like", "cora_like", "flickr_like", "synthetic_graph",
    "papers100m_like", "stream_edge_chunks", "synthetic_graph_streamed",
    "GNN", "GNNConfig", "params_from_numpy",
    "SubgraphBatch", "bfs_partition", "random_partition",
    "make_subgraph_batches",
    "train_gnn", "train_gnn_batched", "activation_memory_report",
    "collect_layer_stats",
]
