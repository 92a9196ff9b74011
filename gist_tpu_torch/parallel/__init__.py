"""Multi-rank graph parallelism on ``torch.distributed``
(``gist_tpu/parallel``): one graph's nodes, edges and features
partitioned over the ``graph`` dim of a mesh, each aggregation
exchanging only the boundary ("halo") rows around a ring."""

from gist_tpu_torch.parallel.graph_shard import (ShardedGraph,
                                                 build_sharded_graph,
                                                 sharded_aggregate)
from gist_tpu_torch.parallel.layers import (sharded_gat_attention,
                                            sharded_halo, sharded_mean_agg,
                                            sharded_sum_agg,
                                            sharded_whole_tensor_layer_norm)
