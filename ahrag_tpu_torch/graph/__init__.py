from ahrag_tpu_torch.graph.host import HierarchicalGraph
from ahrag_tpu_torch.graph.search import (SearchResult, SearchWeights, hybrid_search,
                                          hybrid_search_batch)
from ahrag_tpu_torch.graph.tensors import GraphTensors, build_graph_tensors
