from repro_torch.metrics.ranking import (centroid_similarity, ils, ndcg_at_k,
                                         rbo)

__all__ = ["rbo", "ils", "ndcg_at_k", "centroid_similarity"]
