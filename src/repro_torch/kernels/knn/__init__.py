from repro_torch.kernels.knn.ops import knn_predict, pairwise_sq_dists
