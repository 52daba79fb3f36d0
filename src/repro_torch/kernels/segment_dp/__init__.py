from repro_torch.kernels.segment_dp.ops import fit_cuts, segment_cost
