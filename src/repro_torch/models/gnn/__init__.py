"""GNN architectures of the port: gatedgcn, pna, gat (SpMM/segment regime)
and mace, equiformer_v2 (irrep tensor-product regime, eSCN-adapted)."""
