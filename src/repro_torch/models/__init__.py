"""Models of the port: the dense decoder-only transformer (LM slice),
xDeepFM serving (recsys slice) and GCN inference (GNN slice)."""
