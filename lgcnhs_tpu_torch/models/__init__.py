"""LightGCN tables, LGCNHS fused serving and checkpoint dispatch."""
