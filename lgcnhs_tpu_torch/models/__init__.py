"""LightGCN tables, the spread and fusion models, and model dispatch."""
