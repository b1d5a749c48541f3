"""LightGCN[Opti] training and its checkpoint IO."""
