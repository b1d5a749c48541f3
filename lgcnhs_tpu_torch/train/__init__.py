"""Checkpoint IO (training is not ported yet)."""
