"""Logging and stage timing."""
