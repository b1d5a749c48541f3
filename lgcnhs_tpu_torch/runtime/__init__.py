"""Logging, stage timing and device resolution."""
