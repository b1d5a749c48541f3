"""Logging, stage timing, device resolution and the artifact cache."""
