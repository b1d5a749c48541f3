"""Dataset synthesis, rating pipeline and graph arrays (numpy only)."""
