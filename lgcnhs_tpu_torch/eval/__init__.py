"""The six-metric evaluation of recommendation lists."""
