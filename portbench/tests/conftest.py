"""The benchmark's CPU tests run in several worker processes at once: one
thread of torch each, so that they do not starve each other (a tiny
training window is a few seconds of wall time)."""
import torch

torch.set_num_threads(1)
