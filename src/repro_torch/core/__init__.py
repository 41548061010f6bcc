"""Core: the paper's segregation algebra and the transpose-conv baselines."""
