"""Optimizer and learning-rate schedule of the train step."""
