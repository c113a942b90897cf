"""Utilities of the port: the flax -> torch weight bridge (weights.py) and
seeded weights for runs without a checkpoint (seeded.py)."""
