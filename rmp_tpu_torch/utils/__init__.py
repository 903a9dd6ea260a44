"""Utilities of the port: checkpoints (`utils/checkpoint.py`)."""
