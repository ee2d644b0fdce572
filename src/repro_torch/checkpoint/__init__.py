"""Checkpoint and wire serialization of the port."""
