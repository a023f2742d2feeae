"""Layers shared by the port's models."""
