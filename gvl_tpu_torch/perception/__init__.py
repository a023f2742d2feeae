"""Perception of the port: region semantic encoding."""
