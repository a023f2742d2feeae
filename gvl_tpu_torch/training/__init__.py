"""Serving half of the QA language model's training module."""
