"""Perception of the port: region semantic encoding, concept segmentation
and tracking, OCR, and the encoders' random-weight builds for the card."""
