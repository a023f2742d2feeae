"""The segmenter's concept signatures (the port's copy of
``gvl_tpu.training.segmenter_train.CONCEPT_SPECS``): the shape and colour
each concept is drawn with in the synthetic ``concept_demo`` clips, the
ones the shipped segmenter checkpoint was trained on.  The trainer stays
in the JAX package."""

from __future__ import annotations

# concept → drawing signature (shape kind, RGB base). Distinctive per
# concept so open-vocab selection is learnable from scratch.
CONCEPT_SPECS: dict[str, tuple[str, tuple[int, int, int]]] = {
    "player": ("square", (60, 90, 220)),
    "enemy": ("triangle", (220, 60, 50)),
    "boss": ("ellipse", (160, 60, 200)),
    "item": ("diamond", (230, 200, 50)),
}
CONCEPTS = tuple(CONCEPT_SPECS)
