"""Flat-npz checkpoint reader (counterpart of :mod:`gvl_tpu.utils.checkpoints`).

Parameter trees are saved with ``np.savez`` under ``/``-joined key paths;
a ``/`` inside a name is escaped as ``\\/`` (and a backslash as ``\\\\``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def split_key(key: str) -> tuple:
    """Split on ``/`` not preceded by a backslash, then unescape."""
    parts, cur, i = [], [], 0
    while i < len(key):
        ch = key[i]
        if ch == "\\" and i + 1 < len(key):
            cur.append(key[i + 1])
            i += 2
        elif ch == "/":
            parts.append("".join(cur))
            cur = []
            i += 1
        else:
            cur.append(ch)
            i += 1
    parts.append("".join(cur))
    return tuple(parts)


def load_flat_npz(path) -> dict:
    """Nested dict of numpy arrays from a flat-npz checkpoint."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = split_key(key)
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


REPO_ROOT = Path(__file__).resolve().parents[2]


def resolve_repo_path(path) -> Optional[str]:
    """Path as given if it exists, else relative to the repository root
    (``gvl_tpu.utils.checkpoints.resolve_repo_path``)."""
    if not path:
        return None
    p = Path(path)
    if p.exists():
        return str(p)
    rooted = REPO_ROOT / p
    return str(rooted) if rooted.exists() else None
