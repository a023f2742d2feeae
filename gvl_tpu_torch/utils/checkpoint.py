"""Step checkpoints of any nest of tensors (model and optimizer state),
with retention: the port's :class:`CheckpointManager`, with the API and
semantics of ``gvl_tpu.utils.checkpoint.CheckpointManager``.

The file format is the port's own (the JAX package writes orbax
directories): one ``torch.save`` file per step, ``<directory>/<step>/
state.pt``, written under a temporary name and renamed into place, so a
save that was cut off leaves no step behind.
"""

from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to_template(value: Any, template: Any) -> Any:
    """``value`` with each tensor moved to its template tensor's device and
    type (dicts, lists and tuples are walked in parallel)."""
    if isinstance(template, torch.Tensor):
        return value.to(template.device, template.dtype)
    if isinstance(template, dict):
        return {k: _to_template(value[k], t) for k, t in template.items()}
    if isinstance(template, (list, tuple)) and not hasattr(template, "_fields"):
        return type(template)(_to_template(v, t) for v, t in zip(value, template))
    if isinstance(template, tuple):     # a NamedTuple
        return type(template)(*(_to_template(v, t) for v, t in zip(value, template)))
    return value


class CheckpointManager:
    """Versioned step checkpoints with retention.

    >>> mgr = CheckpointManager("checkpoints/run1", max_to_keep=3)
    >>> mgr.save(step=100, state={"params": params, "opt": opt_state})
    >>> state = mgr.restore()                 # latest
    >>> state = mgr.restore(step=100)
    """

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / str(step) / STATE_FILE

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` at ``step`` (on the CPU); a step already saved is
        kept unless ``force``.  The oldest steps beyond ``max_to_keep`` are
        deleted.  Returns whether it wrote."""
        path = self._path(step)
        if path.exists() and not force:
            return False
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self.directory / str(old))
        logger.info("checkpoint saved at step %d -> %s", step, self.directory)
        return True

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The state saved at ``step`` (default the latest) on the CPU, or
        on ``template``'s devices and types; ``FileNotFoundError`` when
        there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # the file holds the optimizer's named tuples: this package's own
        # files only are read, so the full unpickler is used
        state = torch.load(self._path(step), map_location="cpu", weights_only=False)
        return state if template is None else _to_template(state, template)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.parent.name) for p in self.directory.glob(f"*/{STATE_FILE}")
                      if p.parent.name.isdigit())

    def close(self) -> None:
        """Nothing to wait for: every save has finished when it returns."""
