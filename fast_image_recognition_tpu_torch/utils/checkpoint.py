"""Checkpoints without flax (JAX ``utils/checkpoint.py``): msgpack save and load,
``BestCheckpoint``, ``EarlyStopping``, ``ema_update``, ``EmbeddingCache``."""

import os
from typing import Any, Optional, Sequence

import numpy as np

from .msgpack_lite import msgpack_restore, to_bytes


def save_variables(path: str, variables) -> None:
    with open(path, "wb") as fh:
        fh.write(to_bytes(variables))


def _restore(template, state):
    """flax ``from_state_dict``: a list or tuple of the template back from its "0", "1", ... map."""
    if isinstance(template, dict):
        return {k: _restore(v, state[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(v, state[str(i)]) for i, v in enumerate(template))
    return state


def load_variables(path: str, template=None) -> Any:
    """Flax-msgpack checkpoint -> nested dicts of numpy arrays, as the JAX package's; with a ``template``,
    its structure."""
    with open(path, "rb") as fh:
        state = msgpack_restore(fh.read())
    return state if template is None else _restore(template, state)


def _better(mode: str, metric: float, best: Optional[float]) -> bool:
    return best is None or (mode == "max" and metric > best) or (mode == "min" and metric < best)


class BestCheckpoint:
    """Keeps the best-metric variables on disk."""

    def __init__(self, path: str, mode: str = "max"):
        self.path, self.mode, self.best = path, mode, None

    def update(self, metric: float, variables) -> bool:
        better = _better(self.mode, metric, self.best)
        if better:
            self.best = float(metric)
            save_variables(self.path, variables)
        return better


class EarlyStopping:
    """``update`` returns True once ``patience`` epochs in a row did not improve."""

    def __init__(self, patience: int = 5, mode: str = "max"):
        self.patience, self.mode, self.best, self.bad_epochs = patience, mode, None, 0

    def update(self, metric: float) -> bool:
        if _better(self.mode, metric, self.best):
            self.best, self.bad_epochs = float(metric), 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs > self.patience


def ema_update(ema_params, params, decay: float = 0.9999):
    """``decay * ema + (1 - decay) * p`` leaf by leaf."""
    if isinstance(ema_params, dict):
        return {k: ema_update(v, params[k], decay) for k, v in ema_params.items()}
    if isinstance(ema_params, (list, tuple)):
        return type(ema_params)(ema_update(e, p, decay) for e, p in zip(ema_params, params))
    return decay * ema_params + (1.0 - decay) * params


class EmbeddingCache:
    """npz per-level embeddings keyed by network name and tag."""

    def __init__(self, directory: str, network_name: str):
        self.directory, self.network_name = directory, network_name
        os.makedirs(directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{self.network_name}{tag}.npz")

    def exists(self, tag: str) -> bool:
        return os.path.exists(self._path(tag))

    def save(self, tag: str, levels: Sequence[np.ndarray], labels: np.ndarray) -> None:
        np.savez(self._path(tag), labels=labels, **{f"level_{i}": np.asarray(x) for i, x in enumerate(levels)})

    def load(self, tag: str):
        z = np.load(self._path(tag))
        levels = []
        while f"level_{len(levels)}" in z:
            levels.append(z[f"level_{len(levels)}"])
        return levels, z["labels"]
