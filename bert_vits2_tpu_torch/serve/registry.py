"""Multi-model registry with refcounted weight sharing (reference:
hiyoriUI.py:74-160 Models).

Engines are loaded once per realpath(checkpoint); multiple model ids can
alias the same underlying engine (the reference's path2ids refcounting).
"""

from __future__ import annotations

import os
import threading
from typing import Callable


class ModelRegistry:
    def __init__(self, loader: Callable | None = None):
        """loader(checkpoint_path, config_path) -> engine (e.g. TTSEngine)."""
        self._loader = loader
        self._lock = threading.Lock()
        self.models: dict[int, dict] = {}  # id -> {engine, path, config_path}
        self.path2ids: dict[str, set] = {}
        self._next_id = 0

    def init_model(
        self, checkpoint_path: str, config_path: str, engine=None
    ) -> int:
        """Load (or alias) a model; returns its model id."""
        real = os.path.realpath(checkpoint_path)
        with self._lock:
            if engine is None:
                for mid, info in self.models.items():
                    if info["path"] == real:
                        engine = info["engine"]
                        break
            if engine is None:
                if self._loader is None:
                    raise ValueError("no loader configured and no engine given")
                engine = self._loader(checkpoint_path, config_path)
            mid = self._next_id
            self._next_id += 1
            self.models[mid] = {
                "engine": engine,
                "path": real,
                "config_path": os.path.realpath(config_path),
            }
            self.path2ids.setdefault(real, set()).add(mid)
            return mid

    def get(self, model_id: int):
        return self.models[model_id]["engine"]

    def __contains__(self, model_id: int) -> bool:
        return model_id in self.models

    def del_model(self, model_id: int) -> int | None:
        """Drop one alias; weights free when the last alias goes."""
        engine, _ = self.release(model_id)
        return model_id if engine is not None else None

    def release(self, model_id: int):
        """Atomically drop an alias -> (engine, still_referenced).

        `still_referenced` is computed under the registry lock so callers can
        safely retire per-engine resources (batcher workers) without racing
        concurrent add/delete handlers."""
        with self._lock:
            if model_id not in self.models:
                return None, False
            info = self.models.pop(model_id)
            ids = self.path2ids.get(info["path"], set())
            ids.discard(model_id)
            if not ids:
                self.path2ids.pop(info["path"], None)
            engine = info["engine"]
            still = any(i["engine"] is engine for i in self.models.values())
            return engine, still

    def info(self) -> dict:
        """Per-model metadata for /models/info (hiyoriUI.py:472-500)."""
        out = {}
        for mid, info in sorted(self.models.items()):
            engine = info["engine"]
            out[str(mid)] = {
                "config_path": info["config_path"],
                "model_path": info["path"],
                "device": str(engine.device),
                "language": getattr(engine, "languages", ["ZH", "JP", "EN"]),
                "speakers": getattr(engine, "spk2id", {}),
            }
        return out
