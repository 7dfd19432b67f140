"""Reproducibility stamps (reference: utils.check_git_hash, utils.py:341-363).

Records the framework git revision in the model dir and warns when resuming
with a different revision. A copy of `bert_vits2_tpu/utils/repro.py`.
"""

from __future__ import annotations

import logging
import os
import subprocess

logger = logging.getLogger("bert_vits2_tpu_torch")


def current_git_hash() -> str | None:
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    if not os.path.isdir(os.path.join(src_dir, ".git")):
        return None
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=src_dir,
                stderr=subprocess.DEVNULL,
            )
            .decode()
            .strip()
        )
    except (OSError, subprocess.CalledProcessError):
        return None


def check_git_hash(model_dir: str) -> None:
    cur = current_git_hash()
    if cur is None:
        return
    path = os.path.join(model_dir, "githash")
    if os.path.isfile(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur:
            logger.warning(
                "git hash values are different. %s (saved) != %s (current)",
                saved[:8], cur[:8],
            )
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur)
