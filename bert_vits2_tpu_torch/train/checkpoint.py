"""Training checkpoints in the reference's layout, with retention, and the
bootstrap from reference checkpoints (reference: utils.py:123-141
save_checkpoint, utils.py:66-121 load_checkpoint, utils.py:271-317
clean_checkpoints).

Counterpart of `bert_vits2_tpu/train/checkpoint.py`. The JAX package keeps
its own training state in orbax directories; the port writes what the
reference's train_ms.py writes instead: `G_{step}.pth`, `D_{step}.pth`,
`DUR_{step}.pth` and, with the SLM losses, `WD_{step}.pth`, each
`{"model", "iteration", "optimizer", "learning_rate"}` with the module's
state_dict under the reference's names and the torch AdamW state. A
reference tool, or the JAX package's importer, reads them as it reads the
reference's own files. The frozen WavLM is never stored: it is an input,
read again from its own directory. The port does not read the JAX
package's orbax directories.
"""

from __future__ import annotations

import os
import re

import torch

from bert_vits2_tpu_torch.train.step import Models, TrainState

_PREFIXES = ("G", "D", "DUR", "WD")
_STRIP = ("module.", "_orig_mod.")


def _pairs(models: Models, state: TrainState | None):
    """(file prefix, module, optimizer) of each present model."""
    opts = (None,) * 4 if state is None else (
        state.opt_g, state.opt_d, state.opt_dd, state.opt_wd)
    for prefix, module, opt in zip(_PREFIXES, models, opts):
        if module is not None:
            yield prefix, module, opt


def _steps(directory: str, prefix: str) -> list[int]:
    """The steps of `{prefix}_{step}.pth` files in directory, ascending."""
    if not os.path.isdir(directory):
        return []
    found = (re.fullmatch(rf"{prefix}_(\d+)\.pth", f) for f in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _path(directory: str, prefix: str, step: int) -> str:
    return os.path.join(directory, f"{prefix}_{step}.pth")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def latest_step(directory: str) -> int | None:
    """The newest step with a generator checkpoint in directory, or None."""
    steps = _steps(directory, "G")
    return steps[-1] if steps else None


def save_train_state(directory: str, step: int, models: Models,
                     state: TrainState, learning_rate: float,
                     keep: int = 8) -> None:
    """Write G_/D_/DUR_/WD_{step}.pth and keep the newest `keep` of each."""
    os.makedirs(directory, exist_ok=True)
    for prefix, module, opt in _pairs(models, state):
        path = _path(directory, prefix, step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": _to_cpu(module.state_dict()), "iteration": step,
                    "optimizer": _to_cpu(opt.state_dict()),
                    "learning_rate": float(learning_rate)}, tmp)
        os.replace(tmp, path)
        for old in _steps(directory, prefix)[:-keep]:
            os.remove(_path(directory, prefix, old))


def restore_train_state(directory: str, models: Models, state: TrainState,
                        step: int | None = None) -> tuple[TrainState, int | None]:
    """Load the models' parameters and the optimizers' state of `step` (the
    newest by default) from this trainer's own checkpoints, strictly.
    Returns (state, step), (state, None) when there is none."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return state, None
    for prefix, module, opt in _pairs(models, state):
        ckpt = torch.load(_path(directory, prefix, step), map_location="cpu",
                          weights_only=True)
        module.load_state_dict(ckpt["model"], strict=True)
        opt.load_state_dict(ckpt["optimizer"])
    state.step = step
    return state, step


def bootstrap_from_reference(directory: str, models: Models) -> tuple[int, dict]:
    """Load the newest reference G_/D_/DUR_/WD_*.pth found in directory into the
    models (the reference's resume glob, utils.py:163-167): the parameters
    only, after stripping the `module.` (DDP) and `_orig_mod.`
    (torch.compile) prefixes, with load_state_dict(strict=False) as the
    JAX package imports them. Missing files leave a model as it is.
    Returns (the generator file's iteration or 0, {prefix: the keys the
    file lacked and the keys the model lacked})."""
    iteration, report = 0, {}
    for prefix, module, _ in _pairs(models, None):
        steps = _steps(directory, prefix)
        if not steps:
            continue
        ckpt = torch.load(_path(directory, prefix, steps[-1]), map_location="cpu",
                          weights_only=True)
        sd = {}
        for key, value in ckpt["model"].items():
            while key.startswith(_STRIP):
                key = key.split(".", 1)[1]
            sd[key] = value
        res = module.load_state_dict(sd, strict=False)
        report[prefix] = (res.missing_keys, res.unexpected_keys)
        if prefix == "G":
            iteration = int(ckpt.get("iteration") or 0)
    return iteration, report
