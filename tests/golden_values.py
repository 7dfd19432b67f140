"""Committed JAX values for the port's parity tests.

A test whose JAX side would compile a large graph reads that graph's
outputs from `tests/goldens/<name>.npz` instead. A script beside the file
(`tests/goldens/make_<name>.py`) holds the JAX composition and writes it
from the test's own inputs; the file stores a fingerprint of those inputs,
and `load` refuses values whose inputs have changed since."""

from __future__ import annotations

import numpy as np

import jax


def _numbers(leaf) -> np.ndarray:
    if leaf is None:
        return np.zeros(1)
    if isinstance(leaf, str):
        return np.frombuffer(leaf.encode(), np.uint8).astype(np.float64)
    return np.asarray(leaf, np.float64).ravel()


def fingerprint(*values) -> np.ndarray:
    """A few float64 sums over every array leaf and scalar of `values`
    (nested dicts, lists and tuples of arrays, numbers and strings, as a
    model's config dict holds them; None counts as 0, a string as its
    UTF-8 bytes), in the order jax.tree.leaves gives."""
    leaves = jax.tree.leaves(values, is_leaf=lambda x: x is None)
    vals = np.concatenate([_numbers(a) for a in leaves])
    return np.asarray([vals.size, vals.sum(), np.abs(vals).sum(),
                       (vals * (np.arange(vals.size) % 7)).sum()])


def save(path: str, fp: np.ndarray, arrays: dict) -> None:
    np.savez_compressed(path, fingerprint=fp, **arrays)
    print(f"wrote {path}: {len(arrays)} arrays")


def load(path: str, fp: np.ndarray, script: str) -> dict:
    """The arrays of `path`, after checking that they were computed from
    inputs with fingerprint `fp` (else: rerun `script`)."""
    with np.load(path) as f:
        assert np.array_equal(f["fingerprint"], fp), f"the inputs changed: run {script}"
        return {k: f[k] for k in f.files if k != "fingerprint"}


def pick(arrays: dict, prefix: str) -> dict:
    """The entries under `prefix`, with the prefix taken off their keys."""
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def unflatten(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}} (a JAX parameter tree)."""
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten(tree: dict, prefix: str) -> dict:
    """The inverse of `unflatten`, each key under `prefix`."""
    return {"/".join([prefix] + [p.key for p in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
