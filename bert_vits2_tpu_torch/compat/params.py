"""JAX parameter trees -> the port's state_dicts.

The inverse of the JAX package's reference import (compat/torch_import.py:
`synthesizer_rename`, `mpd_rename`, `dur_disc_rename` +
`convert_state_dict`), written against the trees' structure alone: nested
dicts of numpy arrays as the JAX package's `Synthesizer`,
`MultiPeriodDiscriminator` and `DurationDiscriminator` hold them. Layouts:

- conv `kernel` / weight-norm `v` [k, in, out] -> [out, in, k] (grouped
  convs alike, `in` being the group's share); a transposed conv's
  (`dec/ups_*`) -> [in, out, k]; a 2-D conv's [kh, kw, in, out] ->
  [out, in, kh, kw]
- weight-norm `g` [c] -> [c, 1, 1] ([c, 1, 1, 1] for a 2-D conv)
- Dense `kernel` [in, out] -> nn.Linear [out, in] (`spk_emb_linear`,
  `output_layer`) or a k=1 conv [out, in, 1] (attention q/k/v/o)
- `embedding` -> `weight`; `ElementwiseAffine` m/logs [2] -> [2, 1]
- list modules `name_i` -> `name.i`; flow couplings k -> flow.flows.{2k};
  SDP `flow_ea` -> sdp.flows.0 and ConvFlows k -> sdp.flows.{2k+1} (the
  same for the posterior `post_` chain)
- MPD `disc_s` -> discriminators.0, `disc_p<period>` -> discriminators.{1+i}
- the duration discriminator's two LSTM cells -> one bidirectional
  `nn.LSTM`: per-gate kernels stacked in torch's gate order (i, f, g, o);
  the cell's one bias goes to `bias_hh`, and `bias_ih` is zero
"""

from __future__ import annotations

import re

import numpy as np
import torch

# module lists of the reference whose entries the JAX tree names `name_i`
_LISTS = ("attn_layers", "norm_layers_1", "norm_layers_2", "ffn_layers",
          "flows", "post_flows", "convs_sep", "convs_1x1", "norms_1",
          "norms_2", "ups", "resblocks", "convs1", "convs2", "convs",
          "in_layers", "res_skip_layers")
_LIST_RE = re.compile(rf"^({'|'.join(_LISTS)})_(\d+)$")
_LINEAR = ("spk_emb_linear", "output_layer")  # Dense layers kept as nn.Linear
_LSTM_GATES = ("i", "f", "g", "o")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_path(parts: tuple[str, ...]) -> list[str]:
    out: list[str] = []
    for p in parts:
        m = _LIST_RE.match(p)
        if m is None:
            if p in ("flow_ea", "post_flow_ea"):  # SDP list entry 0
                out += [p.replace("flow_ea", "flows"), "0"]
            else:
                out.append(p)
            continue
        name, idx = m.group(1), int(m.group(2))
        if name == "flows" and out[-1:] == ["flow"]:
            idx = 2 * idx  # Flip layers sit between the couplings
        elif name in ("flows", "post_flows") and out[-1:] == ["sdp"]:
            idx = 2 * idx + 1  # after ElementwiseAffine, between Flips
        out += [name, str(idx)]
    return out


def _convert(path: list[str], leaf: str, w: np.ndarray, kernel_rank: int):
    is_convt = "ups" in path
    if leaf == "g":
        return "weight_g", w.reshape(-1, *([1] * (kernel_rank - 1)))
    if leaf in ("v", "kernel"):
        name = "weight_v" if leaf == "v" else "weight"
        if w.ndim == 4:
            return name, np.transpose(w, (3, 2, 0, 1))
        if w.ndim == 3:
            return name, np.transpose(w, (1, 2, 0) if is_convt else (2, 1, 0))
        if w.ndim == 2:
            if path[-1] in _LINEAR:
                return name, w.T
            return name, w.T[:, :, None]
        raise ValueError(f"unexpected kernel rank {w.shape} at {path}")
    if leaf == "embedding":
        return "weight", w
    if leaf in ("m", "logs"):
        return leaf, w.reshape(-1, 1)
    return leaf, w  # bias, gamma, beta, emb_rel_k, emb_rel_v


def _tensor(a: np.ndarray) -> torch.Tensor:
    # a copy: arrays handed over by JAX are read-only
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _state_dict(tree: dict, rename=lambda path: path) -> dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = dict(_flatten(tree))
    sd = {}
    for parts, w in flat.items():
        path = _module_path(parts[:-1])
        rank = flat.get(parts[:-1] + ("v",), w).ndim
        leaf, val = _convert(path, parts[-1], w, rank)
        sd[".".join(rename(path) + [leaf])] = _tensor(val)
    return sd


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX `Synthesizer` params (nested dicts of arrays, with or without the
    top-level "params" key) -> the port's state_dict (float32 CPU tensors)."""
    return _state_dict(tree)


def from_jax_mpd_params(tree: dict, periods=(2, 3, 5, 7, 11)) -> dict[str, torch.Tensor]:
    """JAX `MultiPeriodDiscriminator` params -> the port's state_dict."""
    index = {"disc_s": 0, **{f"disc_p{p}": 1 + i for i, p in enumerate(periods)}}
    return _state_dict(
        tree, lambda path: ["discriminators", str(index[path[0]])] + path[1:])


def from_jax_dur_disc_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX `DurationDiscriminator` params -> the port's state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    rest = {k: v for k, v in tree.items() if not k.startswith("lstm_")}
    sd = _state_dict(
        rest, lambda path: path + ["0"] if path == ["output_layer"] else path)
    for name, suffix in (("lstm_fwd", ""), ("lstm_bwd", "_reverse")):
        cell = tree[name]["cell"]
        w_ih = [np.asarray(cell["i" + g]["kernel"]).T for g in _LSTM_GATES]
        w_hh = [np.asarray(cell["h" + g]["kernel"]).T for g in _LSTM_GATES]
        bias = [np.asarray(cell["h" + g]["bias"]) for g in _LSTM_GATES]
        sd[f"LSTM.weight_ih_l0{suffix}"] = _tensor(np.concatenate(w_ih))
        sd[f"LSTM.weight_hh_l0{suffix}"] = _tensor(np.concatenate(w_hh))
        sd[f"LSTM.bias_hh_l0{suffix}"] = _tensor(np.concatenate(bias))
        sd[f"LSTM.bias_ih_l0{suffix}"] = torch.zeros(4 * len(bias[0]))
    return sd
