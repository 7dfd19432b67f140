"""JAX parameter trees <-> the port's state_dicts.

The inverse of the JAX package's reference import (compat/torch_import.py:
`synthesizer_rename`, `mpd_rename`, `dur_disc_rename` +
`convert_state_dict`; `models/slm.py:import_torch_wavlm`), written
against the trees' structure alone: nested dicts of numpy arrays as the JAX
package's `Synthesizer`, `MultiPeriodDiscriminator`,
`DurationDiscriminator`, `WavLMDiscriminator` and `WavLMJax` hold them.
Layouts:

- conv `kernel` / weight-norm `v` [k, in, out] -> [out, in, k] (grouped
  convs alike, `in` being the group's share); a transposed conv's
  (`dec/ups_*`) -> [in, out, k]; a 2-D conv's [kh, kw, in, out] ->
  [out, in, kh, kw]
- weight-norm `g` [c] -> [c, 1, 1] ([c, 1, 1, 1] for a 2-D conv)
- Dense `kernel` [in, out] -> nn.Linear [out, in] (`spk_emb_linear`,
  `output_layer`, and the V2.1/V2.2 emotion branches' `emo_proj`,
  `emo_q_proj`, `project_in`, `project_out`, `in_feature_net.{0,4}`,
  `mlp.c_fc1/c_fc2/c_proj`, `out_feature_net`) or a k=1 conv [out, in, 1]
  (attention q/k/v/o)
- `embedding` -> `weight`; flax LayerNorm `scale` -> `weight`;
  `ElementwiseAffine` m/logs [2] -> [2, 1]; a quantizer's `codebook` ->
  `_codebook.embed` (vector_quantize_pytorch's name)
- list modules `name_i` -> `name.i` (`in_feature_net_i` too, and the
  residual MLP block's `mlp_c_fc1` -> `mlp.c_fc1`); flow couplings k ->
  flow.flows.{2k}, transformer or vits1 WN couplings alike;
  SDP `flow_ea` -> sdp.flows.0 and ConvFlows k -> sdp.flows.{2k+1} (the
  same for the posterior `post_` chain)
- MPD `disc_s` -> discriminators.0, `disc_p<period>` -> discriminators.{1+i}
- the duration discriminator's two LSTM cells -> one bidirectional
  `nn.LSTM`: per-gate kernels stacked in torch's gate order (i, f, g, o);
  the cell's one bias goes to `bias_hh`, and `bias_ih` is zero
- the reference encoder's flax `GRUCell` -> `nn.GRU`: gates stacked in
  torch's order (r, z, n); the input gates' biases go to `bias_ih`, the
  `hn` bias to the n block of `bias_hh` and its r and z blocks are zero
  (both cells compute n = tanh(W_in x + b_in + r * (W_hn h + b_hn)))
- WavLM: the scanned layers 1..N-1 unstacked, `layer_0_*` back under
  `encoder.layers.0`, Dense kernels transposed, and the positional conv's
  resolved kernel split into `weight_v` (itself) and `weight_g` (its norm
  over dims 0 and 1, torch's weight norm at dim=2)

`to_jax_params` runs the Synthesizer's half backwards, from the names and
ranks alone: a 2-D `weight` is an embedding unless its module is a Dense
layer, a 1-D one a LayerNorm scale, and a [out, in, 1] `weight` of an
attention layer's conv_q/k/v/o a Dense kernel.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# module lists of the reference whose entries the JAX tree names `name_i`
_LISTS = ("attn_layers", "norm_layers_1", "norm_layers_2", "ffn_layers",
          "flows", "post_flows", "convs_sep", "convs_1x1", "norms_1",
          "norms_2", "ups", "resblocks", "convs1", "convs2", "convs",
          "in_layers", "res_skip_layers", "in_feature_net")
_LIST_RE = re.compile(rf"^({'|'.join(_LISTS)})_(\d+)$")
# Dense layers kept as nn.Linear (the others are k=1 convs)
_LINEAR = ("spk_emb_linear", "output_layer", "emo_proj", "emo_q_proj",
           "project_in", "project_out", "c_fc1", "c_fc2", "c_proj",
           "out_feature_net")
_LSTM_GATES = ("i", "f", "g", "o")
_GRU_GATES = ("r", "z", "n")


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
            elif p.startswith("mlp_"):  # V2.2's residual MLP block
                out += ["mlp", p[len("mlp_"):]]
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
            if path[-1] in _LINEAR or path[-2:-1] == ["in_feature_net"]:
                return name, w.T
            return name, w.T[:, :, None]
        raise ValueError(f"unexpected kernel rank {w.shape} at {path}")
    if leaf in ("embedding", "scale"):
        return "weight", w
    if leaf == "codebook":
        return "_codebook.embed", w
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


def _unwrap(tree: dict) -> dict:
    return tree["params"] if set(tree) == {"params"} else tree


def _dense(sd: dict, name: str, tree: dict) -> None:
    """A Dense layer -> nn.Linear `name.weight` [out, in] and `name.bias`."""
    sd[f"{name}.weight"] = _tensor(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{name}.bias"] = _tensor(tree["bias"])


def _ref_enc_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    convs = {k: v for k, v in tree.items() if k.startswith("convs_")}
    sd = _state_dict(convs, lambda path: ["ref_enc"] + path)
    _dense(sd, "ref_enc.proj", tree["proj"])
    cell = tree["GRUCell_0"]
    units = np.asarray(cell["hn"]["bias"]).shape[0]
    sd["ref_enc.gru.weight_ih_l0"] = _tensor(np.concatenate(
        [np.asarray(cell["i" + g]["kernel"]).T for g in _GRU_GATES]))
    sd["ref_enc.gru.weight_hh_l0"] = _tensor(np.concatenate(
        [np.asarray(cell["h" + g]["kernel"]).T for g in _GRU_GATES]))
    sd["ref_enc.gru.bias_ih_l0"] = _tensor(np.concatenate(
        [np.asarray(cell["i" + g]["bias"]) for g in _GRU_GATES]))
    sd["ref_enc.gru.bias_hh_l0"] = _tensor(np.concatenate(
        [np.zeros(2 * units, np.float32), np.asarray(cell["hn"]["bias"])]))
    return sd


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX `Synthesizer` params (nested dicts of arrays, with or without the
    top-level "params" key) -> the port's state_dict (float32 CPU tensors)."""
    tree = _unwrap(tree)
    rest = {k: v for k, v in tree.items() if k != "ref_enc"}
    sd = _state_dict(rest)
    if "ref_enc" in tree:
        sd.update(_ref_enc_state_dict(tree["ref_enc"]))
    return sd


def _jax_module_path(parts: list[str]) -> list[str]:
    """The inverse of `_module_path`."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        p, nxt = parts[i], parts[i + 1] if i + 1 < len(parts) else None
        if p in ("flows", "post_flows") and out[-1:] == ["sdp"]:
            idx = int(nxt)
            out.append(p.replace("flows", "flow_ea") if idx == 0
                       else f"{p}_{(idx - 1) // 2}")
            i += 2
        elif p in _LISTS and nxt is not None and nxt.isdigit():
            idx = int(nxt) // 2 if p == "flows" and out[-1:] == ["flow"] else int(nxt)
            out.append(f"{p}_{idx}")
            i += 2
        elif p == "mlp" and nxt is not None:
            out.append(f"mlp_{nxt}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _to_jax_leaf(path: list[str], leaf: str, w: np.ndarray):
    """The inverse of `_convert`: (JAX leaf name, JAX array)."""
    if leaf == "weight_g":
        return "g", w.reshape(-1)
    if leaf in ("weight_v", "weight"):
        name = "v" if leaf == "weight_v" else "kernel"
        if w.ndim == 4:
            return name, np.transpose(w, (2, 3, 1, 0))
        if w.ndim == 3:
            if "attn_layers" in path and path[-1] in ("conv_q", "conv_k", "conv_v",
                                                       "conv_o"):
                return name, w[:, :, 0].T
            return name, np.transpose(w, (2, 0, 1) if "ups" in path else (2, 1, 0))
        if w.ndim == 2:
            if path[-1] in _LINEAR or path[-2:-1] == ["in_feature_net"]:
                return name, w.T
            return "embedding", w
        return "scale", w
    if leaf == "_codebook.embed":
        return "codebook", w
    if leaf in ("m", "logs"):
        return leaf, w.reshape(-1)
    return leaf, w


def _ref_enc_tree(sd: dict[str, np.ndarray]) -> dict:
    """The inverse of `_ref_enc_state_dict`. The GRU's r and z blocks of
    `bias_hh` add to the input biases (both sit inside the same sigmoid),
    so a trained port GRU converts exactly."""
    tree = _jax_tree({k[len("ref_enc."):]: v for k, v in sd.items()
                  if k.startswith("ref_enc.convs.")})
    tree["proj"] = {"kernel": sd["ref_enc.proj.weight"].T,
                    "bias": sd["ref_enc.proj.bias"]}
    blocks = lambda a: dict(zip(_GRU_GATES, np.split(a, 3)))  # noqa: E731
    w_ih, w_hh = blocks(sd["ref_enc.gru.weight_ih_l0"]), blocks(sd["ref_enc.gru.weight_hh_l0"])
    b_ih, b_hh = blocks(sd["ref_enc.gru.bias_ih_l0"]), blocks(sd["ref_enc.gru.bias_hh_l0"])
    cell = {}
    for g in _GRU_GATES:
        bias = b_ih[g] + b_hh[g] if g != "n" else b_ih[g]
        cell["i" + g] = {"kernel": w_ih[g].T, "bias": bias}
        cell["h" + g] = {"kernel": w_hh[g].T}
    cell["hn"]["bias"] = b_hh["n"]
    tree["GRUCell_0"] = cell
    return tree


def _jax_tree(sd: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, w in sd.items():
        parts = key.split(".")
        if parts[-2:] == ["_codebook", "embed"]:
            parts = parts[:-2] + ["_codebook.embed"]
        path = _jax_module_path(parts[:-1])
        leaf, val = _to_jax_leaf(parts[:-1], parts[-1], w)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(val)
    return tree


def to_jax_params(state_dict: dict) -> dict:
    """The port's Synthesizer state_dict -> the JAX package's `Synthesizer`
    parameter tree (nested dicts of float32 numpy arrays, without the
    top-level "params" key), leaf for leaf what `from_jax_params` reads:
    every version family of `compat/versions.py`, the vits1 flow, and the
    reference encoder of a model without speakers."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    tree = _jax_tree({k: v for k, v in sd.items() if not k.startswith("ref_enc.")})
    if any(k.startswith("ref_enc.") for k in sd):
        tree["ref_enc"] = _ref_enc_tree(sd)
    return tree


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


def from_jax_wavlm_disc_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX `WavLMDiscriminator` params -> the port's state_dict (`pre`,
    `convs.{0,1,2}`, `conv_post`, each weight-normed)."""
    return _state_dict(tree)


def from_jax_wavlm_params(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX `WavLMJax` params (`import_torch_wavlm`'s layout) -> the port's
    `WavLM` state_dict (HF `WavLMModel` names). `cfg`: its WavLMConfig."""
    p = _unwrap(tree)
    sd: dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_dim)):
        conv = p[f"conv_{i}"]
        pre = f"feature_extractor.conv_layers.{i}."
        sd[pre + "conv.weight"] = _tensor(np.transpose(conv["kernel"], (2, 1, 0)))
        if "bias" in conv:
            sd[pre + "conv.bias"] = _tensor(conv["bias"])
        if f"conv_norm_{i}" in p:  # group norm: conv 0 only; layer norm: each
            sd[pre + "layer_norm.weight"] = _tensor(p[f"conv_norm_{i}"]["scale"])
            sd[pre + "layer_norm.bias"] = _tensor(p[f"conv_norm_{i}"]["bias"])

    def norm(name, tree):
        sd[f"{name}.weight"] = _tensor(tree["scale"])
        sd[f"{name}.bias"] = _tensor(tree["bias"])

    norm("feature_projection.layer_norm", p["proj_norm"])
    _dense(sd, "feature_projection.projection", p["projection"])
    w = np.transpose(np.asarray(p["pos_conv"]["kernel"], np.float32), (2, 1, 0))
    pre = "encoder.pos_conv_embed.conv."
    sd[pre + "weight_v"] = _tensor(w)
    sd[pre + "weight_g"] = _tensor(np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True)))
    sd[pre + "bias"] = _tensor(p["pos_conv"]["bias"])
    norm("encoder.layer_norm", p["encoder_norm"])

    def layer(i, tree):
        L = f"encoder.layers.{i}."
        att = tree["attention"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"):
            _dense(sd, L + "attention." + name, att[name])
        sd[L + "attention.gru_rel_pos_const"] = _tensor(att["gru_rel_pos_const"])
        if "rel_attn_embed" in att:
            sd[L + "attention.rel_attn_embed.weight"] = _tensor(
                att["rel_attn_embed"]["embedding"])
        norm(L + "layer_norm", tree["norm"])
        _dense(sd, L + "feed_forward.intermediate_dense", tree["intermediate"])
        _dense(sd, L + "feed_forward.output_dense", tree["output"])
        norm(L + "final_layer_norm", tree["final_norm"])

    layer(0, {k[len("layer_0_"):]: v for k, v in p.items() if k.startswith("layer_0_")})
    for i in range(1, cfg.num_layers):  # the scanned layers, stacked on axis 0
        layer(i, _index(p["layers"], i - 1))
    return sd


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
