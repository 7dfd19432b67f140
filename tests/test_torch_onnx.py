"""PyTorch port, ONNX export without the `onnx` package: the exporter
`compat/torch2onnx.py`, the stage export and its CLI `compat/onnx_export.py`,
the pipeline `compat/onnx_infer.py` and the copies of the JAX package's
codec, evaluator and checker (`compat/onnx_pb.py`, `onnx_eval.py`,
`onnx_check.py`), on the CPU.

One tiny V2.3 model (tests/conftest.py's `tiny_model` widths, BERT 1024,
3 encoder layers),
every parameter random (the zero-initialized flow `post` and SDP `proj`
convs included), written as a config.json and a G_0.pth and exported by
the CLI `python -m bert_vits2_tpu_torch.compat.onnx_export ... --verify`
once for the module. No JAX compile: the JAX package's checker, evaluator,
pipeline and signatures are numpy and Python.

Bounds: each graph on the evaluator against the torch stage, max-abs-err
<= 1e-4 (the JAX package's own verify_onnx bound); the artifact folder run
by the JAX package's OnnxTTSPipeline against the port's with the same
noise: equal lengths, waves within 2e-4 (tests/test_onnx.py's bound); the
op-level cases against torch eager within 1e-5.
"""

import ast
import contextlib
import dataclasses
import inspect
import io
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bert_vits2_tpu.compat import onnx_check as jax_check
from bert_vits2_tpu.compat import onnx_eval as jax_eval
from bert_vits2_tpu.compat import onnx_infer as jax_infer
from bert_vits2_tpu.compat import onnx_pb as jax_pb
from bert_vits2_tpu.compat.onnx_export import stage_signatures as jax_signatures
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.utils import flops as jax_flops
from bert_vits2_tpu_torch.compat import onnx_check, onnx_eval, onnx_infer, onnx_pb
from bert_vits2_tpu_torch.compat.hparams import get_hparams_from_file, model_config_from_hparams
from bert_vits2_tpu_torch.compat.onnx_check import check_model
from bert_vits2_tpu_torch.compat.onnx_eval import OnnxEvaluator
from bert_vits2_tpu_torch.compat.onnx_export import (
    STAGES,
    export_onnx,
    main,
    make_onnx_stage_fns,
    stage_signatures,
    verify_onnx,
)
from bert_vits2_tpu_torch.compat.onnx_infer import OnnxTTSPipeline
from bert_vits2_tpu_torch.compat.torch2onnx import UnsupportedOp, count_ops, export_model
from bert_vits2_tpu_torch.compat.versions import spec_for
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.ops import attention
from bert_vits2_tpu_torch.ops.library import plain_functions
from bert_vits2_tpu_torch.utils import flops
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

T_X, MAX_FRAMES = 8, 16
MODEL = dict(  # tests/conftest.py tiny_model's widths; 3 encoder layers, so
    # that the speaker conditioning before layer 2 runs
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=3,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], upsample_rates=[4, 4],
    upsample_initial_channel=16, upsample_kernel_sizes=[8, 8], gin_channels=8,
    n_layers_trans_flow=2)
DATA = dict(sampling_rate=44100, filter_length=64, hop_length=16, n_speakers=4,
            spk2id={"a": 0, "b": 1, "c": 2, "d": 3})


def randomize(model, seed):
    """Every parameter random: fan-in-scaled weights, gains near 1, the
    rest small and nonzero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = torch.randn(p.shape, generator=g)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight_g", "gamma"):
                p.copy_(1.0 + 0.1 * n)
            elif leaf in ("weight", "weight_v") and p.dim() > 1:
                p.copy_(n / math.sqrt(p[0].numel()) if "emb" not in name else 0.5 * n)
            else:
                p.copy_(0.1 * n)
    return model


def write_config(path, version="2.3", **model):
    path.write_text(json.dumps(dict(version=version, train=dict(segment_size=128),
                                    data=DATA, model=dict(MODEL, **model))))
    return str(path)


def model_from(config, seed):
    hps = get_hparams_from_file(config)
    cfg = model_config_from_hparams(hps, **spec_for(hps.version).model_overrides())
    return randomize(build_synthesizer(cfg, device="cpu"), seed)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The CLI on a config.json and a G_0.pth: the six graphs, verified."""
    root = tmp_path_factory.mktemp("onnx")
    config = write_config(root / "config.json")
    model = model_from(config, seed=4)
    torch.save({"model": model.state_dict(), "iteration": 0}, root / "G_0.pth")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["-c", config, "-m", str(root / "G_0.pth"), "-o", str(root), "--name", "Tiny",
              "--t-x", str(T_X), "--max-frames", str(MAX_FRAMES), "--verify"])
    text = out.getvalue()
    paths = json.loads(text[:text.index("}") + 1])
    errs = json.loads(text[text.index("}") + 1:])["max_abs_err"]
    graphs = {k: open(p, "rb").read() for k, p in paths.items()}
    return model, make_onnx_stage_fns(model), str(root / "Tiny"), paths, graphs, errs


@pytest.mark.parametrize("stage", STAGES)
def test_stage_graph_matches_torch(exported, stage):
    """Each graph the CLI wrote, on the port's numpy evaluator, against the
    torch stage (the CLI's --verify, the JAX package's random inputs):
    <= 1e-4; and it passes the port's checker and the JAX package's."""
    model, fns, _, paths, graphs, errs = exported
    assert set(paths) == set(STAGES) and os.path.basename(paths[stage]) == f"Tiny_{stage}.onnx"
    assert errs[stage] <= 1e-4, errs
    assert verify_onnx(model, {stage: paths[stage]}, T_X, MAX_FRAMES, seed=1,
                       fns=fns)[stage] <= 1e-4
    assert check_model(graphs[stage]) == []
    assert jax_check.check_model(graphs[stage]) == []
    assert {n.domain for n in jax_check.decode_model(graphs[stage]).graph.nodes} == {""}


def _io(mb):
    g = onnx_pb.parse_model(mb)["graph"]
    return [(v["name"], v["elem_type"], v["dims"]) for v in g["inputs"]], \
        [(v["name"], v["elem_type"], v["dims"]) for v in g["outputs"]]


def _jax_io(cfg, stage, emotion="none"):
    jcfg = JaxModelConfig(**dict(dataclasses.asdict(cfg), emotion=emotion))
    specs, in_names, out_names = jax_signatures(jcfg, T_X, MAX_FRAMES)[stage]
    return [(n, jax_pb.np_to_onnx_dtype(np.dtype(s.dtype)), list(s.shape))
            for n, s in zip(in_names, specs)], out_names


def test_io_contract_matches_jax(exported):
    """Names, element types and dims of every graph's inputs equal the JAX
    package's stage_signatures for the same config (the reference's MoeVS
    contract: int64 ids, channel-first tensors, g [b, gin, 1]); the outputs'
    names too, and their dims are the torch stages' (xout [1, h, t_x], o
    [1, 1, max_frames * hop])."""
    model, _, folder, _, graphs, _ = exported
    cfg = model.cfg
    for stage in STAGES:
        ins, outs = _io(graphs[stage])
        want_ins, want_outs = _jax_io(cfg, stage)
        assert ins == want_ins, stage
        assert [o[0] for o in outs] == want_outs, stage
    assert _io(graphs["enc_p"])[1][0][2] == [1, cfg.hidden_channels, T_X]
    assert _io(graphs["dec"])[1][0][2] == [1, 1, MAX_FRAMES * cfg.hop_length]
    with open(os.path.join(folder, "config.json")) as f:
        project = json.load(f)
    assert project["Stages"] == {s: f"Tiny_{s}.onnx" for s in STAGES}
    assert project["Shapes"] == {"t_x": T_X, "max_frames": MAX_FRAMES, "batch": 1}
    assert project["Hop"] == cfg.hop_length


@pytest.mark.parametrize("version,emotion,extra", [
    ("2.1", "vq210", ["vqidx", "sid"]),
    ("2.2", "clap220", ["emo"]),
])
def test_emotion_enc_p(tmp_path, version, emotion, extra):
    """The V2.1 / V2.2 enc_p graphs carry the reference's extra emotion
    inputs (onnx_modules/V210/models_onnx.py:947-958), as the JAX package's
    signatures name them, and verify within 1e-4."""
    model = model_from(write_config(tmp_path / "config.json", version), seed=6)
    assert model.cfg.emotion == emotion
    paths = export_onnx(model, str(tmp_path), "Emo", T_X, MAX_FRAMES, stages=("enc_p",))
    mb = open(paths["enc_p"], "rb").read()
    ins, _ = _io(mb)
    assert [i[0] for i in ins][-len(extra):] == extra
    assert ins == _jax_io(model.cfg, "enc_p", emotion)[0]
    assert stage_signatures(model.cfg, T_X, MAX_FRAMES)["enc_p"][1][8:] == extra
    assert verify_onnx(model, paths, T_X, MAX_FRAMES)["enc_p"] <= 1e-4
    assert check_model(mb) == [] and jax_check.check_model(mb) == []


def _pipeline_inputs(cfg):
    rng = np.random.default_rng(3)
    n = 6
    return dict(
        seq=rng.integers(1, cfg.n_vocab, (1, n)), tone=rng.integers(0, cfg.num_tones, (1, n)),
        language=rng.integers(0, cfg.num_languages, (1, n)),
        bert_zh=rng.normal(size=(n, 1024)).astype(np.float32) * 0.3,
        bert_jp=rng.normal(size=(n, 1024)).astype(np.float32) * 0.3,
        bert_en=rng.normal(size=(n, 1024)).astype(np.float32) * 0.3, sid=np.array([1]),
        zin=rng.normal(size=(1, 2, T_X)).astype(np.float32) * 0.8,
        z_eps=rng.normal(size=(1, cfg.inter_channels, MAX_FRAMES)).astype(np.float32))


def test_pipeline_matches_jax_pipeline_and_torch_glue(exported):
    """The artifact folder run by the JAX package's OnnxTTSPipeline and by
    the port's, with the same zin / z_eps: equal lengths, waves within 2e-4;
    and the port's glue with the torch stages as its sessions."""
    model, fns, folder, _, _, _ = exported
    kw = _pipeline_inputs(model.cfg)
    wave, y_len = OnnxTTSPipeline(folder)(**kw)
    jax_wave, jax_len = jax_infer.OnnxTTSPipeline(folder, "Tiny")(**kw)
    np.testing.assert_array_equal(y_len, jax_len)
    assert np.abs(wave - jax_wave).max() <= 2e-4
    assert np.isfinite(wave).all() and y_len[0] >= 1

    class TorchSession:
        def __init__(self, fn, in_names):
            self.fn, self.in_names = fn, in_names

        def run(self, _outs, feeds):
            with plain_functions(), torch.no_grad():
                out = self.fn(*[torch.from_numpy(np.asarray(feeds[k]))
                                for k in self.in_names])
            return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]

    pipe = OnnxTTSPipeline(folder)
    sigs = stage_signatures(model.cfg, T_X, MAX_FRAMES)
    pipe.sessions = {s: TorchSession(fns[s], sigs[s][1]) for s in STAGES}
    torch_wave, torch_len = pipe(**kw)
    np.testing.assert_array_equal(y_len, torch_len)
    assert np.abs(wave - torch_wave).max() <= 2e-4


# ---- op-level cases: each traced, converted and evaluated against eager ----

_R = np.random.default_rng(9)


def _w(*shape, scale=1.0):
    return torch.from_numpy((scale * _R.normal(size=shape)).astype(np.float32))


_CONV_W, _CONV_B = _w(6, 2, 5, scale=0.3), _w(6, scale=0.1)
_CONVT_W, _CONVT_B = _w(4, 3, 8, scale=0.3), _w(3, scale=0.1)
_TABLE = _w(11, 4)
_LIN_W, _LIN_B = _w(16, 8, scale=0.3), _w(16, scale=0.1)
_CODES = _w(3, 5, 4)


def _conv(x):  # dilated, grouped, strided
    return F.leaky_relu(F.conv1d(x, _CONV_W, _CONV_B, stride=2, padding=3, dilation=2,
                                 groups=2), 0.1)


def _conv_transpose(x):
    return F.conv_transpose1d(x, _CONVT_W, _CONVT_B, stride=4, padding=2)


def _gather_pad_cumsum_where(ids, m):
    v = F.embedding(ids, _TABLE)  # [b, t, 4]
    v = torch.where(m[..., None] > 0, v, 0.0)
    v = torch.cumsum(v, dim=1)
    v = F.pad(v.transpose(1, 2), (1, -1))  # shift right by one along t
    return torch.flip(v, dims=(2,))


def _band(rel):  # the plain attention's band gathers
    return attention.abs_to_band(torch.softmax(attention.band_to_abs(rel, 2), -1), 2)


def _dense(x, m):
    h = F.gelu(F.linear(x, _LIN_W, _LIN_B))  # addmm
    h = F.layer_norm(h, (16,)) + F.softplus(h) * torch.sigmoid(h)
    a = torch.softmax(torch.einsum("btc,bsc->bts", h, h) / 4.0, dim=-1)  # bmm
    out = torch.einsum("bts,bsc->btc", a, h) * m[..., None]
    return out.sum(1), torch.clamp(out, -0.5, 0.5).sum(2, keepdim=True)


def _select_linear(x, g):  # the encoder's speaker conditioning: g [b, gin, 1]
    return x + F.linear(g[..., 0], _LIN_W.T[:8], _LIN_B[:8])[:, :, None]


def _argmin_index(x):  # the V2.2 quantizer's lookup: [b, heads, dim]
    d = ((x[:, :, None, :] - _CODES[None]) ** 2).sum(-1)  # [b, heads, codes]
    idx = torch.argmin(d, dim=-1)
    return _CODES[torch.arange(3), idx]


OP_CASES = {
    "conv_dilated_grouped_strided": (_conv, [_w(2, 4, 33)], "Conv"),
    "conv_transpose": (_conv_transpose, [_w(2, 4, 10)], "ConvTranspose"),
    "gather_pad_cumsum_where_flip": (
        _gather_pad_cumsum_where,
        [torch.tensor([[1, 2, 3, 9], [4, 5, 6, 10]]),
         torch.tensor([[1.0, 0, 1, 1], [1, 1, 0, 1]])], "CumSum"),
    "band_gather_softmax": (_band, [_w(2, 2, 9, 5)], "Gather"),
    "linear_layernorm_softmax_bmm_sum": (_dense, [_w(2, 5, 8), torch.ones(2, 5)], "MatMul"),
    "argmin_index": (_argmin_index, [_w(2, 3, 4)], "ArgMin"),
    "select_linear": (_select_linear, [_w(1, 8, 5), _w(1, 16, 1)], "MatMul"),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_case_matches_eager(case):
    fn, args, op = OP_CASES[case]
    with torch.no_grad():
        want = fn(*args)
    want = want if isinstance(want, tuple) else (want,)
    mb = export_model(fn, args, [f"in{i}" for i in range(len(args))],
                      [f"out{i}" for i in range(len(want))], "case")
    assert op in count_ops(mb), count_ops(mb)
    got = OnnxEvaluator(mb)(*[a.numpy() for a in args])
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape) and g.dtype == w.numpy().dtype
        assert np.abs(g - w.numpy()).max() <= 1e-5, case
    assert check_model(mb) == [] and jax_check.check_model(mb) == []


def test_negative_controls():
    """An ATen op without a mapping raises with its name; so do a random op
    and a custom op (the kernels' bv2 ops: no node outside the default
    domain); the stages traced outside plain_functions() hold the kernels'
    op, and the exporter's trace does not."""
    x = _w(2, 6)
    with pytest.raises(UnsupportedOp, match="aten.topk"):
        export_model(lambda a: torch.topk(a, 2).values, [x], ["x"], ["y"])
    with pytest.raises(UnsupportedOp, match="random"):
        export_model(lambda a: a + torch.randn_like(a), [x], ["x"], ["y"])
    q = _w(1, 2, 10, 4)
    args = [q, q, q, torch.ones(1, 10), _w(9, 4), _w(9, 4)]
    with pytest.raises(UnsupportedOp, match="bv2.banded_attn_fwd"):
        export_model(lambda *a: torch.ops.bv2.banded_attn_fwd(*a, 4), args,
                     [f"in{i}" for i in range(6)], ["y"])
    mb = export_model(lambda *a: attention.banded_rel_self_attention(*a, 4), args,
                      [f"in{i}" for i in range(6)], ["y"])
    assert {n.domain for n in jax_check.decode_model(mb).graph.nodes} == {""}
    with torch.no_grad():
        live = torch.export.export(
            _Wrap(lambda *a: attention.banded_rel_self_attention(*a, 4)), tuple(args))
    assert "bv2.banded_attn_fwd.default" in {str(n.target) for n in live.graph.nodes}


class _Wrap(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *a):
        return self.fn(*a)


# ---- the copies, pinned to their originals ----


def test_writer_bytes_equal_jax_writer():
    """The port's codec writes the JAX package's bytes for the same nodes,
    tensors, value infos, graph and model, and reads them back the same."""
    parts = []
    for pb in (onnx_pb, jax_pb):
        arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
        n = pb.node("Conv", ["x", "w", ""], ["y"], name="c", strides=[2], pads=[1, 1],
                    group=2, alpha=0.5, mode="constant", value=np.ones(2, np.int64))
        t = pb.tensor("w", arr) + pb.tensor("m", np.array([True, False]))
        vi = pb.value_info("x", pb.FLOAT, [1, "t", None])
        g = pb.graph([n], "g", [vi], [pb.value_info("y", pb.INT64, [3])],
                     initializers=[pb.tensor("w", arr)], doc_string="d")
        parts.append((n, t, vi, g, pb.model(g, producer_name="p", doc_string="d")))
    assert parts[0] == parts[1]
    assert repr(onnx_pb.parse_model(parts[0][4])) == repr(jax_pb.parse_model(parts[0][4]))


def test_evaluator_outputs_equal_jax_evaluator(exported):
    """On every stage graph the port's evaluator gives the JAX package's
    evaluator's arrays, bit for bit."""
    model, _, _, _, graphs, _ = exported
    from bert_vits2_tpu_torch.compat.onnx_export import random_stage_inputs
    inputs = random_stage_inputs(model.cfg, T_X, MAX_FRAMES, seed=2)
    for stage, mb in graphs.items():
        ours = OnnxEvaluator(mb)(*inputs[stage])
        theirs = jax_eval.OnnxEvaluator(mb)(*inputs[stage])
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b), stage


def test_checker_verdicts_equal_jax_checker(exported):
    """On the JAX package's negative controls (tests/test_onnx_conformance.py:
    truncation, flipped bytes) the port's checker gives the JAX checker's
    verdicts."""
    mb = exported[4]["dp"]

    def verdict(check, data):
        try:
            return check(data)
        except Exception as e:  # noqa: BLE001 - a raise is a verdict too
            return type(e).__name__

    cases = [mb, mb[:len(mb) // 2]]
    for off in range(4, min(len(mb), 64), 7):
        corrupt = bytearray(mb)
        corrupt[off] ^= 0xFF
        cases.append(bytes(corrupt))
    verdicts = [verdict(check_model, c) for c in cases]
    assert verdicts == [verdict(jax_check.check_model, c) for c in cases]
    assert verdicts[0] == [] and verdicts[1]


def _code(module):
    """A module's AST without its docstring, imports of the JAX package
    named as the port's."""
    tree = ast.parse(inspect.getsource(module).replace("bert_vits2_tpu.", "bert_vits2_tpu_torch."))
    tree.body = [s for s in tree.body if not (isinstance(s, ast.Expr)
                                             and isinstance(s.value, ast.Constant))]
    return ast.dump(tree)


@pytest.mark.parametrize("ours,theirs", [
    (onnx_pb, jax_pb), (onnx_eval, jax_eval), (onnx_check, jax_check),
    (onnx_infer, jax_infer), (flops, jax_flops)],
    ids=["onnx_pb", "onnx_eval", "onnx_check", "onnx_infer", "flops"])
def test_copies_keep_their_originals_code(ours, theirs):
    """The copies differ from the JAX package's modules in their docstrings
    and their imports' package only; the checker stays independent of the
    writer, the exporter and the evaluator."""
    assert _code(ours) == _code(theirs)
    if ours is onnx_check:
        for node in ast.walk(ast.parse(inspect.getsource(onnx_check))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                for forbidden in ("onnx_pb", "torch2onnx", "onnx_eval", "onnx_export"):
                    assert forbidden not in name, name
