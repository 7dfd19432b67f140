"""Top-level VITS2 synthesizer (reference: SynthesizerTrn, models.py:811-1074).

Counterpart of `bert_vits2_tpu/models/synthesizer.py`: `forward` is the
training forward, `predict_durations` and `infer` the inference half. The
submodules carry the reference's state_dict names (enc_p, enc_q, dec, flow,
sdp, dp, and emb_g, or ref_enc when n_speakers == 0: the speaker embedding
then comes from a reference spectrogram, the training spectrogram in
`forward` and the caller's `y` in `infer`). Every version family of
`compat/versions.py` is a configuration of this one module: `flow` is the
transformer flow, or the vits1 WN flow with `use_transformer_flow` false,
and the V2.1/V2.2 families feed `enc_p` an emotion input (`emo`).

The training forward runs monotonic alignment search on the device (kernel
K3, `ops/align.py`) with no gradient, then the duration losses, the prior
expansion and a random decoder slice. It draws noise five times, in this
order, through `ops/noise.py`: the posterior sample, the MAS noise, the SDP
`e_q`, the SDP reverse `z` and the slice starts. Under a data-parallel step
(`parallel/data.py`) the draws are the global batch's rows, the MAS noise
is scaled by the global batch's std and the duration losses divide by the
global mask sum, as in the JAX package's one program over the global
batch.

Synthesis is statically shaped like the JAX version: the caller fixes
`max_frames`, predicted durations are masked into it, and `y_lengths` says
where each item's audio ends. It follows the JAX package's
`infer_compute_dtype` policy (synthesizer.py:341-349): enc_p and both
duration predictors run in float32, so the lengths do not depend on the
dtype; the prior sample is drawn in float32 and cast; the flow and the
decoder run in the compute dtype (`compute_stages`: under bfloat16, copies
with weight norm resolved in float32, then rounded, LayerNorm parameters
kept float32); the wave comes back float32. The module's own parameters
stay float32 under the reference's names either way.

The public layout of the inputs is the JAX
package's (BERT features [b, t, dim], spectrograms [b, t, bins], attn
[b, t_y, t_x], waves [b, samples]); inside, and in the training forward's
outputs, tensors are in the reference layout [b, c, t]. The four inference
knobs take scalars or [b] tensors. Noise comes from an explicit
`torch.Generator`; tests pass the SDP noise `z_in` and the prior noise `eps`
of `infer` explicitly instead.
"""

from __future__ import annotations

import copy
import math
import warnings

import torch
from torch import nn

from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
)
from bert_vits2_tpu_torch.models.flow import (
    ResidualCouplingBlock,
    TransformerCouplingBlock,
)
from bert_vits2_tpu_torch.models.generator import Generator
from bert_vits2_tpu_torch.models.posterior import PosteriorEncoder
from bert_vits2_tpu_torch.models.reference_encoder import ReferenceEncoder
from bert_vits2_tpu_torch.models.text_encoder import TextEncoder
from bert_vits2_tpu_torch.nn.norm import LayerNorm
from bert_vits2_tpu_torch.ops import noise
from bert_vits2_tpu_torch.parallel.data import global_count, global_std
from bert_vits2_tpu_torch.ops.align import maximum_path
from bert_vits2_tpu_torch.ops.masking import (
    generate_path,
    rand_slice_segments,
    sequence_mask,
)


def _knob(v, rank: int, ref: torch.Tensor) -> torch.Tensor:
    """() or [b] -> a float32 tensor broadcastable against a rank-`rank` one."""
    v = torch.as_tensor(v, dtype=torch.float32, device=ref.device)
    return v.reshape(v.shape + (1,) * (rank - v.dim()))


def compute_dtype(name: str) -> torch.dtype:
    """A config's compute dtype name ("float32" | "bfloat16") -> torch's."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def sdp_noise(x_h: torch.Tensor, noise_scale_w, generator=None) -> torch.Tensor:
    """The SDP's reverse noise [b, 2, t_x]: a standard normal draw from
    `generator` times noise_scale_w (() or [b])."""
    b, _, t = x_h.shape
    return noise.randn((b, 2, t), generator, x_h.device, x_h.dtype,
                       batch_axis=0) * _knob(noise_scale_w, 3, x_h)


def durations(logw_sdp, logw_dp, x_mask, sdp_ratio, length_scale) -> torch.Tensor:
    """The two predictors' log-durations [b, 1, t_x] mixed by sdp_ratio ->
    frames per token w [b, t_x] (unrounded), masked and length-scaled."""
    ratio = _knob(sdp_ratio, 3, logw_dp)
    logw = logw_sdp * ratio + logw_dp * (1.0 - ratio)
    return torch.exp(logw[:, 0]) * x_mask[:, 0] * _knob(length_scale, 2, logw_dp)


def expand_prior(w, m_p, logs_p, x_mask, max_frames: int, noise_scale,
                 generator=None, eps=None):
    """Durations w [b, t_x] -> the prior sample at the frame rate:
    (z_p [b, c, max_frames] float32, attn [b, t_y, t_x], y_mask [b, t_y],
    y_lengths [b] int32). eps [b, max_frames, c]: the noise before
    noise_scale (else drawn from `generator`)."""
    w_ceil = torch.ceil(w)
    y_lengths = torch.sum(w_ceil, dim=-1).clamp(min=1.0)
    y_lengths = torch.clamp(y_lengths, max=max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames)
    attn = generate_path(w_ceil, x_mask[:, 0], y_mask)  # [b, t_y, t_x]
    m_p_y = torch.einsum("byx,bcx->bcy", attn, m_p)
    logs_p_y = torch.einsum("byx,bcx->bcy", attn, logs_p)
    if eps is not None:
        eps = eps.transpose(1, 2).to(m_p_y.dtype)
    else:
        eps = noise.randn(m_p_y.shape, generator, m_p_y.device, m_p_y.dtype,
                          batch_axis=0)
    z_p = m_p_y + eps * torch.exp(logs_p_y) * _knob(noise_scale, 3, m_p_y)
    return z_p, attn, y_mask, y_lengths


@torch.no_grad()
def cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An inference copy of `module` in `dtype`, as the JAX package's convs
    compute under a compute dtype (nn/conv.py: weight norm resolved in
    float32, the resolved weight and the bias cast to the dtype): weight
    norm is removed on the copy in float32, then every parameter is cast
    but those of the LayerNorms, which normalize in float32."""
    # the weight-normed convs hold their last computed weight, a non-leaf
    # tensor that deepcopy refuses: the copy leaves it out, and removing
    # weight norm computes it anew from weight_g and weight_v
    memo = {id(sub.weight): None for sub in module.modules()
            if hasattr(sub, "weight_g")}
    out = copy.deepcopy(module, memo).eval()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for sub in out.modules():
            if hasattr(sub, "weight_g"):
                nn.utils.remove_weight_norm(sub)
    for sub in out.modules():
        if not isinstance(sub, LayerNorm):
            for p in sub.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return out.requires_grad_(False)


class Synthesizer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.use_transformer_flow and cfg.n_flow_layer != 4:
            # the JAX package builds n_flow_layer couplings of 4 WN layers,
            # the reference (as recalled) 4 couplings of n_flow_layer WN
            # layers; the two agree only at 4 (ROADMAP §C R.4)
            raise ValueError(
                "the vits1 flow (use_transformer_flow false) takes only "
                f"n_flow_layer 4, not {cfg.n_flow_layer}: its reading of "
                "n_flow_layer is unconfirmed (ROADMAP §C R.4)")
        self.cfg = cfg
        c = cfg
        gin = (c.gin_channels
               if c.use_spk_conditioned_encoder and c.gin_channels > 0 else 0)
        self.enc_p = TextEncoder(
            c.n_vocab, c.inter_channels, c.hidden_channels, c.filter_channels,
            c.n_heads, c.n_layers, c.kernel_size, c.p_dropout,
            num_tones=c.num_tones,
            num_languages=c.num_languages, bert_dim=c.bert_dim,
            gin_channels=gin, use_ja_bert=c.use_ja_bert,
            use_en_bert=c.use_en_bert, ja_bert_dim=c.ja_bert_dim,
            emotion=c.emotion)
        self.dec = Generator(
            c.inter_channels, c.resblock, c.resblock_kernel_sizes,
            c.resblock_dilation_sizes, c.upsample_rates,
            c.upsample_initial_channel, c.upsample_kernel_sizes,
            gin_channels=c.gin_channels)
        if c.use_transformer_flow:
            self.flow = TransformerCouplingBlock(
                c.inter_channels, c.hidden_channels, c.filter_channels, c.n_heads,
                c.n_layers_trans_flow, 5, c.p_dropout, n_flows=c.n_flow_layer,
                gin_channels=c.gin_channels)
        else:
            self.flow = ResidualCouplingBlock(
                c.inter_channels, c.hidden_channels,
                gin_channels=c.gin_channels)
        self.sdp = StochasticDurationPredictor(
            c.hidden_channels, 3, 0.5, 4, gin_channels=c.gin_channels)
        self.dp = DurationPredictor(c.hidden_channels, 256, 3, 0.5,
                                    gin_channels=c.gin_channels)
        if c.n_speakers >= 1:
            self.emb_g = nn.Embedding(c.n_speakers, c.gin_channels)
        else:
            self.ref_enc = ReferenceEncoder(c.spec_channels, c.gin_channels)
        # built last, so that the seeded init of the modules above (all that
        # inference uses) does not depend on the training-only encoder
        self.enc_q = PosteriorEncoder(
            c.spec_channels, c.inter_channels, c.hidden_channels,
            kernel_size=5, dilation_rate=1, n_layers=16,
            gin_channels=c.gin_channels)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The flow's and the decoder's dtype in synthesis."""
        return compute_dtype(self.cfg.infer_compute_dtype)

    def compute_stages(self) -> tuple[nn.Module, nn.Module]:
        """(flow, dec) as `infer` runs them: the modules themselves under
        float32; under bfloat16 their `cast_copy`s, which share no
        parameter with the module (make them once, as the engine does, and
        pass them to `infer`)."""
        if self.compute_dtype == torch.float32:
            return self.flow, self.dec
        return (cast_copy(self.flow, self.compute_dtype),
                cast_copy(self.dec, self.compute_dtype))

    def _speaker(self, sid, y):
        """The speaker embedding [b, gin]: emb_g(sid), or with
        n_speakers == 0 the reference encoder of y [b, t, spec_channels]."""
        if self.cfg.n_speakers >= 1:
            return self.emb_g(sid)
        if y is None:
            raise ValueError("n_speakers == 0: the speaker embedding comes from "
                             "a reference spectrogram; pass y [b, t, spec_channels]")
        return self.ref_enc(y)

    def forward(self, x, x_lengths, y, y_lengths, sid, tone, language, bert,
                ja_bert, en_bert, emo=None, mas_noise_scale=0.01, generator=None):
        """Training forward (models.py:937-1024).

        x, tone, language: [b, t_x] int; x_lengths, y_lengths, sid: [b];
        y: linear spectrogram [b, t_y, spec]; bert, ja_bert, en_bert:
        [b, t_x, dim]; emo: the emotion input of a V2.1/V2.2 model
        (`TextEncoder.emotion_embedding`). Returns the JAX package's
        dictionary of outputs, in the layout [b, c, t] (attn [b, t_y, t_x],
        masks [b, 1, t], l_length [b], wave_slice [b, segment_samples],
        ids_slice [b]).

        Under `train_compute_dtype` "bfloat16" (JAX synthesizer.py:143-230)
        the posterior encoder gets y and g in bf16, the flow and the
        decoder slice run in bf16 on the float32 parameters (`nn/conv.py`),
        and z stays bf16; z_p, y_mask, m_q, logs_q and wave_slice come
        back float32, and enc_p, MAS, both duration predictors and every
        loss input stay float32. The decoder gets g in bf16 too: the JAX
        package passes it the float32 g, which promotes its activations to
        float32 after `cond` (ROADMAP §C R.6); the port runs the whole
        vocoder slice in bf16, as the reference's autocast and the JAX
        package's stated policy do."""
        cdt = compute_dtype(self.cfg.train_compute_dtype)
        g = self._speaker(sid, y)
        x_h, m_p, logs_p, x_mask = self.enc_p(
            x, x_lengths, tone, language, bert.transpose(1, 2),
            ja_bert.transpose(1, 2), en_bert.transpose(1, 2), emo=emo, g=g)
        g_c = g.to(cdt)
        z, m_q, logs_q, y_mask = self.enc_q(y.transpose(1, 2).to(cdt), y_lengths,
                                            g=g_c, generator=generator)
        z_p = self.flow(z, y_mask, g=g_c).float()
        y_mask, m_q, logs_q = y_mask.float(), m_q.float(), logs_q.float()

        # monotonic alignment search, no gradients (models.py:960-989)
        with torch.no_grad():
            s_p_sq_r = torch.exp(-2.0 * logs_p)  # [b, d, t_x]
            nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=1)
            nc2 = torch.einsum("bdy,bdx->byx", -0.5 * z_p ** 2, s_p_sq_r)
            nc3 = torch.einsum("bdy,bdx->byx", z_p, m_p * s_p_sq_r)
            nc4 = torch.sum(-0.5 * m_p ** 2 * s_p_sq_r, dim=1)
            neg_cent = nc1[:, None, :] + nc2 + nc3 + nc4[:, None, :]
            if self.cfg.use_noise_scaled_mas:
                eps = noise.randn(neg_cent.shape, generator, neg_cent.device,
                                  batch_axis=0)
                neg_cent = neg_cent + (global_std(neg_cent) * eps * mas_noise_scale)
            attn = maximum_path(neg_cent.contiguous(), y_lengths, x_lengths)
        w = attn.sum(dim=1)[:, None, :]  # [b, 1, t_x]

        # duration losses (models.py:993-1004)
        denom = global_count(torch.sum(x_mask))
        l_length_sdp = self.sdp.nll(x_h, x_mask, w, g=g,
                                    generator=generator) / denom
        logw_ = torch.log(w + 1e-6) * x_mask
        logw = self.dp(x_h, x_mask, g=g)
        z_dur = noise.randn((x_h.shape[0], 2, x_h.shape[2]), generator,
                            x_h.device, x_h.dtype, batch_axis=0)
        logw_sdp = self.sdp.reverse(x_h, x_mask, z_dur, g=g)
        l_length_dp = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / denom
        l_length_sdp = l_length_sdp + torch.sum(
            (logw_sdp - logw_) ** 2, dim=(1, 2)) / denom

        # expand the prior along the alignment (models.py:1007-1008)
        m_p_y = torch.einsum("byx,bcx->bcy", attn, m_p)
        logs_p_y = torch.einsum("byx,bcx->bcy", attn, logs_p)

        z_slice, ids_slice = rand_slice_segments(
            z, y_lengths, self.cfg.segment_size, generator)
        return {
            "wave_slice": self.dec(z_slice, g=g_c).float(),
            "l_length": l_length_dp + l_length_sdp,
            "attn": attn,
            "ids_slice": ids_slice,
            "x_mask": x_mask,
            "y_mask": y_mask,
            "z": z,
            "z_p": z_p,
            "m_p": m_p_y,
            "logs_p": logs_p_y,
            "m_q": m_q,
            "logs_q": logs_q,
            "x_hidden": x_h,
            "logw": logw,
            "logw_": logw_,
            "logw_sdp": logw_sdp,
            "g": g,
        }

    def _durations(self, x, x_lengths, sid, tone, language, bert, ja_bert,
                   en_bert, length_scale, noise_scale_w, sdp_ratio, generator,
                   z_in, y=None, emo=None):
        """Shared prefix of predict_durations and infer -> (w [b, t_x],
        m_p, logs_p [b, c, t_x], x_mask [b, 1, t_x], g [b, gin])."""
        g = self._speaker(sid, y)
        x_h, m_p, logs_p, x_mask = self.enc_p(
            x, x_lengths, tone, language, bert.transpose(1, 2),
            ja_bert.transpose(1, 2), en_bert.transpose(1, 2), emo=emo, g=g)
        if z_in is not None:
            z = z_in.transpose(1, 2).to(x_h.dtype)
        else:
            z = sdp_noise(x_h, noise_scale_w, generator)
        logw_sdp = self.sdp.reverse(x_h, x_mask, z, g=g)
        logw_dp = self.dp(x_h, x_mask, g=g)
        w = durations(logw_sdp, logw_dp, x_mask, sdp_ratio, length_scale)
        return w, m_p, logs_p, x_mask, g

    def predict_durations(self, x, x_lengths, sid, tone, language, bert,
                          ja_bert, en_bert, emo=None, length_scale=1.0,
                          noise_scale_w=0.8, sdp_ratio=0.0, generator=None,
                          z_in=None, y=None):
        """Predicted frame counts [b] without synthesis: the literal prefix of
        `infer`, so the same generator state gives infer's y_lengths."""
        w, *_ = self._durations(x, x_lengths, sid, tone, language, bert,
                                ja_bert, en_bert, length_scale, noise_scale_w,
                                sdp_ratio, generator, z_in, y, emo)
        return torch.sum(torch.ceil(w), dim=-1).clamp(min=1.0).to(torch.int32)

    def infer(self, x, x_lengths, sid, tone, language, bert, ja_bert, en_bert,
              max_frames: int, emo=None, noise_scale=0.667, length_scale=1.0,
              noise_scale_w=0.8, sdp_ratio=0.0, generator=None, z_in=None,
              eps=None, mrf_packed=None, y=None, stages=None):
        """Statically shaped synthesis (models.py:1026-1074).

        x, tone, language: [b, t_x] int; x_lengths, sid: [b]; bert, ja_bert,
        en_bert: [b, t_x, dim]; emo: the emotion input of a V2.1/V2.2 model
        ([b] codebook indices or [b, 1024] for vq210, [b, 512] for clap220).
        z_in [b, t_x, 2]: SDP noise, already scaled
        (noise_scale_w is then ignored); eps [b, max_frames, inter]: prior
        noise before noise_scale. mrf_packed: `dec.pack_mrf(dtype)` in the
        compute dtype, resolved once. stages: `compute_stages()`, made once
        (made here on each call when None).
        y [b, t, spec_channels]: the reference spectrogram of a model with
        n_speakers == 0 (sid is then unused).
        Returns (wave [b, max_frames * hop], attn [b, t_y, t_x],
        y_mask [b, t_y], y_lengths [b] int32)."""
        w, m_p, logs_p, x_mask, g = self._durations(
            x, x_lengths, sid, tone, language, bert, ja_bert, en_bert,
            length_scale, noise_scale_w, sdp_ratio, generator, z_in, y, emo)
        z_p, attn, y_mask, y_lengths = expand_prior(
            w, m_p, logs_p, x_mask, max_frames, noise_scale, generator, eps)
        flow, dec = stages if stages is not None else self.compute_stages()
        dt = self.compute_dtype
        z_p, y_mask_c, g_c = z_p.to(dt), y_mask.to(dt), g.to(dt)
        z = flow(z_p, y_mask_c[:, None, :], g=g_c, reverse=True)
        wave = dec(z * y_mask_c[:, None, :], g=g_c, y_mask=y_mask_c,
                   mrf_packed=mrf_packed)
        return wave.float(), attn, y_mask, y_lengths


def build_synthesizer(cfg: ModelConfig, device: str | torch.device = "cuda",
                      seed: int = 0,
                      state_dict: dict | None = None) -> Synthesizer:
    """A Synthesizer on `device` in eval mode: weights from `state_dict`
    (reference names), or the reference's random init drawn from `seed`."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Synthesizer(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()
