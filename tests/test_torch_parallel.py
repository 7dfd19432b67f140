"""PyTorch port, the data axis in one process: `parallel.make_mesh` and
`shard_batch`, the global-batch randomness of a data shard (noise draws,
the hash dropout's affine salt and shared seeds), and the data-parallel
engine against the single engine.

A data shard (`parallel.data_shard`) is what every rank of a data-parallel
step and every replica of the engine runs in; here the two halves of a
batch run one after the other in this process, so no process group is
needed (tests/test_torch_distributed.py runs two ranks). Noise and masks
are exact (equal bits); outputs and gradients of the plain attention on
the two halves against the whole batch within 1e-6 (the same products over
fewer batch rows); the data-parallel engine within 2e-5 of the single one
at noise_scale 0.667, as tests/test_infer.py::TestDataParallelInference
holds the JAX engine.
"""

import numpy as np
import pytest
import torch

from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import PreparedRequest, TTSEngine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
from bert_vits2_tpu_torch.ops import noise
from bert_vits2_tpu_torch.ops.attention import (
    banded_attention_bwd_plain_bf16,
    banded_attention_plain,
    banded_attention_stats_plain,
    hash_dropout_probs,
    hash_keep,
    drop_threshold,
)
from bert_vits2_tpu_torch.parallel import (
    batch_sharding,
    data_shard,
    global_count,
    global_std,
    make_mesh,
    replicate,
    shard_batch,
)
from bert_vits2_tpu_torch.train.step import expand_bert
from test_torch_modules import TINY
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

B = 4  # global rows; two shards of two


def test_make_mesh_and_shard_batch():
    """The mesh's shape and devices, each data coordinate's rows of a batch
    (tensors and numpy arrays in a dict), and replicas in one process."""
    mesh = make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and not mesh.distributed
    assert mesh.data_devices == [torch.device("cpu")] * 2
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_data=3, n_model=2, devices=["cpu"] * 4)
    mesh = make_mesh(n_data=2, devices=["cpu", "cpu"])
    assert [r for r, _ in batch_sharding(mesh, 6)] == [slice(0, 3), slice(3, 6)]
    with pytest.raises(ValueError, match="split"):
        batch_sharding(mesh, 5)
    batch = {"a": torch.arange(12).reshape(6, 2), "b": np.arange(6, dtype=np.float32)}
    for i in range(2):
        got = shard_batch(mesh, batch, index=i)
        assert torch.equal(got["a"], batch["a"][3 * i:3 * i + 3])
        assert torch.equal(got["b"], torch.arange(3 * i, 3 * i + 3, dtype=torch.float32))
    module = torch.nn.Linear(2, 2)
    assert replicate(mesh, module) == [module, module]
    # a weight-normed module onto another device: a copy there
    dec = build_synthesizer(ModelConfig(**TINY), device="cpu").dec
    replicas = replicate(make_mesh(devices=["cpu", "meta"]), dec)
    assert replicas[0] is dec and replicas[1].ups[0].weight_v.device.type == "meta"


def _halves(fn):
    """fn() run as each half of a B-row batch -> the two results."""
    out = []
    for offset in (0, B // 2):
        with data_shard(offset, B):
            out.append(fn())
    return out


@pytest.mark.parametrize("local_world,cards,want", [
    (2, 2, "nccl"), (2, 1, "gloo"), (1, 0, "gloo")])
def test_init_distributed_backend(monkeypatch, local_world, cards, want):
    """The default backend: NCCL where each of the host's ranks
    (LOCAL_WORLD_SIZE) has a card, gloo where ranks share one or there is
    none; one process joins no group."""
    import torch.distributed as dist

    from bert_vits2_tpu_torch.parallel import init_distributed

    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["rank"])))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is False and joined == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert init_distributed() is True and joined == [(want, 1)]


@pytest.mark.parametrize("draw", ["randn", "rand"])
def test_noise_of_a_data_shard_is_the_global_batchs(draw):
    """A draw inside each half's shard, with the same generator seed, gives
    that half's rows of the whole batch's draw, on either batch axis; at
    full size (and outside a shard) it is the plain draw."""
    fn = getattr(noise, draw)
    for shape, axis in (((B, 3, 5), 0), ((3, B, 4), 1)):
        full = fn(shape, torch.Generator().manual_seed(7), "cpu", batch_axis=axis)
        local = list(shape)
        local[axis] = B // 2
        halves = _halves(lambda: fn(local, torch.Generator().manual_seed(7), "cpu",
                                    batch_axis=axis))
        assert torch.equal(torch.cat(halves, dim=axis), full)
        with data_shard(0, B):
            assert torch.equal(fn(shape, torch.Generator().manual_seed(7), "cpu",
                                  batch_axis=axis), full)
    with pytest.raises(ValueError, match="global batch"):
        with data_shard(3, B):
            fn((2, 3), None, "cpu", batch_axis=0)


def test_expand_bert_and_statistics_of_a_data_shard():
    """`expand_bert` (its batch axis is axis 1 of the draw) on each half
    equals the whole batch's rows; without a process group the counts and
    the std are the local ones (the one-process code)."""
    rng = np.random.default_rng(0)
    batch = {"bert": torch.from_numpy(rng.normal(size=(B, 6, 4)).astype(np.float32)),
             "utt_lang": torch.tensor([0, 1, 2, 1])}
    full = expand_bert(batch, torch.Generator().manual_seed(3))
    halves = []
    for i, offset in enumerate((0, B // 2)):
        part = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        with data_shard(offset, B):
            halves.append(expand_bert(part, torch.Generator().manual_seed(3)))
    for key in ("bert", "ja_bert", "en_bert"):
        assert torch.equal(torch.cat([h[key] for h in halves]), full[key])
    x = torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32))
    with data_shard(2, B):
        assert global_count(x.sum()) is not None
        assert torch.equal(global_count(x.sum()), x.sum())
        assert torch.equal(global_std(x), torch.std(x, correction=0))


def _attention_inputs(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, h, t, d, w = B, 2, 12, 8, 3
    q, k, v, go = (torch.randn(b, h, t, d, generator=g).to(dtype) for _ in range(4))
    ek, ev = (0.3 * torch.randn(2 * w + 1, d, generator=g).to(dtype) for _ in range(2))
    mask = (torch.arange(t)[None, :] < torch.tensor([12, 9, 12, 7])[:, None]).float()
    return q, k, v, mask, ek, ev, go, w


def test_affine_salt_default_is_todays_mask():
    """The default salt (0, heads) and an explicit (0, heads) give the masks
    of the salt b * heads + head, computed here from `hash_keep` alone."""
    p = torch.ones(B, 2, 12, 12)
    want_keep = hash_keep(torch.arange(12)[:, None], torch.arange(12)[None, :],
                          (torch.arange(B)[:, None] * 2 + torch.arange(2))[:, :, None, None],
                          11, drop_threshold(0.3))
    want = want_keep / 0.7
    assert torch.equal(hash_dropout_probs(p, 0.3, 11), want)
    assert torch.equal(hash_dropout_probs(p, 0.3, 11, (0, 2)), want)


def test_affine_salt_gives_a_half_the_full_batchs_masks():
    """The plain attention with the hash dropout on each half, salted
    (row_offset * heads, heads): the same keep masks, outputs and gradients
    (q, k, v, the tables) as the whole batch; the bf16 backward's plain
    version too."""
    q, k, v, mask, ek, ev, go, w = _attention_inputs()
    h = q.shape[1]

    def run(rows, salt):
        leaves = [a.clone().requires_grad_() for a in (q[rows], k[rows], v[rows], ek, ev)]
        out = banded_attention_plain(leaves[0], leaves[1], leaves[2], mask[rows],
                                     leaves[3], leaves[4], w, 0.25, 99, salt)
        return (out, *torch.autograd.grad(out, leaves, go[rows]))

    full = run(slice(0, B), None)
    halves = [run(slice(o, o + B // 2), (o * h, h)) for o in (0, B // 2)]
    for i in range(4):  # out, dq, dk, dv: rows of the whole batch's
        assert torch.allclose(torch.cat([hv[i] for hv in halves]), full[i],
                              atol=1e-6, rtol=0)
    for i in (4, 5):  # the tables' gradients sum over the rows
        assert torch.allclose(halves[0][i] + halves[1][i], full[i], atol=1e-5, rtol=0)
    keep = hash_dropout_probs(torch.ones(B, h, 12, 12), 0.25, 99)
    for o in (0, B // 2):
        part = hash_dropout_probs(torch.ones(B // 2, h, 12, 12), 0.25, 99, (o * h, h))
        assert torch.equal(part, keep[o:o + B // 2])
    # the bf16 plain backward takes the salt the same way
    qb, kb, vb, _, ekb, evb, gb, _ = _attention_inputs(torch.bfloat16, seed=1)
    m, l = banded_attention_stats_plain(qb, kb, mask, ekb, w)
    delta = torch.randn(B, h, 12)
    args = lambda r: (qb[r], kb[r], vb[r], mask[r], ekb, evb, gb[r], m[r], l[r],  # noqa: E731
                      delta[r], w, 0.25, 5)
    full = banded_attention_bwd_plain_bf16(*args(slice(0, B)))
    halves = [banded_attention_bwd_plain_bf16(*args(slice(o, o + B // 2)), (o * h, h))
              for o in (0, B // 2)]
    for i in range(3):
        assert torch.equal(torch.cat([hv[i] for hv in halves]), full[i])


def test_module_attention_of_a_data_shard(monkeypatch):
    """MultiHeadAttention in fused training (the hash dropout): each half in
    its shard, with the shard's shared seed generator, gives the whole
    batch's outputs and (summed) parameter gradients."""
    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    torch.manual_seed(0)
    mha = MultiHeadAttention(8, 8, 2, window_size=3, p_dropout=0.2).train()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, 8, 14, generator=g)
    x_mask = (torch.arange(14)[None, :] < torch.tensor([14, 10, 14, 8])[:, None])
    x_mask = x_mask.float()[:, None, :]

    def run(rows, offset):
        mha.zero_grad()
        with data_shard(offset, B, seeds=torch.Generator().manual_seed(5)):
            out = mha(x[rows], x_mask[rows]) * x_mask[rows]
        out.pow(2).sum().backward()
        return out.detach(), [p.grad.clone() for p in mha.parameters()]

    full, g_full = run(slice(0, B), 0)
    parts = [run(slice(o, o + B // 2), o) for o in (0, B // 2)]
    assert torch.allclose(torch.cat([p[0] for p in parts]), full, atol=1e-6, rtol=0)
    for a, b, want in zip(parts[0][1], parts[1][1], g_full):
        assert torch.allclose(a + b, want, atol=1e-5, rtol=1e-5)


def test_data_parallel_engine_matches_single_engine():
    """TTSEngine on make_mesh(n_data=2, devices=["cpu", "cpu"]) against the
    single engine at nonzero noise: three requests (padded to four, two rows
    per replica), and a pile of five through run_packed (its chunk of one
    is one row on one device and two on the mesh: the replicas draw the
    one-device batch's noise)."""
    cfg = ModelConfig(**dict(TINY, bert_dim=16, ja_bert_dim=16))
    model = build_synthesizer(cfg, device="cpu", seed=0)
    kw = dict(text_buckets=(16, 32), frames_per_token=4)
    single = TTSEngine(model, device="cpu", **kw)
    dp = TTSEngine(model, mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]), **kw)
    assert dp.device == torch.device("cpu") and len(dp.replicas) == 2
    rng = np.random.default_rng(5)

    def req(t):
        inputs = (rng.integers(1, cfg.n_vocab, t).astype(np.int32),
                  rng.integers(0, cfg.num_tones, t).astype(np.int32),
                  rng.integers(0, cfg.num_languages, t).astype(np.int32),
                  *(rng.normal(size=(t, 16)).astype(np.float32) for _ in range(3)))
        return PreparedRequest(inputs=inputs, sid=int(rng.integers(0, 4)),
                               sdp_ratio=0.4, noise_scale=0.667, seed=5)

    reqs = [req(t) for t in (11, 20, 7)]
    pile = reqs + [req(9), req(14)]
    assert len(dp._pad_idx([0, 1, 2])) == 4 and len(dp._pad_idx([0])) == 2
    for got, want in ((dp.run_prepared(reqs), single.run_prepared(reqs)),
                      (dp.run_packed(pile, max_batch=2),
                       single.run_packed(pile, max_batch=2))):
        assert [len(g) for g in got] == [len(w) for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
