"""GAN and reconstruction losses (reference: losses.py:6-60).

Counterpart of `bert_vits2_tpu/train/losses.py`: LSGAN losses, the feature
loss x2 with the real maps detached, the masked KL normalized by the mask
sum. Inputs are in the port's [b, c, t] layout.
"""

from __future__ import annotations

import torch

from bert_vits2_tpu_torch.parallel.data import global_count


def feature_loss(fmap_r, fmap_g):
    """2 x the summed mean L1 between all real and fake feature maps."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN discriminator loss -> (loss, real losses, fake losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + (r_loss + g_loss)
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss -> (loss, per-discriminator losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        one = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(one)
        loss = loss + one
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    """Masked KL(q||p) between the posterior and the aligned prior,
    normalized by the mask's sum over the global batch (`global_count`:
    under a data-parallel step, the ranks' losses then average to the
    global batch's).

    z_p, logs_q, m_p, logs_p: [b, d, t]; z_mask: [b, 1, t]."""
    z_p, logs_q, m_p, logs_p, mask = (
        a.float() for a in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * mask) / global_count(torch.sum(mask))
