"""Inference-mode vector quantization for the V2.1/V2.2 emotion inputs.

Counterpart of `bert_vits2_tpu/nn/vq.py`. The reference's V2.1/V2.2 text
encoders embed an utterance-level emotion vector through a
`vector_quantize_pytorch.VectorQuantize` codebook
(oldVersion/V210/models.py:347-356: dim 1024, 10 codes, 1 head;
oldVersion/V220/models.py:380-402: dim 512 -> project_in 1024, 32 heads x
64 codes x 32 dims, one codebook per head -> project_out 512).

Serving needs the deterministic behaviour only (the library's eval mode
takes the nearest code; its stochastic sampling is a training-time
option): nearest-code quantization, or a direct index lookup. The module
carries the library's state_dict names, `_codebook.embed` [heads, size,
cdim] and `project_in` / `project_out`; the library's EMA buffers
(`_codebook.initted`, `cluster_size`, `embed_avg`) are training state that
the loader drops.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["VectorQuantizer"]


class VectorQuantizer(nn.Module):
    """L2 nearest-code quantizer in vector_quantize_pytorch's layout.

    dim: the feature size the caller sees. When heads * codebook_dim
    differs from dim, `project_in` / `project_out` (nn.Linear) map between
    the two, as the library does when `codebook_dim` is set."""

    def __init__(self, dim: int, codebook_size: int,
                 codebook_dim: int | None = None, heads: int = 1):
        super().__init__()
        self.heads = heads
        self.cdim = codebook_dim if codebook_dim is not None else dim
        inner = self.cdim * heads
        self._codebook = nn.Module()
        self._codebook.embed = nn.Parameter(
            torch.randn(heads, codebook_size, self.cdim))
        self.project_in = nn.Linear(dim, inner) if inner != dim else None
        self.project_out = nn.Linear(inner, dim) if inner != dim else None

    @property
    def codebook(self) -> torch.Tensor:
        return self._codebook.embed

    def indices(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., dim] -> the nearest code of each head [..., heads]."""
        y = self.project_in(x) if self.project_in is not None else x
        y = y.reshape(y.shape[:-1] + (self.heads, self.cdim))
        cb = self.codebook
        # squared L2 to every code, by the JAX module's expansion: [..., heads, size]
        d = (torch.sum(y ** 2, -1, keepdim=True)
             - 2.0 * torch.einsum("...hd,hnd->...hn", y, cb)
             + torch.sum(cb ** 2, -1))
        return torch.argmin(d, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize x [..., dim] -> the nearest codes' reconstruction [..., dim]."""
        idx = self.indices(x)
        q = self.codebook[torch.arange(self.heads, device=idx.device), idx]
        q = q.reshape(idx.shape[:-1] + (self.heads * self.cdim,))
        return self.project_out(q) if self.project_out is not None else q

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """Direct index lookup (V2.1's `get_output_from_indices`): idx [...]
        int -> [..., dim]. Serves heads == 1."""
        if self.heads != 1:
            raise ValueError(f"lookup serves one head, not {self.heads}")
        q = self.codebook[0][idx.long()]
        return self.project_out(q) if self.project_out is not None else q
