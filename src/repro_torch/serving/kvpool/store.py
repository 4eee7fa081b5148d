"""Device-side paged KV storage for the dense family. Twin of
``repro/serving/kvpool/store.py``.

One pair of pool tensors per bound ``PagePool``, shared by every paged
stream of its engine:

    k, v : (L, N_pages, P, KV, head_dim)    in the engine's cache dtype,
                                            on the engine's device

The paged decode step (``layers/attention.py::attn_decode_paged``) writes
each row's new token at ``(page_table[row, pos // P], pos % P)`` and
gathers ``k[layer][page_table]`` back into a dense ``(B, n_pages·P, KV,
hd)`` view, shaped EXACTLY like the contiguous cache when ``page_size``
divides ``max_len``: that is what keeps paged greedy decode bit-identical
to the contiguous path (stale rows beyond ``pos`` are masked to exact
zeros either way).

The port writes the pool IN PLACE — the decode step's indexed write, a
join's ``write_prompt`` and a copy-on-write's ``copy_page`` — where the
reference replaces the whole pool tensor with a functional update. The
tensors' addresses never change, so the CUDA graphs of the paged steps,
which hold them, stay valid. The reference's ``place`` (pinning the pool
to a mesh sharding for its sharded heads) has no meaning on one card and
is left out (ROADMAP.md, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


class PagedKVStore:
    """Physical page storage (with per-page copy and write helpers) for one
    engine's dense or moe attention stack."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int,
                 dtype=torch.float32, device=None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"PagedKVStore takes the dense and moe stacks, not "
                f"{cfg.family}")
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.page_size = int(page_size)

    @property
    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def bytes_per_page(self) -> int:
        return self.nbytes // self.k.shape[1]

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write's substance: every layer's rows of ``src`` into
        ``dst`` (the new sole holder's page), in place."""
        self.k[:, dst].copy_(self.k[:, src])
        self.v[:, dst].copy_(self.v[:, src])

    def write_prompt(self, pages, solo_cache, first_page: int = 0) -> None:
        """Write a solo (B = 1) prefilled cache's rows into ``pages``, in
        place: ``pages[j]`` receives rows [j·P, (j+1)·P) of every layer,
        for j from ``first_page`` on (earlier grid slots are shared prefix
        pages another request owns already). Rows past the prompt carry
        the solo cache's zeros: finite, and masked until this stream's own
        decode writes them."""
        P = self.page_size
        n = len(pages)
        if first_page >= n:
            return
        sel = torch.as_tensor(list(pages[first_page:]), dtype=torch.long,
                              device=self.k.device)
        lo, hi = first_page * P, n * P
        for dst, src in ((self.k, solo_cache["k"]), (self.v, solo_cache["v"])):
            rows = src[:, 0, lo:hi]           # (L, (n − j0)·P, KV, hd)
            dst[:, sel] = rows.reshape(rows.shape[0], n - first_page, P,
                                       *rows.shape[2:]).to(dst.dtype)
