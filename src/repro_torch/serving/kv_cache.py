"""Paged KV-cache manager (vLLM-style pages, host bookkeeping).

Device tensors live inside the engines; this manager owns the page budget
so continuous batching admission respects HBM capacity, and it sizes the
KV-link transfers (bytes per token per layer from the model config).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


def kv_bytes_per_token(cfg) -> int:
    """Per-token KV bytes for one full layer stack (bf16)."""
    if cfg.attn_kind == "mla":
        per_layer = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        n_attn = cfg.num_layers
    else:
        per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
        if cfg.block_kind == "mamba_attn":
            n_attn = cfg.num_layers // cfg.attn_every
        elif cfg.block_kind == "xlstm":
            return 0  # recurrent state only; transfer is O(1) per request
        elif cfg.block_kind == "encdec":
            n_attn = cfg.num_layers - cfg.encoder_layers
        else:
            n_attn = cfg.num_layers
    return per_layer * n_attn * 2  # bf16


# the attention caches' keys: their dim 1 is the sequence (B, S, ...)
SEQUENCE_LEAVES = ("k", "v", "ckv", "kr")


def pad_prefill_caches(caches, max_len: int):
    """Grow prefill-produced caches (S = prompt_len) to decode-sized
    buffers (S = max_len) — the KV-link handoff: the decode pool receives
    page-transferred caches and continues writing at position prompt_len.

    The port's caches are lists of per-layer (or per-group) dicts. The
    attention caches, selected by key (``k``/``v`` (B, S, Hkv, hd), MLA's
    ``ckv``/``kr`` (B, S, r)), are zero-padded on their sequence axis,
    dim 1, on each tensor's own device. Everything else passes through
    as-is: recurrent states (mLSTM ``C``/``n``/``m``/``conv``, sLSTM
    ``h``/``c``/``n``/``m``, mamba ``h``/``conv``) are O(1) per request,
    and the encoder-decoder's cross ``ck``/``cv`` stay at the encoder's
    length. This is the reference's stated contract ("recurrent states
    transfer as-is"); the reference's code pads every leaf of 4 or more
    dims, recurrent states and cross keys included."""
    import torch.nn.functional as F

    def one(name, leaf):
        if name in SEQUENCE_LEAVES and leaf.shape[1] < max_len:
            pad = [0, 0] * (leaf.ndim - 2) + [0, max_len - leaf.shape[1]]
            return F.pad(leaf, pad)  # (left, right) pairs from the last dim
        return leaf

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(c) for c in tree)
        return one(name, tree)

    return walk(caches)


@dataclasses.dataclass
class PageTable:
    pages: int = 0
    tokens: int = 0


class PagedKVManager:
    def __init__(self, capacity_bytes: float, cfg, page_tokens: int = 128):
        self.page_tokens = page_tokens
        self.bytes_per_token = max(kv_bytes_per_token(cfg), 1)
        self.capacity_pages = int(capacity_bytes
                                  / (self.bytes_per_token * page_tokens))
        self.used_pages = 0
        self.tables: Dict[int, PageTable] = {}

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_tokens)

    def can_admit(self, tokens: int) -> bool:
        return self.used_pages + self.pages_for(tokens) <= self.capacity_pages

    def allocate(self, rid: int, tokens: int) -> bool:
        need = self.pages_for(tokens)
        if self.used_pages + need > self.capacity_pages:
            return False
        self.tables[rid] = PageTable(pages=need, tokens=tokens)
        self.used_pages += need
        return True

    def extend(self, rid: int, new_tokens: int = 1) -> bool:
        """Grow a request by new_tokens, allocating a page on boundary."""
        t = self.tables[rid]
        t.tokens += new_tokens
        need = self.pages_for(t.tokens)
        if need > t.pages:
            if self.used_pages + (need - t.pages) > self.capacity_pages:
                t.tokens -= new_tokens
                return False
            self.used_pages += need - t.pages
            t.pages = need
        return True

    def free(self, rid: int):
        t = self.tables.pop(rid, None)
        if t:
            self.used_pages -= t.pages

    @property
    def utilization(self) -> float:
        return self.used_pages / max(self.capacity_pages, 1)
