"""How the split-KV decode kernels (``csrc/split_kv.cuh``) cut a row's keys:
one rule for the paged kernel and for the two contiguous ones."""
from __future__ import annotations

TARGET_BLOCKS = 128  # about one block per SM of an H100 (132)
MIN_SPLIT_KEYS = 16  # one k-step of the value product's mma


def split_pages(B: int, H: int, KVH: int, T: int, page_size: int) -> int:
    """Pages per split of the kernel: enough splits that ``B * KVH`` groups
    of up to 16 heads fill about TARGET_BLOCKS blocks, each split at least
    MIN_SPLIT_KEYS keys. A function of the shapes only: reading ``kv_len``
    would cost the decode step a host sync."""
    groups = B * KVH * -(-(H // KVH) // 16)
    splits = max(1, -(-TARGET_BLOCKS // groups))
    return min(T, max(-(-MIN_SPLIT_KEYS // page_size), -(-T // splits)))


def split_keys(B: int, H: int, KVH: int, S: int) -> int:
    """Keys per split of a contiguous cache of S slots: the cache read as
    pages of MIN_SPLIT_KEYS keys, cut by :func:`split_pages`."""
    T = -(-S // MIN_SPLIT_KEYS)
    return MIN_SPLIT_KEYS * split_pages(B, H, KVH, T, MIN_SPLIT_KEYS)
