"""The split of a slot's visible rows over several blocks, shared by the
decode attention kernels (K8 ``decode_attention``, K9
``decode_attention_int8``, K6 ``multiquery_decode_attention``, K7
``multiquery_decode_attention_int8``, K3 ``paged_decode_attention``, K4
``paged_decode_attention_int8``): the Python side of
``csrc/attention_common.cuh``'s ``clip_to_split``, ``merge_splits``,
``partial_floats`` and ``kMinShareRows``.

The host picks the number of splits from shapes alone; each block cuts its
share of the rows on the device; the block that draws a group's last
ticket merges the partials in split order, in the same launch. A group is
a (slot, kv head), or for K6 and K7 a (tile of up to MQ_BLOCK_ROWS query
rows, kv head, slot). The partials and tickets live in one workspace per
device and stream, which the kernels share: they run in order on that
stream, and every launch leaves the tickets at 0. A CUDA graph bakes in
the addresses it captured, so the engine reserves its stream's workspace
at the largest launch before its first capture, and a held workspace is
never replaced.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

MAX_GROUP = 8  # kMaxG: query heads per kv head the kernels take
# kMaxSplits and kSplitAlign: at most eight blocks per (slot, kv head),
# shares of whole 32-row warp chunks, no more splits than a full cache has
# passes of a block's eight warps (256 rows), and no more than two blocks
# per SM in all (measured on the H100: TinyLlama's 32 (slot, kv head) pairs
# ran fastest split 8 ways, Mistral-7B's 64 split 4 ways).
MAX_SPLITS = 8
SPLIT_ALIGN = 32
SPLIT_ROWS = 256
BLOCKS_PER_SM = 2
# kMinShareRows of the D = 128 builds of the int8 kernels (K4, K9, K7), the
# least rows of a share (one pass of a block's eight warps; the D = 64
# builds have none): split_share's min_rows
MIN_SHARE_ROWS_D128 = 256
# kMqMaxRows: query rows a K6 or K7 block holds, four 16-row tiles; their
# partials are sized for them
MQ_BLOCK_ROWS = 64


@functools.lru_cache(maxsize=4096)  # a pure function of its ints, asked once per launch
def split_plan(C: int, B: int, KH: int, sms: int) -> int:
    """Blocks per (slot, kv head) of a launch over ``C`` cache rows a slot,
    from the shapes and the SM count alone: never from the lengths, which
    stay on the device (the step reads nothing back). At most MAX_SPLITS."""
    return max(1, min(MAX_SPLITS, BLOCKS_PER_SM * sms // (B * KH), C // SPLIT_ROWS))


def split_share(c_lo: int, c_hi: int, z: int, splits: int,
                min_rows: int = 0) -> Tuple[int, int]:
    """Share z of the visible rows [c_lo, c_hi) when a slot is split
    ``splits`` ways: the kernels' cut (``clip_to_split``), equal shares of
    whole warp chunks in order, each at least ``min_rows``; empty (lo >= hi)
    once the rows run out."""
    share = -(-(c_hi - c_lo) // splits)
    rows = max(-(-share // SPLIT_ALIGN) * SPLIT_ALIGN, min_rows)
    lo = c_lo + z * rows
    return lo, min(c_hi, lo + rows)


def partial_floats(D: int, rows: int = MAX_GROUP) -> int:
    """Floats of one split's partial (``partial_floats<D, R>``): ``rows``
    query rows (MAX_GROUP for the decode kernels, MQ_BLOCK_ROWS for K6 and
    K7) of D sums, then a max and a sum per row."""
    return rows * (D + 2)


def launch_groups(B: int, KH: int, query_rows: int = 0) -> Tuple[int, int]:
    """(groups, partial rows) of a split launch over B slots x KH kv heads:
    a group per (slot, kv head) of MAX_GROUP rows for the single-query
    kernels (``query_rows`` 0), or for K6 and K7, whose (slot, kv head)
    holds ``query_rows`` = T x G query rows, a group per (tile of up to
    MQ_BLOCK_ROWS of them, kv head, slot) of MQ_BLOCK_ROWS rows."""
    if not query_rows:
        return B * KH, MAX_GROUP
    return B * KH * -(-query_rows // MQ_BLOCK_ROWS), MQ_BLOCK_ROWS


class _Workspace:
    """One stream's fp32 partials and group tickets, and the number of
    holders: CUDA graphs whose captured launches hold its addresses."""

    def __init__(self, floats: int, groups: int, dev: torch.device) -> None:
        self.floats, self.groups = floats, groups
        self.partial = torch.empty(floats, dtype=torch.float32, device=dev)
        self.tickets = torch.zeros(groups, dtype=torch.int32, device=dev)
        self.ptrs = (self.partial.data_ptr(), self.tickets.data_ptr())
        self.holders = 0


_workspaces: Dict[Tuple[int, int], _Workspace] = {}


def workspace(dev: torch.device, stream: int, groups: int, splits: int,
              D: int, rows: int = MAX_GROUP) -> Tuple[int, int]:
    """The addresses of the split workspace of ``stream`` on ``dev`` for
    ``groups`` groups split ``splits`` ways at head dim ``D``, partials of
    ``rows`` query rows: fp32 partials and the groups' tickets, zeroed (each
    split launch leaves them at 0 again); grown, never shrunk, as launches
    ask. Called before any capture it reserves that size. A workspace that
    a captured graph holds (``hold``) is never replaced: a launch that would
    grow it raises instead, since the graph would then read freed memory."""
    floats = groups * splits * partial_floats(D, rows)
    key = (dev.index, stream)
    have = _workspaces.get(key)
    if have is None or have.floats < floats or have.groups < groups:
        if have is not None:
            if have.holders:
                raise RuntimeError(
                    f"the split workspace of stream {stream:#x} ({have.floats} floats, "
                    f"{have.groups} tickets) is held by a captured CUDA graph; a launch "
                    f"asking {floats} floats and {groups} tickets would replace it: "
                    "reserve the largest launch before the first capture")
            floats, groups = max(floats, have.floats), max(groups, have.groups)
        have = _workspaces[key] = _Workspace(floats, groups, dev)
    return have.ptrs


def hold(dev: torch.device, stream: int) -> None:
    """Mark the workspace of ``stream`` as captured by one more graph (it
    must exist: reserve it first)."""
    _workspaces[(dev.index, stream)].holders += 1


def release(dev: torch.device, stream: int) -> None:
    """Undo one ``hold``; the workspace is freed with its last holder."""
    key = (dev.index, stream)
    have = _workspaces[key]
    have.holders -= 1
    if not have.holders:
        del _workspaces[key]
