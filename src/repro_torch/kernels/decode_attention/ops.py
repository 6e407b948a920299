"""Wrapper of kernel L3 (``csrc/decode_attention.cu``), one-token GQA
attention over a (ring) KV cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention/kernel.py``
(``decode_attention_padded``, body ``_kernel``) and its wrapper
``ops.decode_attention``, which pads the whole cache to a 512 multiple on
every call: the CUDA kernel masks the ragged S itself, so the wrapper
allocates only the output and, with more than one split, the split-KV
partials. Bound on the H100: bytes (see the source for the design).
``split_plan`` picks how many blocks share one (batch, kv head)'s
slots.

On a CUDA tensor ``decode_attention`` launches the kernel or raises (and
reports the launch to a recording op trace); on a CPU tensor it runs the
plain version (``ref.decode_attention_ref``); on ``meta`` tensors it
plans the launch (the output's shape and the record, no count). The
result is in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.bmf_precision.ops import check_cuda_operands
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 32            # slots per tile of the kernel's shared-memory ring
MAX_GROUP = 16       # query heads per KV head the kernel holds in registers
BLOCKS_PER_SM = 2    # the plan's one wave: two blocks on each SM
MIN_TILES = 2        # tiles per split, so that a block's ring has work


def _lib():
    fn = BUILD.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, Hkv: int, S: int, hd: int, n_sm: int):
    """(n_splits, chunk): each (batch, kv head)'s S slots are cut into
    ``n_splits`` splits of ``chunk`` slots (a multiple of TILE; the last
    split may be shorter). The grid is one wave: as many splits as keep
    B·Hkv·n_splits blocks within BLOCKS_PER_SM blocks on each of the
    ``n_sm`` SMs, at least one, and no split shorter than MIN_TILES
    tiles. ``hd`` does not enter: at every supported head size and group
    an SM holds BLOCKS_PER_SM blocks (at most 72 KB of shared memory and
    255 registers a thread each). Longer splits pay the ring's fill and
    the partials once per more slots; on the H100 one wave beat 2-32
    waves at both serve shapes (PERF.md)."""
    tiles = -(-S // TILE)
    wave = BLOCKS_PER_SM * n_sm
    n = max(1, min(wave // max(1, B * Hkv), tiles // MIN_TILES))
    chunk = -(-tiles // n) * TILE
    return -(-S // chunk), chunk


def decode_attention(q, k, v, kv_pos, q_pos: int, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, Hkv, hd) one layer's cache; kv_pos: (S,)
    int32 absolute position of each slot (-1 = empty); q_pos: the query's
    absolute position. Slot s counts iff 0 <= kv_pos[s] <= q_pos and
    (window == 0 or kv_pos[s] > q_pos - window). Returns (B, H, hd) in q's
    dtype."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, hd) and k = v (B, S, Hkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "agree on batch and head size, or H % Hkv != 0")
    if kv_pos.shape != (S,):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} != ({S},)")
    if k.dtype != v.dtype:
        raise TypeError(f"k and v dtypes differ: {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q_pos = int(q_pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_pos, q_pos,
                                    window).to(q.dtype)
    if q.device.type == "meta":
        # a dry run's plan: the output's shape and a record of the launch,
        # nothing computed and no launch counted
        o = torch.empty_like(q)
        _note(q, k, v, kv_pos, o)
        return o
    return _launch(q, k, v, kv_pos, q_pos, window)


def _note(q, k, v, kv_pos, o):
    OPT.note_kernel("repro_torch::decode_attention",
                    dict(q=q, k=k, v=v, kv_pos=kv_pos), dict(o=o))


decode_attention.launches = 0


def _launch(q, k, v, kv_pos, q_pos, window):
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if G > MAX_GROUP or S < 1:
        raise ValueError(f"decode_attention kernel takes group <= "
                         f"{MAX_GROUP} and S >= 1, got group {G}, S {S}")
    check_cuda_operands(dict(q=q, k=k, v=v, kv_pos=kv_pos),
                        dict(q=DTYPES, k=DTYPES, v=DTYPES,
                             kv_pos=(torch.int32,)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    dev = q.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nc, chunk = split_plan(B, Hkv, S, hd, n_sm)
    o = torch.empty_like(q)
    # one split writes o itself; more write partials that the kernel's
    # second launch combines
    acc = ml = None
    if nc > 1:
        part_acc = torch.empty((B, Hkv, nc, G, hd), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((B, Hkv, nc, G, 2), dtype=torch.float32,
                              device=dev)
        acc, ml = part_acc.data_ptr(), part_ml.data_ptr()
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
                 o.data_ptr(), acc, ml, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), B, S, H, Hkv, hd, q_pos,
                 int(window), chunk,
                 torch.cuda.current_stream(dev).cuda_stream)
    BUILD.check(err, "decode_attention_launch")
    decode_attention.launches += 1
    _note(q, k, v, kv_pos, o)
    return o
