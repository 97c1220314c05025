"""Load and launch the Bloom filter kernels (``csrc/bloom.cu``).

They replace no Pallas kernel: the reference runs its Bloom filter as XLA
(``pplp_tpu/primitives/bloom.py``: ``_insert_scan_fn``, ``_contains_fn``,
the size chain's ``_chain_insert_fn`` / ``_chain_contains_fn``) and in its
native library (``pplp_bf_indices_u64``, ``pplp_bf_insert_u64``). Two
kernels, each one launch a call, on a packed table of u32 words (an int32
tensor holding the bits, ``ceil(table_size / 32)`` words):

* ``insert_cuda`` sets the bits of every key against every salt;
* ``probe_cuda`` returns, per key, whether every salt's bit is set (bool).

Keys come as int64 (lo, hi) 32-bit word tensors (``keys=(lo, hi)``), or are
made by the kernel: ``blinded=(s, r, w, w_len, start, count)`` inserts the
server's keys ((s (di + r) mod 2^64) << w_len) | w for di in [start, start +
count); ``blind_distances=(bd, w, w_len)`` probes ((bd << w_len) | w) for an
int64 tensor bd of values below 2^32. ``sizes`` is the size chain (one size
for a plain filter), ending at the table size. The plain versions are
``primitives.bloom``'s (the unpacked table, ``index_fill_``, a gather); the
filter dispatches on its table's device. ``launches_by_kernel`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

__all__ = ["insert_cuda", "probe_cuda", "words_for", "launches_by_kernel", "reset_launches",
           "MAX_SALTS", "MAX_SIZES"]

SOURCE = cuda_build.CSRC / "bloom.cu"
MAX_SALTS = 128  # the reference's salt table (bloomfilter.h:468-490)
MAX_SIZES = 32  # a compressed filter's size chain
_WORDS, _BLINDED, _BLIND_DISTANCES = 0, 1, 2

launches_by_kernel = {"bf_insert": 0, "bf_probe": 0}


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _declare(lib):
    vp, i, ll, u, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
                         ctypes.c_ulonglong)
    lib.pplp_bf_insert.argtypes = [vp, vp, i, vp, i, i, i, vp, vp, ull, ull, ull, u, i, ll, vp]
    lib.pplp_bf_insert.restype = ctypes.c_int
    lib.pplp_bf_probe.argtypes = [vp, ll, vp, i, vp, i, i, i, vp, vp, u, i, ll, vp, vp]
    lib.pplp_bf_probe.restype = ctypes.c_int


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def words_for(table_size: int) -> int:
    """u32 words of a packed table of ``table_size`` bits."""
    return (table_size + 31) // 32


def _check_table(words: torch.Tensor, salts: torch.Tensor, sizes) -> np.ndarray:
    """Raise unless the table, salts and size chain are what the kernels
    take; returns the chain as a u32 host array."""
    if not words.is_cuda:
        raise ValueError(f"the Bloom kernels take CUDA tensors, got {words.device}")
    if words.dtype != torch.int32 or salts.dtype != torch.int64:
        raise TypeError(f"need int32 words and int64 salts, got {words.dtype}, {salts.dtype}")
    if salts.device != words.device:
        raise ValueError(f"salts on {salts.device}, table on {words.device}")
    if not (words.is_contiguous() and salts.is_contiguous()):
        raise ValueError("table and salts must be contiguous")
    if not 1 <= salts.numel() <= MAX_SALTS:
        raise ValueError(f"1 to {MAX_SALTS} salts, got {salts.numel()}")
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= MAX_SIZES:
        raise ValueError(f"a size chain of 1 to {MAX_SIZES} sizes, got {len(sizes)}")
    if not all(0 < s < (1 << 32) for s in sizes):
        raise ValueError(f"sizes must be in (0, 2^32): {sizes}")
    if words.numel() != words_for(sizes[-1]):
        raise ValueError(f"{words.numel()} words for a table of {sizes[-1]} bits")
    return np.asarray(sizes, dtype=np.uint32)


def _check_keys(words: torch.Tensor, *keys: torch.Tensor) -> int:
    count = keys[0].numel()
    for k in keys:
        if k.device != words.device or k.dtype != torch.int64 or not k.is_contiguous():
            raise ValueError(f"keys must be contiguous int64 on {words.device}, got "
                             f"{k.dtype} on {k.device}")
        if k.numel() != count:
            raise ValueError("lo and hi differ in length")
    return count


def _check_w(w: int, w_len: int, limit: int):
    if not (0 <= w_len < limit and 0 <= w < (1 << 32) and w >> max(w_len, 0) == 0):
        raise ValueError(f"need w < 2^w_len, 0 <= w_len < {limit}; got w={w}, w_len={w_len}")


def _stream(words: torch.Tensor) -> int:
    return torch.cuda.current_stream(words.device).cuda_stream


def insert_cuda(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
                keys=None, blinded=None):
    """Set the bits of the keys in the packed table ``words``, in place:
    ``keys=(lo, hi)`` int64 word tensors [K], or ``blinded=(s, r, w, w_len,
    start, count)``. One launch (none for no key)."""
    chain = _check_table(words, salts, sizes)
    if (keys is None) == (blinded is None):
        raise ValueError("give keys or blinded")
    if keys is not None:
        lo, hi = keys
        count = _check_keys(words, lo, hi)
        args = (_WORDS, lo.data_ptr(), hi.data_ptr(), 0, 0, 0, 0, 0, count)
    else:
        s, r, w, w_len, start, count = (int(v) for v in blinded)
        _check_w(w, w_len, 64)
        if not (0 <= s < (1 << 64) and 0 <= r < (1 << 64) and 0 <= start and 0 <= count):
            raise ValueError(f"bad blinded range {blinded}")
        args = (_BLINDED, None, None, s, r, start, w, w_len, count)
    if args[-1] == 0:
        return
    lib = load()
    code = lib.pplp_bf_insert(words.data_ptr(), salts.data_ptr(), salts.numel(),
                              chain.ctypes.data, chain.size, int(mixed), *args,
                              _stream(words))
    cuda_build.check(code, lib, "bf_insert")
    launches_by_kernel["bf_insert"] += 1


def probe_cuda(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
               keys=None, blind_distances=None) -> torch.Tensor:
    """Membership in the packed table ``words`` -> bool [K]: ``keys=(lo,
    hi)`` int64 word tensors [K], or ``blind_distances=(bd, w, w_len)`` with
    bd int64 [K] below 2^32 and 0 < w_len < 32. One launch (none for no key)."""
    chain = _check_table(words, salts, sizes)
    if (keys is None) == (blind_distances is None):
        raise ValueError("give keys or blind_distances")
    if keys is not None:
        lo, hi = keys
        count = _check_keys(words, lo, hi)
        args = (_WORDS, lo.data_ptr(), hi.data_ptr(), 0, 0, count)
    else:
        bd, w, w_len = blind_distances
        count = _check_keys(words, bd)
        _check_w(int(w), int(w_len), 32)
        args = (_BLIND_DISTANCES, bd.data_ptr(), None, int(w), int(w_len), count)
    out = torch.empty(count, dtype=torch.bool, device=words.device)
    if count == 0:
        return out
    lib = load()
    code = lib.pplp_bf_probe(words.data_ptr(), words.numel(), salts.data_ptr(), salts.numel(),
                             chain.ctypes.data, chain.size, int(mixed), *args, out.data_ptr(),
                             _stream(words))
    cuda_build.check(code, lib, "bf_probe")
    launches_by_kernel["bf_probe"] += 1
    return out
