"""Read batches at 2 bits a base for the upload: the host packer, the
device unpack, and their plain versions.

A packed batch of B reads of Lp bases is one uint8 buffer (``layout``;
``csrc/read_pack.cu`` has the same): the codes at P = ceil(Lp / 4) bytes a
read, row-major, base j in bits 2 (j % 4) of byte j // 4 and the spare bits
of a row's last byte zero; zeros up to ``off``, B * P rounded up to 16; the
lengths as uint16 from ``off``.  A batch packs where every code lies in
0..3 and every length in 0..65535.

``pack_reads`` (native, ``cammiq_pack_reads``: AVX2 where the CPU has it,
one thread) writes the buffer from the codes' rows in place, at any row
stride, and says whether the batch packed (``pack_reads_scalar``: the
same through its scalar loop);
``pack_reads_plain`` is its numpy twin.  ``unpack_reads`` gives back the
int8 [B, Lp] codes and int32 [B] lengths: on a CUDA buffer one launch of
``unpack_reads_kernel`` on the current stream, no host sync; on the CPU
``unpack_reads_plain``.  The packer lives in the kernel library, so it is
built (with nvcc) where the card is.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .build import I32, I64, VP, CudaKernel, check_tensor, load, stream_ptr

KERNEL = CudaKernel("cammiq_unpack_reads", [VP, I32, I32, VP, VP, VP])
_pack: dict = {}


def layout(B: int, Lp: int) -> Tuple[int, int, int]:
    """(bytes a read P, the lengths' offset, the buffer's bytes)."""
    P = (Lp + 3) // 4
    off = (B * P + 15) // 16 * 16
    return P, off, off + 2 * B


def pack_reads_plain(codes: np.ndarray,
                     lengths: np.ndarray) -> Optional[np.ndarray]:
    """The packed batch of int8 codes [B, Lp] and lengths [B], or None
    where it does not pack."""
    B, Lp = codes.shape
    if (codes.view(np.uint8) & 0xFC).any() or not (
            (lengths >= 0) & (lengths <= 0xFFFF)).all():
        return None
    P, off, nbytes = layout(B, Lp)
    c = np.zeros((B, 4 * P), np.uint8)
    c[:, :Lp] = codes
    q = c.reshape(B, P, 4)
    out = np.zeros(nbytes, np.uint8)
    out[:B * P] = (q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4
                   | q[..., 3] << 6).reshape(-1)
    out[off:] = lengths.astype("<u2").view(np.uint8)
    return out


def pack_reads(codes: np.ndarray, lengths: np.ndarray, out: np.ndarray,
               _entry: str = "cammiq_pack_reads") -> bool:
    """Pack int8 codes [B, Lp] (rows at any stride, bases adjacent) and
    int32 lengths [B] into ``out`` (uint8, at least ``layout``'s bytes);
    False where the batch does not pack (``out`` then holds no batch): a
    code outside 0..3, a length outside uint16, or a batch the packer and
    ``unpack_reads`` do not take (another dtype, bases not adjacent, 2^31
    codes or more)."""
    B, Lp = codes.shape
    if out.dtype != np.uint8 or not out.flags.c_contiguous or (
            out.size < layout(B, Lp)[2]):
        raise ValueError(f"out: {out.dtype} [{out.size}] cannot hold the batch")
    if (codes.dtype != np.int8 or (B > 1 and Lp > 1 and codes.strides[1] != 1)
            or B * Lp >= 2**31 or lengths.dtype != np.int32
            or lengths.shape != (B,) or not lengths.flags.c_contiguous):
        return False
    fn = _pack.get(_entry)
    if fn is None:
        fn = getattr(load(), _entry)
        fn.argtypes = [VP, I64, I32, I32, VP, VP]
        fn.restype = ctypes.c_int
        _pack[_entry] = fn
    return bool(fn(codes.ctypes.data, codes.strides[0], B, Lp,
                   lengths.ctypes.data, out.ctypes.data))


def pack_reads_scalar(codes: np.ndarray, lengths: np.ndarray,
                      out: np.ndarray) -> bool:
    """``pack_reads`` through the packer's scalar loop, whatever the CPU
    has (for tests)."""
    return pack_reads(codes, lengths, out, "cammiq_pack_reads_scalar")


def unpack_reads_plain(buf: torch.Tensor, B: int,
                       Lp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes [B, Lp] and int32 lengths [B] of a packed batch."""
    P, off, _ = layout(B, Lp)
    q = buf[:B * P].reshape(B, P, 1).to(torch.int32)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=buf.device)
    codes = ((q >> shifts) & 3).reshape(B, 4 * P)[:, :Lp]
    lens = buf[off:off + 2 * B].to(torch.int32)
    return (codes.to(torch.int8).contiguous(),
            lens[0::2] | (lens[1::2] << 8))


def unpack_reads(buf: torch.Tensor, B: int,
                 Lp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same contract as ``unpack_reads_plain``; ``buf`` uint8, 1-d."""
    if buf.device.type == "cpu":
        return unpack_reads_plain(buf, B, Lp)
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"unpack_reads: unsupported device {dev}")
    check_tensor(buf, "buf", torch.uint8, dev, 1)
    if buf.shape[0] < layout(B, Lp)[2] or buf.data_ptr() % 16:
        raise ValueError(f"buf: {buf.shape[0]} bytes at {buf.data_ptr():#x} "
                         f"cannot hold {B} x {Lp} (16-byte aligned)")
    if B * Lp >= 2**31:
        raise ValueError(f"unpack_reads: {B} x {Lp} codes exceed int32")
    codes = torch.empty((B, Lp), dtype=torch.int8, device=dev)
    lengths = torch.empty(B, dtype=torch.int32, device=dev)
    KERNEL(buf.data_ptr(), B, Lp, codes.data_ptr(), lengths.data_ptr(),
           stream_ptr(dev))
    return codes, lengths
