"""The sort join's match assembly: plain PyTorch version + wrapper.

Replaces the XLA assembly of ``cammiq_tpu/query/sortjoin.py`` (1268-1307):
a batch's match list (``cuckoo_verify``'s ``mrow``/``me``, the first
``min(counts[0], KP)`` of them valid) becomes per-read slots.  Row r of
the [B, maxm] outputs holds read r's distinct ``gid = prec[e, 0]`` in
ascending order, the first maxm of them, with ``rid1``/``rid2`` from
``prec[e, 1:3]`` of any one of its matches (equal ids carry equal
payloads); empty slots hold BIG, 0, 0, False.  ``overflow`` counts the
distinct (read, gid) pairs beyond maxm over the batch.  The result does
not depend on the order of the valid matches, and nothing past them is
read.

``match_assemble_plain`` is the assembly the port ran before the kernel:
an int64 sort on read * 2^31 + gid, a cumsum and the first-of-run scan
for each distinct match's rank within its read, and three scatters (the
JAX package's op for op; on the CPU bit-identical to it).

Kernel: ``csrc/match_assemble.cu`` (see the source note), one
cooperative launch a batch: each valid match goes straight to its read's
bucket of 4g 16-byte entries (an atomic on the read's count gives its
place), one grid barrier, then a group of g = 8-32 lanes a read (from
``lanes_for(maxm)``) dedups and ranks the read's entries in registers and
writes its row.  A list with a read past its bucket takes a fallback of
two more barriers: its matches packed by read, one block a wide read.  No
memset, no host sync.  A CPU tensor takes the plain version; a CUDA
tensor the kernel, which raises if it cannot build or launch.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from .build import I32, VP, CudaKernel, check_tensor, load, stream_ptr
from .first_of_run import first_of_run_scan_plain
from .gather_probe import BIG

KERNEL = CudaKernel("cammiq_match_assemble_packed", [ctypes.c_char_p])
_pack = struct.Struct("<17q").pack
BUCKET_PER_LANE = 4           # csrc/match_assemble.cu's kBucketPerLane
STATE_WORDS = 6               # its kStateWords: the words before cnt
GEOMETRY_FIELDS = ("lanes", "reads_per_block", "blocks", "threads",
                   "registers", "resident_blocks_per_sm", "shared_bytes",
                   "bucket_bytes")

# (device index, stream handle) -> (int32 state, int32 scratch): the
# kernel's barrier words, counts and per-read counters, zeroed once here
# and left at zero by every launch, and its buckets and fallback arrays,
# written before they are read; one pair a stream, so launches that may
# overlap never share them
_state: dict = {}


def match_assemble_plain(mrow: torch.Tensor, me: torch.Tensor,
                         counts: torch.Tensor, prec: torch.Tensor, O: int,
                         B: int, maxm: int, eu: int):
    """The kernel's contract on any device: (slots, rid1, rid2 int32 [B,
    maxm], in_u bool [B, maxm], overflow int32 [])."""
    KP = mrow.shape[0]
    dev = mrow.device
    valid = torch.arange(KP, device=dev) < counts[0]
    read = torch.where(valid, mrow // O, B).to(torch.int64)
    pr = prec.index_select(0, torch.where(valid, me, 0))          # [KP, 3]
    key = (read << 31) | torch.where(valid, pr[:, 0], BIG).to(torch.int64)
    key, order = torch.sort(key)
    pr = pr.index_select(0, order)
    read = key >> 31
    gid = (key & BIG).to(torch.int32)
    distinct = torch.ones(KP, dtype=torch.bool, device=dev)
    distinct[1:] = key[1:] != key[:-1]
    distinct &= read < B
    newread = torch.ones(KP, dtype=torch.bool, device=dev)
    newread[1:] = read[1:] != read[:-1]
    # rank among the read's distinct rows (sortjoin.py:1290-1295)
    dint = distinct.to(torch.int32)
    before = torch.cumsum(dint, 0, dtype=torch.int32) - dint
    (dstart,) = first_of_run_scan_plain(newread, before)
    rank = before - dstart
    put = distinct & (rank < maxm)
    overflow = (distinct & (rank >= maxm)).sum(dtype=torch.int32)
    flat = torch.where(put, read * maxm + rank, B * maxm)

    def scatter(fill, vals):
        out = torch.full((B * maxm + 1,), fill, dtype=torch.int32, device=dev)
        out.scatter_(0, flat, vals)                   # row B*maxm: dump slot
        return out[:B * maxm].reshape(B, maxm)

    slots = scatter(BIG, gid)
    return (slots, scatter(0, pr[:, 1].contiguous()),
            scatter(0, pr[:, 2].contiguous()), (slots < BIG) & (slots < eu),
            overflow)


def lanes_for(maxm: int) -> int:
    """The kernel's lanes a read for ``maxm`` slots (its ``lanes_for``); a
    read's bucket holds ``BUCKET_PER_LANE`` times as many matches."""
    return 8 if maxm <= 8 else 16 if maxm <= 16 else 32


def scratch_words(kp: int, B: int, maxm: int) -> int:
    """int32 words of scratch a launch needs: the buckets (4 words an
    entry), then the fallback's spilled (match, k) pairs, wide list,
    places, run starts and four arrays of the list's length."""
    S = BUCKET_PER_LANE * lanes_for(maxm)
    return 4 * B * S + 6 * kp + 3 * B + 1


def _state_for(dev: torch.device, stream: int, B: int, words: int) -> tuple:
    key = (dev.index, stream)
    state, scratch = _state.get(key, (None, None))
    if state is None or state.numel() < STATE_WORDS + B:
        state = torch.zeros(STATE_WORDS + B, dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < words:
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _state[key] = state, scratch
    return state, scratch


def match_assemble(mrow: torch.Tensor, me: torch.Tensor, counts: torch.Tensor,
                   prec: torch.Tensor, O: int, B: int, maxm: int, eu: int):
    """int32 mrow/me [KP] with int32 counts [2] (``cuckoo_verify``'s
    output), int32 prec [E, 3], the offsets a read ``O``, the batch's
    reads ``B``, slots a read ``maxm`` and the unique table's entries
    ``eu`` -> (slots, rid1, rid2 int32 [B, maxm], in_u bool [B, maxm],
    overflow int32 [])."""
    if mrow.device.type == "cpu":
        return match_assemble_plain(mrow, me, counts, prec, O, B, maxm, eu)
    dev = mrow.device
    if dev.type != "cuda":
        raise ValueError(f"match_assemble: unsupported device {dev}")
    check_tensor(mrow, "mrow", torch.int32, dev, 1)
    check_tensor(me, "me", torch.int32, dev, 1)
    check_tensor(counts, "counts", torch.int32, dev, 1)
    check_tensor(prec, "prec", torch.int32, dev, 2)
    kp = mrow.shape[0]
    if me.shape[0] != kp or counts.shape[0] != 2 or prec.shape[1] != 3:
        raise ValueError(f"match_assemble: mrow {tuple(mrow.shape)}, me "
                         f"{tuple(me.shape)}, counts {tuple(counts.shape)}, "
                         f"prec {tuple(prec.shape)}")
    words = scratch_words(kp, B, maxm)
    if O < 1 or B < 0 or maxm < 0 or words >= 2**31:
        raise ValueError(f"match_assemble: O={O}, B={B}, maxm={maxm}, kp={kp}")
    stream = stream_ptr(dev)
    state, scratch = _state_for(dev, stream, B, words)
    out = torch.empty(3, B, maxm, dtype=torch.int32, device=dev)
    in_u = torch.empty(B, maxm, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    at, plane = out.data_ptr(), 4 * B * maxm     # slots, rid1, rid2 in turn
    KERNEL(_pack(mrow.data_ptr(), me.data_ptr(), counts.data_ptr(),
                 prec.data_ptr(), kp, O, B, maxm, eu, at, at + plane,
                 at + 2 * plane, in_u.data_ptr(), overflow.data_ptr(),
                 state.data_ptr(), scratch.data_ptr(), stream))
    return out[0], out[1], out[2], in_u, overflow


def match_assemble_geometry(kp: int, B: int, maxm: int, device) -> dict:
    """How ``match_assemble`` launches for a [kp] list into [B, maxm] on
    the CUDA ``device`` (``GEOMETRY_FIELDS``): lanes a read, reads a
    group-path block, blocks, threads a block, the kernel's registers a
    thread, resident blocks an SM, static shared bytes a block and the
    buckets' bytes."""
    out = (ctypes.c_longlong * len(GEOMETRY_FIELDS))()
    lib = load()
    fn = lib.cammiq_match_assemble_geometry
    fn.argtypes = [I32, I32, I32, VP]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(kp, B, maxm, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"cammiq_match_assemble_geometry: CUDA error {err}: "
                           f"{lib.cammiq_error_string(err).decode()}")
    return dict(zip(GEOMETRY_FIELDS, out))
