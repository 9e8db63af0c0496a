"""Read batches at 2 bits a base (``cammiq_tpu_torch/kernels/read_pack.py``):
the numpy packer and the plain unpack give back every code and length,
and a batch with a code outside 0..3 does not pack.  The native packer and
the CUDA kernel against these are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from cammiq_tpu_torch.io.fastq import ReadSet
from cammiq_tpu_torch.kernels.read_pack import (layout, pack_reads,
                                                pack_reads_plain,
                                                unpack_reads_plain)


def _batch(case: str, Lp: int, seed: int):
    """(codes [B, Lp] int8, lengths [B] int32) of one batch."""
    rng = np.random.default_rng(seed)
    if case == "strided":        # a [R, 256] read set trimmed to Lp, in place
        full = rng.integers(0, 4, (300, 256)).astype(np.int8)
        codes = full[:, :Lp]
        assert codes.strides[0] == 256 and not codes.flags.c_contiguous
        return codes, rng.integers(0, Lp + 1, 300).astype(np.int32)
    if case == "padded":         # the last batch of a read set, zero rows after
        rs = ReadSet(codes=rng.integers(0, 4, (1000, Lp)).astype(np.int8),
                     lengths=np.full(1000, Lp, np.int32), total_len=1000 * Lp,
                     name="p")
        *_, last = rs.batches(768)
        assert last.count == 232 and last.capacity == 768
        return last.codes, last.lengths
    codes = rng.integers(0, 4, (257, Lp)).astype(np.int8)
    if case == "lengths":        # every length from 0 to Lp, codes zero past it
        lengths = np.arange(257, dtype=np.int32) % (Lp + 1)
        codes[np.arange(Lp) >= lengths[:, None]] = 0
        return codes, lengths
    return codes, rng.integers(0, Lp + 1, 257).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "strided", "padded", "lengths"])
@pytest.mark.parametrize("Lp", [1, 3, 4, 99, 100, 101])
def test_pack_unpack_round_trip(Lp, case):
    codes, lengths = _batch(case, Lp, seed=Lp)
    B = codes.shape[0]
    buf = pack_reads_plain(codes, lengths)
    P, off, nbytes = layout(B, Lp)
    assert buf.dtype == np.uint8 and buf.shape == (nbytes,)
    assert P == -(-Lp // 4) and off % 16 == 0 and B * P <= off < B * P + 16
    # the layout, byte by byte: base j in bits 2 (j % 4) of byte j // 4
    rows = buf[:B * P].reshape(B, P)
    j = np.arange(Lp)
    np.testing.assert_array_equal((rows[:, j // 4] >> (2 * (j % 4))) & 3, codes)
    if Lp % 4:                   # the spare bits of a row's last byte
        assert not (rows[:, -1] >> (2 * (Lp % 4))).any()
    assert not buf[B * P:off].any()
    np.testing.assert_array_equal(buf[off:].view("<u2"), lengths)
    got_codes, got_lengths = unpack_reads_plain(torch.from_numpy(buf), B, Lp)
    assert got_codes.dtype == torch.int8 and got_codes.is_contiguous()
    assert got_lengths.dtype == torch.int32
    np.testing.assert_array_equal(got_codes.numpy(), codes)
    np.testing.assert_array_equal(got_lengths.numpy(), lengths)


@pytest.mark.parametrize("where", ["first", "last", "middle", "length"])
def test_batch_outside_two_bits_does_not_pack(where):
    """A -1 code (what the JAX package's tests plant for N) anywhere, or a
    length past uint16, and the batch goes up unpacked."""
    codes, lengths = _batch("strided", 100, seed=7)
    codes = codes.copy()
    assert pack_reads_plain(codes, lengths) is not None
    if where == "length":
        lengths = lengths.copy()
        lengths[5] = 1 << 16
    else:
        r, c = {"first": (0, 0), "last": (-1, -1), "middle": (150, 50)}[where]
        codes[r, c] = -1
    assert pack_reads_plain(codes, lengths) is None


@pytest.mark.parametrize("case", ["int64 lengths", "bases apart", "uint8 codes",
                                  "lengths apart"])
def test_batch_outside_the_packers_contract_goes_unpacked(case):
    """A batch the native packer does not take says so, before the packer
    is loaded, and goes up unpacked as before: it does not raise."""
    codes, lengths = _batch("random", 100, seed=9)
    if case == "int64 lengths":
        lengths = lengths.astype(np.int64)
    elif case == "bases apart":
        codes = np.repeat(codes, 2, axis=1)[:, ::2]
        assert codes.strides[1] == 2
    elif case == "uint8 codes":
        codes = codes.view(np.uint8)
    else:
        lengths = np.repeat(lengths, 2)[::2]
    out = np.zeros(layout(*codes.shape)[2], np.uint8)
    assert pack_reads(codes, lengths, out) is False
    with pytest.raises(ValueError, match="cannot hold"):
        pack_reads(codes, lengths, out[:-1])
