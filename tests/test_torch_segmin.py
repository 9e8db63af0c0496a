"""The segmented min-scan of the device build's LCP0 stages
(``cammiq_tpu_torch/kernels/segmented_min.py``, and ``ops/scans.py`` over
it): the plain version, forward and reverse, against
``cammiq_tpu/ops/scans_jax.py`` on seeded inputs, and the wrapper's
dispatch and checks on the CPU.  The CUDA kernel against the plain version
is in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cammiq_tpu.ops.scans_jax import segmented_cummin_jax, segmented_cummin_rev_jax
from cammiq_tpu_torch.kernels import segmented_min as ksm
from cammiq_tpu_torch.ops.scans import segmented_cummin, segmented_cummin_rev

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

TILE = 4096             # the kernel's tile (csrc/segmented_min.cu)
VMAX = (1 << 31) - 1
_jax_fwd = jax.jit(segmented_cummin_jax)
_jax_rev = jax.jit(segmented_cummin_rev_jax)


def _flags(pattern, n, rng):
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "all":
        return np.ones(n, bool)
    if pattern == "only_first":
        return np.arange(n) == 0
    if pattern == "only_last":
        return np.arange(n) == n - 1
    if pattern == "lead_run":     # no flag in the first half, then 1%
        f = rng.random(n) < 0.01
        f[:n // 2] = False
        return f
    return rng.random(n) < float(pattern)


def _values(n, rng):
    """Random LCP-like values, with runs of 0 and of 2^31 - 1."""
    v = rng.integers(0, 1 << 31, n, dtype=np.int64)
    pick = rng.random(n)
    v[pick < 0.2] = 0
    v[pick > 0.8] = VMAX
    return v.astype(np.int32)


PATTERNS = ["none", "all", "only_first", "only_last", "lead_run",
            "1e-4", "1e-3", "1e-2", "0.1", "0.5"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, TILE - 1, TILE, TILE + 1, 5 * TILE + 7])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_segmented_min_plain_matches_jax(pattern, n, reverse):
    rng = np.random.default_rng([n, PATTERNS.index(pattern), reverse])
    flags = _flags(pattern, n, rng)
    v = _values(n, rng)
    want = np.asarray((_jax_rev if reverse else _jax_fwd)(jnp.asarray(v),
                                                           jnp.asarray(flags)))
    tv, tf = torch.from_numpy(v), torch.from_numpy(flags)
    got = ksm.segmented_min_plain(tv, tf, reverse=reverse)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    via_ops = (segmented_cummin_rev if reverse else segmented_cummin)(tv, tf)
    np.testing.assert_array_equal(via_ops.numpy(), want)


@pytest.mark.parametrize("value", [0, VMAX])
@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_min_plain_extreme_values(value, reverse):
    """Every value at 0 or at 2^31 - 1, except one 1 in each segment."""
    n = 2 * TILE + 3
    rng = np.random.default_rng(value % 7 + reverse)
    flags = rng.random(n) < 1e-3
    v = np.full(n, value, np.int32)
    v[rng.integers(0, n, 20)] = 1
    fn = _jax_rev if reverse else _jax_fwd
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(flags)))
    got = ksm.segmented_min(torch.from_numpy(v), torch.from_numpy(flags),
                            reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segmented_min_plain_on_offset_views():
    """The build's reverse scan reads lcp[1:n+1], a view one element past
    its storage's start (the kernel's unaligned-load case)."""
    rng = np.random.default_rng(5)
    n = 3 * TILE + 11
    lcp = torch.from_numpy(_values(n + 1, rng))
    ends = torch.from_numpy(rng.random(n) < 0.01)
    for view in (lcp[1:n + 1], lcp[:n]):
        for reverse in (False, True):
            want = (_jax_rev if reverse else _jax_fwd)(
                jnp.asarray(view.numpy()), jnp.asarray(ends.numpy()))
            np.testing.assert_array_equal(
                ksm.segmented_min(view, ends, reverse=reverse).numpy(),
                np.asarray(want))


def test_segmented_min_empty():
    v = torch.zeros(0, dtype=torch.int32)
    f = torch.zeros(0, dtype=torch.bool)
    for reverse in (False, True):
        assert ksm.segmented_min(v, f, reverse=reverse).shape == (0,)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel: its launcher is replaced by
    one that fails, and the launch count stays."""
    def refuse(*args):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(ksm.KERNEL, "_fn", refuse)
    before = ksm.KERNEL.launches
    rng = np.random.default_rng(1)
    v = torch.from_numpy(_values(1000, rng))
    f = torch.from_numpy(rng.random(1000) < 0.05)
    for reverse in (False, True):
        assert torch.equal(ksm.segmented_min(v, f, reverse=reverse),
                           ksm.segmented_min_plain(v, f, reverse=reverse))
    assert ksm.KERNEL.launches == before


def test_other_device_raises():
    v = torch.zeros(8, dtype=torch.int32, device="meta")
    f = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ksm.segmented_min(v, f)
    with pytest.raises(ValueError, match="unsupported device"):
        segmented_cummin_rev(v, f)


def test_wrapper_rejects_bad_inputs():
    v = torch.zeros(8, dtype=torch.int32)
    f = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        ksm.segmented_min(v.long(), f)
    with pytest.raises(TypeError):
        ksm.segmented_min(v, f.to(torch.uint8))
    with pytest.raises(ValueError):
        ksm.segmented_min(v, f[:7])
    with pytest.raises(ValueError):
        ksm.segmented_min(v.reshape(2, 4), f.reshape(2, 4))
