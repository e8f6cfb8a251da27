"""Port parity: litbox_tpu_torch.prof.microops (the plain versions, on CPU
tensors) against the Pallas kernels of runs/prof_microops.py, run in
interpret mode at (3, 256, 256) float32.

The script's kernels are closures inside its main() and the script imports
runs/bench_1080p.py, so they are restated below, body for body, each naming
its line. S = 256 keeps two 128-lane strips for the sublane roll. Every
function is pure data movement (and a doubling, exact in float32), so the
port is held to the kernels bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from litbox_tpu_torch.prof import microops

N, S = 3, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k_transpose(in_ref, out_ref):
    """runs/prof_microops.py:50-51."""
    out_ref[:] = jnp.swapaxes(in_ref[0], 0, 1)[None]


def k_transpose2(in_ref, out_ref):
    """runs/prof_microops.py:66-68."""
    t = jnp.swapaxes(in_ref[0], 0, 1)
    out_ref[:] = jnp.swapaxes(t * 2.0, 0, 1)[None]


def k_subroll(shift_ref, in_ref, out_ref):
    """runs/prof_microops.py:83-91: a dynamic sublane roll of (S, 128) strips."""
    d = pl.program_id(0)
    sh = shift_ref[d]
    acc = jnp.zeros((S, S), jnp.float32)
    for strip in range(S // 128):
        blk = in_ref[0, :, strip * 128:(strip + 1) * 128]
        acc = acc.at[:, strip * 128:(strip + 1) * 128].set(
            pltpu.roll(blk, sh % S, axis=0))
    out_ref[0] = acc


def k_laneroll(shift_ref, in_ref, out_ref):
    """runs/prof_microops.py:110-115: a dynamic lane roll of (8, S) blocks."""
    d = pl.program_id(0)
    sh = shift_ref[d]
    for blk in range(S // 8):
        rows = in_ref[0, blk * 8:(blk + 1) * 8, :]
        out_ref[0, blk * 8:(blk + 1) * 8, :] = pltpu.roll(rows, sh % S, axis=1)


def k_flip(in_ref, out_ref):
    """runs/prof_microops.py:140-141."""
    out_ref[0] = in_ref[0][::-1, ::-1]


@functools.cache
def _pallas(kernel, with_shifts: bool):
    """The script's pallas_call around a kernel (its :53-61 without shifts,
    :93-104 with them), interpreted, returning the whole output."""
    out_shape = jax.ShapeDtypeStruct((N, S, S), jnp.float32)
    if not with_shifts:
        spec = pl.BlockSpec((1, S, S), lambda d: (d, 0, 0))
        return jax.jit(pl.pallas_call(kernel, grid=(N,), in_specs=[spec],
                                      out_specs=spec, out_shape=out_shape,
                                      interpret=True))
    spec = pl.BlockSpec((1, S, S), lambda d, c: (d, 0, 0))
    return jax.jit(pl.pallas_call(
        kernel, grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(N,), in_specs=[spec], out_specs=spec),
        out_shape=out_shape, interpret=True))


def _image(seed):
    return np.random.default_rng(seed).uniform(0, 1, (N, S, S)).astype(np.float32)


# (port function, Pallas kernel, shifts or None). Shifts (0, 5, 300) as in
# range and past S; (-7, 256, 511) for jnp's floor modulo of negative
# shifts and shifts >= S.
CASES = {
    "transpose": ("transpose", k_transpose, None),
    "transpose2": ("transpose2", k_transpose2, None),
    "roll_rows": ("roll_rows", k_subroll, (0, 5, 300)),
    "roll_rows_floor_mod": ("roll_rows", k_subroll, (-7, 256, 511)),
    "roll_cols": ("roll_cols", k_laneroll, (0, 5, 300)),
    "roll_cols_floor_mod": ("roll_cols", k_laneroll, (-7, 256, 511)),
    "flip2": ("flip2", k_flip, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_microops_match_pallas(case):
    name, kernel, shifts = CASES[case]
    x = _image(70)
    if shifts is None:
        ref = _pallas(kernel, False)(jnp.asarray(x))
        got = getattr(microops, name)(torch.from_numpy(x))
    else:
        sh = np.asarray(shifts, np.int32)
        ref = _pallas(kernel, True)(jnp.asarray(sh), jnp.asarray(x))
        got = getattr(microops, name)(torch.from_numpy(x), torch.from_numpy(sh))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (N, S, S)
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "transpose":  # the script's XLA yardstick (d, :134-139)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.swapaxes(jnp.asarray(x), 1, 2)))


def test_microops_reject_bad_arguments():
    x = torch.from_numpy(_image(71))
    with pytest.raises(ValueError):
        microops.roll_rows(x, torch.zeros(N + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        microops.roll_cols(x, torch.zeros((N, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        microops.roll_rows(x, torch.zeros(N, dtype=torch.int64))
    with pytest.raises(ValueError):
        microops.flip2(x[:, :, :-1])
