"""Port parity: litbox_tpu_torch.prof.rotfused's V1 and V2 (on CPU tensors,
their plain versions) against the Pallas kernels they stand for,
runs/prof_rotfused.py's k_copy and k_transpose2, run through the script's
pallas_call in interpret mode at (4, 128, 128) float32.

The script's kernels are closures inside its main(), and the script imports
runs/bench_1080p.py, so they are restated below, body for body, each naming
its lines. The pallas_call is the script's run_variant (:27-41): two
prefetched scalars (alpha, beta), one (1, S, S) input block per grid step,
an output block revisited on every step (the in-order sum over the grid)
and two VMEM scratch planes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from litbox_tpu_torch.prof import rotfused

N, S = 4, 128


def k_copy(a_ref, b_ref, img_ref, out_ref, t1, t2):
    """runs/prof_rotfused.py:74-83."""
    d = pl.program_id(0)

    @pl.when(d == 0)
    def _():
        out_ref[0] = img_ref[0]

    @pl.when(d != 0)
    def _():
        out_ref[0] = out_ref[0] + img_ref[0]


def k_transpose2(a_ref, b_ref, img_ref, out_ref, t1, t2):
    """runs/prof_rotfused.py:88-99: both transposes through the VMEM scratch
    planes t1 and t2."""
    d = pl.program_id(0)
    t1[:] = jnp.swapaxes(img_ref[0], 0, 1)
    t2[:] = jnp.swapaxes(t1[:], 0, 1)

    @pl.when(d == 0)
    def _():
        out_ref[0] = t2[:]

    @pl.when(d != 0)
    def _():
        out_ref[0] = out_ref[0] + t2[:]


@functools.cache
def _pallas(kernel):
    """runs/prof_rotfused.py:27-41 (run_variant's grid spec and call) at
    (N, S, S), interpreted."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(N,),
        in_specs=[pl.BlockSpec((1, S, S), lambda i, a, b: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, S, S), lambda i, a, b: (0, 0, 0)),
        scratch_shapes=[pltpu.VMEM((S, S), jnp.float32) for _ in range(2)],
    )
    return jax.jit(pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((1, S, S), jnp.float32), interpret=True))


def _inputs(seed):
    """Images and the script's residual-angle coefficients (:67-69), which
    V1 and V2 ignore."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (N, S, S)).astype(np.float32)
    resid = ((rng.uniform(0, 1, N) - 0.5) * (np.pi / 2)).astype(np.float32)
    return img, -np.tan(resid / 2).astype(np.float32), np.sin(resid).astype(np.float32)


@pytest.mark.parametrize("name,kernel", [("copy_accum", k_copy),
                                         ("transpose2_accum", k_transpose2)])
def test_split_matches_pallas(name, kernel):
    """Sums of 4 images, in grid order in the kernel and in PyTorch's order
    in the port: to 1e-6 of the maximum."""
    img, alpha, beta = _inputs(80)
    ref = np.asarray(_pallas(kernel)(jnp.asarray(alpha), jnp.asarray(beta),
                                     jnp.asarray(img)))[0]
    got = getattr(rotfused, name)(torch.from_numpy(img))
    assert got.shape == ref.shape == (S, S)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_pallas_variants_sum_in_grid_order():
    """The revisited output block sums the images in grid order: k_copy and
    k_transpose2 both equal the sequential float32 sum bit for bit, as the
    card's V1 and V2 must equal each other."""
    img, alpha, beta = _inputs(81)
    seq = img[0].copy()
    for d in range(1, N):
        seq = seq + img[d]
    for kernel in (k_copy, k_transpose2):
        out = _pallas(kernel)(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(img))
        np.testing.assert_array_equal(np.asarray(out)[0], seq)


def test_transpose2_accum_plain_equals_copy_accum_plain():
    """On the CPU too, V2's plain version (two transposed copies, then the
    sum) adds in V1's order: the two agree bit for bit."""
    img = torch.from_numpy(_inputs(82)[0])
    assert torch.equal(rotfused.transpose2_accum(img), rotfused.copy_accum(img))
