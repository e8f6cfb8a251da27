"""Port parity: litbox_tpu_torch's attenuation scan (kernel K1) against the
JAX package's Pallas attenuation_scan_rows, which runs in interpret mode
off the TPU. On the CPU the port's wrapper takes its plain version;
tests/test_torch_cuda.py holds the CUDA kernel to it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.ops.attnscan import attenuation_scan_rows as jax_scan
from litbox_tpu_torch.ops import attnscan

D, S = 8, 128


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.3, 1.0, (D, S, S)).astype(np.float32)
    srcs = [rng.uniform(0.0, 1.0, (2 * D, S, S)).astype(np.float32)
            for _ in range(3)]
    return t, srcs


@pytest.mark.parametrize("group,n_groups,src_offset",
                         [(0, 1, 0), (1, 4, 0), (0, 1, D), (1, 4, D)])
def test_scan_matches_pallas(group, n_groups, src_offset):
    t, srcs = _inputs(0)
    ref = jax_scan(jnp.asarray(t), *map(jnp.asarray, srcs), group=group,
                   n_groups=n_groups, src_offset=src_offset)
    got = attnscan.attenuation_scan_rows(
        torch.from_numpy(t), *map(torch.from_numpy, srcs), group=group,
        n_groups=n_groups, src_offset=src_offset)
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g.shape == (D // n_groups, S, S)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_scan_closed_form_single_row():
    """Constant t and a unit source at column 0: O[x] = sqrt(t) * t^x."""
    t = torch.full((1, 4, 16), 0.8)
    src = torch.zeros((1, 4, 16))
    src[:, :, 0] = 1.0
    out, _, _ = attnscan.attenuation_scan_rows(t, src, src, src)
    expect = 0.8 ** 0.5 * 0.8 ** torch.arange(16.0)
    torch.testing.assert_close(out[0, 2], expect, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kwargs", [dict(group=4, n_groups=4),
                                    dict(n_groups=3),
                                    dict(src_offset=D + 1)])
def test_scan_rejects_bad_selection(kwargs):
    t, srcs = _inputs(1)
    with pytest.raises(ValueError):
        attnscan.attenuation_scan_rows(torch.from_numpy(t),
                                       *map(torch.from_numpy, srcs), **kwargs)

