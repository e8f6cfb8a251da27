"""Port parity for litbox_tpu_torch/parallel/train_sharded.py (the sharded
denoiser training step) against the JAX package's, on the CPU.

The JAX step runs on one device of conftest's CPU mesh (unet_size 2, 4
features, crop 16, batch 4); its initial params and batch_stats are carried
into the port with convert.unet_from_flax. The port's steps run in ONE gloo
world of 4 spawned ranks (tests/torch_parallel_ranks.py::train_cases): one
rank, 4 data ranks, and (data 2, model 2) on a net of 32 features, whose
kernels of >= 256 output channels are channel-sharded. Losses, updated
params, adam's first moments and batch_stats are held within 1e-4: the
loss and the statistics relative to themselves, the params and the moments
to the largest magnitude of their tree (the conv biases before a BatchNorm
have gradients of 0 up to rounding). Adam's first update is about
lr * sign(gradient), so the params alone would hide a wrong gradient; the
first moment, 0.1 * (gradient + 0.01 * param), shows it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_train import _jitted_flax_init

from litbox_tpu.nn.unet import LitboxDenoiserNet as JaxNet
from litbox_tpu.parallel.train_sharded import build_sharded_train_step as jax_build
from litbox_tpu.parallel.train_sharded import make_train_mesh as jax_train_mesh
from litbox_tpu.parallel.train_sharded import param_shardings as jax_param_shardings
from litbox_tpu_torch import convert
from litbox_tpu_torch.parallel import world

TOL = 1e-4  # tests/test_parallel.py::test_sharded_train_bn_stats_are_global


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step():
    """tests/test_parallel.py's batch and one JAX step on a 1-device mesh:
    the initial variables (numpy) and the updated ones in the port's names."""
    rng = np.random.default_rng(0)
    inputs = rng.normal(size=(4, 16, 16, 1)).astype(np.float32)
    targets = rng.normal(size=(4, 16, 16, 1)).astype(np.float32) ** 2
    with _jitted_flax_init():
        step, params, stats, opt = jax_build(jax_train_mesh(1, model_parallel=1),
                                             unet_size=2, initial_features=4, crop=16,
                                             batch=4)
    initial = {"params": jax.tree.map(np.array, params),
               "batch_stats": jax.tree.map(np.array, stats)}
    params, stats, opt, loss = step(params, stats, opt, jnp.asarray(inputs),
                                    jnp.asarray(targets))
    stats = jax.tree.map(np.array, stats)
    new = convert.unet_from_flax({"params": jax.tree.map(np.array, params),
                                  "batch_stats": stats}, unet_size=2, initial_features=4)
    adam = [s for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    mu = convert.unet_from_flax({"params": jax.tree.map(np.array, adam.mu),
                                 "batch_stats": stats}, unet_size=2, initial_features=4)
    return dict(inputs=inputs, targets=targets, variables=initial, loss=float(loss),
                state={k: v.numpy() for k, v in new.items()},
                mu={k: v.numpy() for k, v in mu.items() if k in new and "running" not in k
                    and "num_batches" not in k})


@pytest.fixture(scope="module")
def port(jax_step):
    """Rank 0's results of ranks.train_cases in a world of 4."""
    case = {k: jax_step[k] for k in ("inputs", "targets", "variables")}
    return world.run(ranks.train_cases, 4, case, device="cpu", timeout=600)[0]


def _close_tree(got: dict, want: dict, what: str) -> None:
    """Every tensor within TOL of the largest magnitude of the tree."""
    assert sorted(got) == sorted(want), what
    scale = max(float(np.abs(p).max()) for p in want.values())
    for k, p in want.items():
        np.testing.assert_allclose(got[k], p, rtol=0, atol=TOL * scale, err_msg=f"{what} {k}")


def _same_step(got: dict, loss: float, params: dict, mu: dict, stats: dict) -> None:
    assert abs(got["loss"] - loss) < TOL * max(1.0, abs(loss)), (got["loss"], loss)
    _close_tree(got["params"], params, "params")
    _close_tree(got["mu"], mu, "first moment")
    assert sorted(got["stats"]) == sorted(stats)
    for k, s in stats.items():
        np.testing.assert_allclose(got["stats"][k], s, rtol=TOL, atol=1e-6, err_msg=k)


def _split(state: dict) -> tuple[dict, dict]:
    params = {k: v for k, v in state.items()
              if "running" not in k and "num_batches" not in k}
    stats = {k: v for k, v in state.items() if "running" in k}
    return params, stats


def test_one_rank_step_matches_jax(jax_step, port):
    """From the JAX step's initial state, one port step on one rank gives
    the JAX step's loss, params and batch_stats."""
    params, stats = _split(jax_step["state"])
    _same_step(port["jax_1"], jax_step["loss"], params, jax_step["mu"], stats)


def test_data_parallel_step_matches_one_rank(port):
    """4 data ranks with global BatchNorm statistics and averaged gradients
    equal the one-rank step on the same global batch."""
    one = port["jax_1"]
    _same_step(port["data_4"], one["loss"], one["params"], one["mu"], one["stats"])


def test_data_model_step_matches_one_rank(port):
    """(data 2, model 2) on the 32-feature net, whose kernels of >= 256
    output channels are halved on each rank, equals the one-rank step."""
    one = port["wide_1"]
    local = port["wide_2x2"]["local_shapes"]
    halved = [k for k, shape in local.items() if shape != one["params"][k].shape]
    assert halved and all(local[k][0] * 2 == one["params"][k].shape[0] for k in halved)
    _same_step(port["wide_2x2"], one["loss"], one["params"], one["mu"], one["stats"])


def test_param_shardings_match_jax(port):
    """The full-width net (size 5, 32 features) on a (data 2, model 2)
    mesh: the port shards the kernels the JAX function shards, by name."""
    model = JaxNet(unet_size=5, initial_features=32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 1)),
                                               train=False))["params"]
    specs = jax_param_shardings(shapes, jax_train_mesh(4, model_parallel=2))
    want = {"/".join(p.key for p in path)
            for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]
            if "model" in spec.spec}
    got = {convert.flax_path(name)[1] for name in port["shardings"]}
    assert want and got == want
