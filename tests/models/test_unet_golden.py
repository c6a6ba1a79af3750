"""The PanopticNet forward, training-mode statistics, gradients and random
init, pinned bitwise on the CPU against `unet_golden.npz`.

The golden file holds the outputs of the flax implementation this network
was first written in: the shipped mini checkpoint in eval and train mode
(outputs, updated batch statistics, per-leaf gradient sums), the full
Mesmer topology with manifest-shaped seeded weights in float32 and
bfloat16, and per-leaf sums of `init_mesmer` / `init_mesmer_mini` draws.
Any change to the layer arithmetic, parameter layout or init keys moves
these numbers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ark_tpu.models import convert_deepcell as cd
from ark_tpu.models import unet

from tests.models.test_keras_semantics import _golden_layers

HERE = os.path.dirname(__file__)
CKPT = os.path.join(HERE, "..", "..", "ark_tpu", "models", "checkpoints",
                    "mesmer_mini_synthetic.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(HERE, "unet_golden.npz")))


def _section(golden, prefix):
    return {k[len(prefix) + 1:]: v for k, v in golden.items()
            if k.startswith(prefix + "/")}


def _flat(tree):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = np.asarray(v)
    return out


def _leaf_sums(tree):
    return {k: np.array([a.astype(np.float64).sum(),
                         (a.astype(np.float64) ** 2).sum(),
                         float(a.ravel()[0]), float(a.ravel()[-1])])
            for k, a in _flat(tree).items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _mini():
    variables, cfg = unet.load_params_npz(CKPT, return_config=True)
    cfg = dict(cfg)
    cfg.pop("dtype")
    model = unet.PanopticNet(dtype=jnp.float32, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    return model, variables


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_mini_forward_bitwise(golden, mode):
    model, variables = _mini()
    x = golden["input"]
    if mode == "eval":
        out = jax.jit(lambda v, a: model.apply(v, a, train=False))(
            variables, x)
    else:
        out, upd = jax.jit(lambda v, a: model.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables, x)
        _assert_same(_flat(upd["batch_stats"]),
                     _section(golden, "mini_train_stats"))
    _assert_same(_flat(out), _section(golden, f"mini_{mode}"))


def test_mini_train_gradients_bitwise(golden):
    model, variables = _mini()
    x = golden["input"]

    def loss(p):
        out, _ = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             x, train=True, mutable=["batch_stats"])
        return sum(jnp.mean(a ** 2) for a in out.values())

    grads = jax.jit(jax.grad(loss))(variables["params"])
    _assert_same(_leaf_sums(grads), _section(golden, "mini_grad"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_topology_forward_bitwise(golden, dtype):
    _, var0 = unet.init_mesmer(seed=0, input_shape=(1, 64, 64, 2),
                               dtype=np.float32)
    conv = jax.tree.map(jnp.asarray, cd.convert(
        _golden_layers(), jax.device_get(jax.tree.map(np.asarray, var0))))
    model = unet.PanopticNet(
        dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    out = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        conv, golden["input"])
    _assert_same(_flat(out), _section(golden, f"full_{dtype}"))


@pytest.mark.parametrize("config", ["mini", "full"])
def test_init_draws_bitwise(golden, config):
    if config == "mini":
        _, variables = unet.init_mesmer_mini(seed=0,
                                             input_shape=(1, 64, 64, 2))
    else:
        _, variables = unet.init_mesmer(seed=0, input_shape=(1, 64, 64, 2),
                                        dtype=np.float32)
    _assert_same(_leaf_sums(variables), _section(golden, f"init_{config}"))
