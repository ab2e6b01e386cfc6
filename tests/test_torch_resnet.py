"""The port's ResNet (``ray_tpu_torch/models/resnet.py``) and predictor
(``ray_tpu_torch/train/predictor.py``) against the JAX package's flax
ResNet and ``JaxPredictor``, on the CPU.

Narrow models in float32: ``ResNet([1, 1], num_filters=8)`` on 16x16
inputs (the CIFAR stem) and with ``small_images=False`` on 32x32 (the
7x7 stride-2 stem and the max-pool, where "SAME" pads unevenly). Every
leaf is drawn from a numpy seed, the zero-initialised scales included, so
each convolution reaches the output. Logits, new batch statistics and
gradients within 1e-4 of each tensor's max|ref|, eval logits too; one bf16
case within 2e-2; the predictors within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models.resnet import ResNet as JaxResNet
from ray_tpu_torch.models import resnet as port
from ray_tpu_torch.models.convert import resnet_variables_from_numpy
from ray_tpu_torch.train import AdamW, Checkpoint, TorchPredictor

CASES = {"cifar_stem": (True, 16), "imagenet_stem": (False, 32)}
TOL = 1e-4


def _models(small, dtype=jnp.float32):
    kw = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8,
              small_images=small)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return JaxResNet(dtype=dtype, **kw), port.ResNet(dtype=tdtype, **kw)


def _shapes(jm, x):
    """flax's variables of ``jm`` for inputs like ``x``, as shapes only
    (tracing the init, which eager flax runs slowly)."""
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), train=True))


def _draw(variables, seed):
    """Every leaf from the seed: kernels and biases normal, scales around
    1 (none zero), running variances positive."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        x = rng.randn(*a.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.3 * x
        if "'var'" in name:
            return 0.5 + np.abs(x)
        if "kernel" in name:
            fan_in = int(np.prod(a.shape[:-1]))
            return x / np.sqrt(fan_in)
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    small, hw = CASES[request.param]
    jm, tm = _models(small)
    rng = np.random.RandomState(3)
    x = rng.randn(4, hw, hw, 3).astype(np.float32)
    labels = rng.randint(0, 10, (4,))
    v = _draw(_shapes(jm, x), 1)

    @jax.jit
    def ref(v, x):
        def loss_fn(p):
            logits, upd = jm.apply({"params": p,
                                    "batch_stats": v["batch_stats"]}, x,
                                   train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()
            return loss, (logits, upd["batch_stats"])

        (loss, (logits, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
        return loss, logits, stats, grads, jm.apply(v, x, train=False)

    want = jax.tree.map(np.asarray, ref(v, jnp.asarray(x)))
    return dict(jm=jm, tm=tm, x=x, labels=labels, v=v, want=want)


def _close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    top = np.abs(want).max()
    d = np.abs(got - want).max()
    assert d <= TOL * top, f"{what}: max|d| {d:.3e}, max|ref| {top:.3e}"


def _flax_name(name):
    head, _, rest = name.partition(".")
    if head.startswith("block"):
        head = f"ResNetBlock_{head[len('block'):]}"
        inner = {"conv1": "Conv_0", "norm1": "BatchNorm_0",
                 "conv2": "Conv_1", "norm2": "BatchNorm_1"}
        first, _, leaf = rest.partition(".")
        rest = f"{inner.get(first, first)}.{leaf}"
    elif head == "dense":
        head = "Dense_0"
    return f"{head}.{rest}".split(".")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _flax_leaf(tree, name):
    for key in _flax_name(name):
        tree = tree[key]
    a = np.asarray(tree)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def test_train_forward_matches_flax(case):
    tv = resnet_variables_from_numpy(case["v"], case["tm"], "cpu")
    loss, grads, stats = port.loss_and_grads(
        case["tm"], tv, torch.from_numpy(case["x"]),
        torch.from_numpy(case["labels"]))
    jloss, jlogits, jstats, jgrads, _ = case["want"]
    logits, _ = case["tm"].apply(tv, torch.from_numpy(case["x"]))
    _close(logits, jlogits, "logits")
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    flat_stats = _flat(stats)
    assert len(flat_stats) == len(jax.tree.leaves(jstats))
    for name, t in flat_stats.items():
        _close(t, _flax_leaf(jstats, name), f"batch_stats {name}")
    flat_grads = _flat(grads)
    assert len(flat_grads) == len(jax.tree.leaves(jgrads))
    for name, g in flat_grads.items():
        _close(g, _flax_leaf(jgrads, name), f"grad {name}")


def test_eval_forward_matches_flax(case):
    tv = resnet_variables_from_numpy(case["v"], case["tm"], "cpu")
    logits = case["tm"].apply(tv, torch.from_numpy(case["x"]), train=False)
    _close(logits, case["want"][4], "eval logits")


def test_bf16_forward_matches_flax():
    """bf16 convolutions, float32 norms and head, as flax computes them:
    2e-2 of max|ref|."""
    jm, tm = _models(False, jnp.bfloat16)
    x = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    v = _draw(_shapes(jm, x), 2)
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                            mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    tv = resnet_variables_from_numpy(v, tm, "cpu")
    got, stats = tm.apply(tv, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert stats["block1"]["norm_proj"]["var"].dtype == torch.float32
    want = np.asarray(want)
    d = np.abs(got.numpy() - want).max()
    assert d <= 2e-2 * np.abs(want).max(), d


def test_same_padding_is_flax_s():
    assert port.same_padding(32, 3, 2) == (0, 1)
    assert port.same_padding(224, 7, 2) == (2, 3)
    assert port.same_padding(33, 3, 2) == (1, 1)
    assert port.same_padding(16, 3, 1) == (1, 1)
    assert port.same_padding(16, 1, 2) == (0, 0)


def test_init_matches_flax_tree_and_dtypes():
    """The port's init has flax's leaves (shapes after the HWIO -> OIHW
    turn), float32 throughout, the second norm's scale zero, and the
    projection only where a block changes the shape."""
    tm = port.resnet18(dtype=torch.bfloat16)
    jm = JaxResNet(stage_sizes=[2, 2, 2, 2], num_classes=10)
    flax = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    ours = tm.init(torch.Generator().manual_seed(0), (1, 32, 32, 3), "cpu")
    for col in ("params", "batch_stats"):
        flat = _flat(ours[col])
        assert len(flat) == len(jax.tree.leaves(flax[col]))
        for name, t in flat.items():
            shape = _flax_name(name)
            leaf = flax[col]
            for key in shape:
                leaf = leaf[key]
            want = leaf.shape if len(leaf.shape) != 4 else tuple(
                leaf.shape[i] for i in (3, 2, 0, 1))
            assert tuple(t.shape) == tuple(want), name
            assert t.dtype == torch.float32
    assert not ours["params"]["block0"]["norm2"]["scale"].any()
    assert [k for k in ours["params"] if "conv_proj" in ours["params"][k]] \
        == ["block2", "block4", "block6"]
    assert port.resnet50().stage_sizes == [3, 4, 6, 3]


def test_converter_checks_every_shape(case):
    v = jax.tree.map(np.asarray, case["v"])
    v["params"]["ResNetBlock_1"]["Conv_1"]["kernel"] = np.zeros((3, 3, 8, 8))
    with pytest.raises(ValueError, match="ResNetBlock_1/Conv_1"):
        resnet_variables_from_numpy(v, case["tm"], "cpu")
    v = jax.tree.map(np.asarray, case["v"])
    del v["batch_stats"]["bn_init"]
    with pytest.raises(ValueError, match="bn_init"):
        resnet_variables_from_numpy(v, case["tm"], "cpu")


def test_train_steps_match_optax_adam():
    """``create_train_state`` + ``train_step`` with ``AdamW(1e-2,
    weight_decay=0)`` against flax with ``optax.adam(1e-2)``, 3 steps from
    the same weights: losses within 1e-4."""
    jm, tm = _models(True)
    rng = np.random.RandomState(7)
    x = rng.randn(8, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 10, (8,))
    v = _draw(_shapes(jm, x), 3)
    tx = optax.adam(1e-2)

    @jax.jit
    def step(params, stats, opt):
        def loss_fn(p):
            logits, upd = jm.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean(), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), stats, opt, loss

    params, stats, opt = v["params"], v["batch_stats"], tx.init(v["params"])
    want = []
    for _ in range(3):
        params, stats, opt, loss = step(params, stats, opt)
        want.append(float(loss))

    adam = AdamW(1e-2, weight_decay=0.0)
    state = port.create_train_state(tm, torch.Generator().manual_seed(0),
                                    x.shape, adam, device="cpu")
    state.update(resnet_variables_from_numpy(v, tm, "cpu"))
    state["opt_state"] = adam.init(state["params"])
    got = [port.train_step(tm, state, torch.from_numpy(x),
                           torch.from_numpy(labels), adam).item()
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert state["step"] == 3 and state["opt_state"].count == 3
    assert want[-1] < want[0]


def test_predictor_matches_jax_predictor(case, tmp_path):
    """``JaxPredictor`` on a flax checkpoint (orbax) against
    ``TorchPredictor`` on the converted one (the port's payload)."""
    from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu.train.predictor import JaxPredictor

    jm, tm = case["jm"], case["tm"]
    jck = JaxCheckpoint.from_pytree(jax.tree.map(jnp.asarray, case["v"]),
                                    str(tmp_path / "jax"))
    tck = Checkpoint.from_pytree(
        resnet_variables_from_numpy(case["v"], tm, "cpu"),
        str(tmp_path / "port"))
    batch = {"x": case["x"]}
    want = JaxPredictor.from_checkpoint(
        jck, apply_fn=lambda v, x: jm.apply(v, x, train=False),
        example_tree=case["v"]).predict(batch)["predictions"]
    pred = TorchPredictor.from_checkpoint(
        tck, apply_fn=lambda v, x: tm.apply(v, x, train=False),
        device="cpu")
    got = pred.predict(batch)["predictions"]
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want, "predictions")


def test_predictor_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default restores onto it")
    ck = Checkpoint.from_pytree({"w": torch.ones(2)}, str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPredictor.from_checkpoint(ck, apply_fn=lambda p, x: x)
