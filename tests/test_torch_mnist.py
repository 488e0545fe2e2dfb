"""The port's MNIST models, classifier loss and Adam step against the JAX
package, on the CPU.

The same numpy inputs go through the reference (Flax + optax) and the port;
the port's weights are the reference's params converted with
``models/convert.py``.  Tolerances: float32 logits at 1e-5 (MLP) and 1e-4
(CNN, whose convolutions sum 288 products a pixel in another order); the
cross-entropy on identical logits at 1e-6; the losses of 5 Adam steps at
rtol 1e-4, where the two optimizers' roundings compound over the steps.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from covalent_tpu_plugin.models import mlp as ref_mlp
from covalent_tpu_plugin.models.train import classifier_loss as ref_classifier_loss
from covalent_tpu_plugin_torch.models import (
    MLP,
    MnistCNN,
    adam,
    classifier_loss,
    cnn_params_from_jax,
    cross_entropy_loss,
    make_classifier_train_step,
    mlp_params_from_jax,
    synthetic_mnist,
    train_mnist,
)

#: name -> (reference model, port model, converter, logits tolerance)
MODELS = {
    "mlp": (ref_mlp.MLP, MLP, mlp_params_from_jax, 1e-5),
    "cnn": (ref_mlp.MnistCNN, MnistCNN, cnn_params_from_jax, 1e-4),
}


def _pair(name: str, seed: int = 0):
    """The reference model with fresh params and the port's model holding
    the same params."""
    ref_cls, cls, convert, tol = MODELS[name]
    ref_model = ref_cls()
    sample = ref_mlp.synthetic_mnist(2, seed=seed)["image"]
    params = ref_model.init(jax.random.PRNGKey(seed), sample)["params"]
    model = cls(device="cpu", generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(convert(jax.tree.map(np.asarray, params)))
    return ref_model, params, model, tol


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_synthetic_mnist_is_byte_equal_to_the_reference(seed, flat):
    want = ref_mlp.synthetic_mnist(16, seed=seed, flat=flat)
    got = synthetic_mnist(16, seed=seed, flat=flat)
    assert sorted(got) == sorted(want) == ["image", "label"]
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes()
    assert got["image"].shape == ((16, 784) if flat else (16, 28, 28, 1))


@pytest.mark.parametrize("name,flat", [("mlp", False), ("mlp", True), ("cnn", False)])
def test_logits_match_the_reference_on_converted_weights(name, flat):
    ref_model, params, model, tol = _pair(name, seed=3)
    images = synthetic_mnist(8, seed=11, flat=flat)["image"]
    want = np.asarray(ref_model.apply({"params": params}, images))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (8, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_cross_entropy_matches_the_optax_expression():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((64, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits).astype(jnp.float32), jnp.asarray(labels)).mean()
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_classifier_loss_matches_the_reference(name):
    ref_model, params, model, tol = _pair(name, seed=5)
    batch = synthetic_mnist(16, seed=2)
    want = ref_classifier_loss(params, ref_model.apply, batch)
    with torch.no_grad():
        got = classifier_loss(model, batch)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)


def test_classifier_loss_takes_tensors_on_the_models_device():
    """``train_mnist`` keeps its batches on the card: the loss must take
    them there without a host round trip (the meta device stands in)."""
    model = MLP(device="meta")
    batch = {"image": torch.empty(4, 28, 28, 1, device="meta"),
             "label": torch.zeros(4, dtype=torch.int32, device="meta")}
    loss = classifier_loss(model, batch)
    assert loss.device.type == "meta" and loss.dim() == 0


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_five_adam_steps_match_optax(name):
    ref_model, params, model, _ = _pair(name, seed=1)
    batches = [synthetic_mnist(32, seed=100 + i) for i in range(5)]
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_classifier_loss(p, ref_model.apply, b)))
    want = []
    for batch in batches:
        loss, grads = grad_fn(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    step = make_classifier_train_step(model, adam(model))
    got = [float(step(batch)["loss"]) for batch in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_train_mnist_cpu_arm_loss_falls(name):
    """The reference's CPU tier of the ``mnist`` arm: 24 batches of 128."""
    out = train_mnist(name, batch_size=128, n_batches=24, epochs=1, device="cpu")
    assert len(out["losses"]) == 24 and np.all(np.isfinite(out["losses"]))
    assert out["loss_last"] < out["loss_first"]
    assert out["loss_first"] == pytest.approx(np.mean(out["losses"][:4]))
    assert np.isfinite(out["loss_final_epoch"]) and out["steps_per_s"] > 0
    assert out["device"] == "cpu" and out["peak_mem_bytes"] is None
    assert not any(out["launches"].values())  # no flash kernel on this path


def test_train_mnist_refuses_an_unknown_model():
    with pytest.raises(ValueError, match="model must be one of"):
        train_mnist("resnet", device="cpu")


@pytest.mark.parametrize("name,shape", [
    ("mlp", (4, 28, 28, 3)), ("mlp", (4, 14, 14, 1)),
    ("cnn", (4, 28, 28, 3)), ("cnn", (4, 784)), ("cnn", (4, 14, 14, 1)),
])
def test_wrong_input_shapes_are_refused_as_the_reference_refuses_them(name, shape):
    ref_model, params, model, _ = _pair(name)
    bad = np.zeros(shape, np.float32)
    with pytest.raises(flax.errors.ScopeParamShapeError):
        ref_model.apply({"params": params}, bad)
    with pytest.raises(ValueError, match='For parameter "weight"'):
        model(torch.from_numpy(bad))


def test_wrong_labels_are_refused_as_the_reference_refuses_them():
    logits = np.zeros((4, 10), np.float32)
    float_labels = np.zeros(4, np.float32)
    with pytest.raises(AssertionError, match="expected"):  # chex, in optax
        optax.softmax_cross_entropy_with_integer_labels(logits, float_labels)
    with pytest.raises(TypeError, match="labels must be integers"):
        cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(float_labels))
    short = np.zeros(5, np.int32)
    with pytest.raises(ValueError):
        optax.softmax_cross_entropy_with_integer_labels(logits, short)
    with pytest.raises(ValueError):
        cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(short))


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mnist("cnn")
