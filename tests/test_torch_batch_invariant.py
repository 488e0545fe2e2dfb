"""The serving paths' batch-invariant route, on the CPU, against the reference.

The serving entry points (``generate``, ``continuous_generate``,
``ContinuousEngine``) route the model's dense products, its decode
attention's two products and its RMSNorms through
``ops/batch_invariant.py``; on CPU tensors that module takes the plain
versions, which make the casts the library products make.  Here the route
is held against the reference: token for token (where the reference's
top-2 margin exceeds 1e-4 at every step) on the tiny float32 LM of
``tests/test_torch_serve.py``, whose port weights are converted from the
reference's, and bit for bit against the same model with the route off.
Training keeps the library products.  The kernels themselves run only on
the card: ``tests/test_torch_kernels.py`` holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import torch

from covalent_tpu_plugin.models import decode as jax_decode
from covalent_tpu_plugin.models import serve as jax_serve
from covalent_tpu_plugin_torch.models import decode, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.models.train import make_train_step, adamw, lm_loss

from .test_torch_serve import CAPS, MARGIN, TINY, _prompts, lm  # noqa: F401

ROUTED = (torch_tf.Dense, torch_tf.RMSNorm, torch_tf.Attention)


def _routes(model) -> set:
    return {m.batch_invariant for m in model.modules() if isinstance(m, ROUTED)}


def _fresh(lm_fixture) -> torch_tf.TransformerLM:
    """A copy of the fixture's model with the route off."""
    model = lm_fixture[2]
    copy = torch_tf.TransformerLM(model.config, device="cpu")
    copy.load_state_dict(model.state_dict())
    return copy


def test_continuous_generate_turns_the_route_on_and_matches_the_reference(lm):
    jmodel, params, _, margins = lm
    model = _fresh(lm)
    assert _routes(model) == {False}
    prompts = _prompts(len(CAPS), 21)
    want = jax_serve.continuous_generate(jmodel, params, prompts, CAPS, max_batch=3,
                                         sync_steps=2)
    assert margins(prompts, want).min() > MARGIN
    got = serve.continuous_generate(model, prompts, CAPS, max_batch=3, sync_steps=2)
    assert _routes(model) == {True}
    assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in want]


def test_generate_and_the_engine_on_the_route_match_the_reference(lm):
    jmodel, params, _, margins = lm
    prompts = np.stack(_prompts(4, 22)[:1] * 3)  # one prompt length: a batch
    prompts[1, -1] = (prompts[1, -1] + 1) % TINY["vocab_size"]
    prompts[2, 0] = (prompts[2, 0] + 7) % TINY["vocab_size"]
    want = np.asarray(jax_decode.generate(jmodel, params, jnp.asarray(prompts), 10))
    assert margins(list(prompts), list(want)).min() > MARGIN
    model = _fresh(lm)
    got = decode.generate(model, prompts, 10)
    assert _routes(model) == {True}
    assert got.tolist() == want.tolist()
    engine = serve.ContinuousEngine(_fresh(lm), max_batch=2, sync_steps=3,
                                    max_new_tokens=10)
    assert _routes(engine._model) == {True}
    queue, streams = list(enumerate(prompts)), {}
    while queue or engine.busy:
        while queue and engine.busy < engine.slots:
            i, p = queue.pop(0)
            engine.admit(str(i), p, {"max_new_tokens": 10})
        for event in engine.step():
            streams.setdefault(int(event["rid"]), []).extend(event["tokens"])
    assert [streams[i] for i in range(len(prompts))] == \
        [row[prompts.shape[1]:].tolist() for row in want]


def test_plain_versions_equal_the_library_products_bit_for_bit(lm):
    """On the CPU the route changes no bit: prefill and decode logits with
    the route on equal those with it off."""
    off, on = _fresh(lm), torch_tf.use_batch_invariant(_fresh(lm))
    tokens = torch.as_tensor(np.stack(_prompts(4, 23)[:1] * 2), dtype=torch.long)
    with torch.no_grad():
        caches = [decode.init_cache(m, 2) for m in (off, on)]
        pre = [m(tokens, cache=c) for m, c in zip((off, on), caches)]
        step = [m(p[:, -1:].argmax(-1), cache=c) for m, p, c in zip((off, on), pre, caches)]
        full = [m(tokens) for m in (off, on)]
    for a, b in (pre, step, full):
        assert torch.equal(a, b)


def test_training_keeps_the_library_products(lm):
    model = _fresh(lm)
    step = make_train_step(model, adamw(model), loss_fn=lambda m, b: lm_loss(m, b))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, TINY["vocab_size"], (2, 9)).astype(np.int32)}
    metrics = step(batch)
    assert np.isfinite(float(metrics["loss"]))
    assert _routes(model) == {False}
