"""The MoE's load-balance loss over a few AdamW steps, port beside reference, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/moe_aux_cpu.py [d_model] [steps]

Builds the reference's LM with 8 Switch experts (12 layers, vocab 32768,
bf16 activations, f32 weights; ``d_model`` 512 by default, ``d_ff`` 4x),
converts its initial weights into the port's, and trains both ``steps``
(5) AdamW steps at lr 3e-4 on the same 4 x 512-token batches with the
aux-aware loss (weight 0.01), printing each step's LM loss and the aux
summed over the layers for each package.  It shows whether a rising total
loss in the port's MoE training (the aux growing as the router sharpens)
is the reference's behaviour too.  Imports both packages, as the tests do.
"""

import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from covalent_tpu_plugin.models import transformer as ref_tf  # noqa: E402
from covalent_tpu_plugin.models.data import synthetic_lm_batches  # noqa: E402
from covalent_tpu_plugin.models.moe import collect_moe_aux as ref_aux  # noqa: E402
from covalent_tpu_plugin.models.train import cross_entropy_loss  # noqa: E402
from covalent_tpu_plugin_torch.models import convert, train  # noqa: E402
from covalent_tpu_plugin_torch.models import transformer as torch_tf  # noqa: E402
from covalent_tpu_plugin_torch.models.moe import collect_moe_aux  # noqa: E402

AUX_WEIGHT = 0.01


def main() -> int:
    d_model = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    common = dict(vocab_size=32768, d_model=d_model, n_layers=12, n_heads=4,
                  d_ff=4 * d_model, max_seq=512, attention="reference", moe_experts=8)
    batches = list(synthetic_lm_batches(steps, 4, 513, common["vocab_size"], seed=0))
    ref = ref_tf.TransformerLM(ref_tf.TransformerConfig(**common, dtype=jnp.bfloat16))
    params = flax.core.meta.unbox(
        ref.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["tokens"][:, :-1]))["params"])
    config = torch_tf.TransformerConfig(**common, dtype=torch.bfloat16)
    model = torch_tf.TransformerLM(config, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), config))

    tx = optax.adamw(3e-4)

    def ref_loss(p, tokens):
        logits, state = ref.apply({"params": p}, tokens[:, :-1], mutable=["intermediates"])
        lm, aux = cross_entropy_loss(logits, tokens[:, 1:]), ref_aux(state["intermediates"])
        return lm + AUX_WEIGHT * aux, (lm, aux)

    @jax.jit
    def ref_step(p, opt_state, tokens):
        (_, (lm, aux)), grads = jax.value_and_grad(ref_loss, has_aux=True)(p, tokens)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, lm, aux

    seen = []

    def port_loss(m, batch):
        lm, aux = train.lm_loss(m, batch), collect_moe_aux(m)
        seen.append((float(lm.detach()), float(aux.detach())))
        return lm + AUX_WEIGHT * aux

    port_step = train.make_train_step(model, train.adamw(model), loss_fn=port_loss)
    opt_state = tx.init(params)
    for i, batch in enumerate(batches):
        params, opt_state, lm, aux = ref_step(params, opt_state, jnp.asarray(batch["tokens"]))
        port_step(batch)
        print(f"step {i}: reference lm {float(lm):.4f} aux {float(aux):.3f}; "
              f"port lm {seen[-1][0]:.4f} aux {seen[-1][1]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
