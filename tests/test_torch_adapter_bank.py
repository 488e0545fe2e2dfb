"""The serving engine's multi-adapter bank and decode-mode lane groups
against the reference's, on the CPU.

One tiny float32 LM (2 layers, d_model 64, 4 heads, a 256 vocabulary, its
lm_head scaled by 10 so greedy steps have clear margins) on both sides, the
port's weights converted from the reference's, and adapters made by the
reference (``add_lora`` with random non-zero ``lora_b``) in its wire form.
The engine contract is exactness (reference ``tests/test_multiadapter.py:
174-266``): a lane under adapter X in the bank streams the tokens of an
engine serving base + X alone, a base lane those of an engine without a
bank; the hot swap, the adapter-scoped prefix tree and the KV bundles'
adapter identity keep it.  Streams are also held token for token to the
reference's bank engine on the same requests.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import lora as jax_lora
from covalent_tpu_plugin.models import serve as jax_serve
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.resilience import FaultClass, classify_error
from covalent_tpu_plugin.serving import registry as jax_registry
from covalent_tpu_plugin_torch.models import convert, lora, quant, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.serving import registry

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=48)
RANK = 2
PROMPTS = [np.arange(1, 9, dtype=np.int32) * (i + 3) % 256 for i in range(4)]
ENGINE = dict(max_batch=4, sync_steps=4, max_new_tokens=8, length=40)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_tf.TransformerConfig(**TINY, dtype=jnp.float32, attention="reference",
                                    scan_layers=False)
    tcfg = torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference")
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, model, tcfg


def make_adapter(lm, seed):
    """A "fine-tuned" adapter of the reference: non-zero A and B.  Returns
    its wire form, the reference's LoRA model and params, and the port's
    LoRA model holding it (the single-adapter oracle)."""
    jmodel, params, _, tcfg = lm
    lmodel, lparams = jax_lora.add_lora(jmodel, params, rank=RANK)
    mask = jax.tree_util.tree_leaves(jax_lora.lora_mask(lparams))
    leaves, treedef = jax.tree_util.tree_flatten(lparams)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.3)
              if m else leaf for leaf, m in zip(leaves, mask)]
    lparams = jax.tree_util.tree_unflatten(treedef, leaves)
    port = torch_tf.TransformerLM(dataclasses.replace(tcfg, lora_rank=RANK), device="cpu")
    port.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, lparams), port.config))
    wire = [np.asarray(leaf) for leaf in jax_lora.adapter_leaves(lparams)]
    return wire, lmodel, lparams, port


def drain(engine, streams):
    while engine.busy:
        for event in engine.step():
            streams.setdefault(event["rid"], []).extend(event["tokens"])
    return streams


def single(model, prompt, cap=8, **kwargs):
    engine = serve.ContinuousEngine(model, **{**ENGINE, **kwargs})
    engine.admit("x", prompt, {"max_new_tokens": cap})
    out = drain(engine, {})["x"]
    engine.close()
    return out


@pytest.fixture(scope="module")
def adapters(lm):
    return {name: make_adapter(lm, seed) for name, seed in (("a", 1), ("b", 2), ("a2", 7))}


def test_bank_lanes_equal_single_adapter_engines_and_the_reference(lm, adapters):
    jmodel, params, model, _ = lm
    oracle = {"base": single(model, PROMPTS[0]),
              "a": single(adapters["a"][3], PROMPTS[1]),
              "b": single(adapters["b"][3], PROMPTS[2])}
    assert oracle["a"] != single(model, PROMPTS[1])  # the adapter changes the stream
    mux = serve.ContinuousEngine(model, **ENGINE,
                                 adapters={"a": adapters["a"][0], "b": adapters["b"][0]})
    assert mux.adapters == ("a", "b")
    assert mux.adapter_digests == {n: lora.adapter_digest(adapters[n][0]) for n in "ab"}
    for rid, prompt, name in (("base", PROMPTS[0], ""), ("a", PROMPTS[1], "a"),
                              ("b", PROMPTS[2], "b")):
        mux.admit(rid, prompt, {"adapter": name} if name else {})
    streams = drain(mux, {})
    assert streams == oracle
    assert mux.stats["adapter_requests_a"] == mux.stats["adapter_requests_b"] == 1
    assert mux.stats["adapter_tokens_a"] == 8 and mux.stats["adapter_tokens_base"] == 8
    # the reference's bank engine on the same requests
    ref = jax_serve.ContinuousEngine(jmodel, params, **ENGINE,
                                     adapters={"a": adapters["a"][0], "b": adapters["b"][0]})
    for rid, prompt, name in (("base", PROMPTS[0], ""), ("a", PROMPTS[1], "a"),
                              ("b", PROMPTS[2], "b")):
        ref.admit(rid, prompt, {"adapter": name} if name else {})
    assert drain(ref, {}) == streams
    # an unknown adapter refuses at admission, PERMANENT, no lane taken
    with pytest.raises(ValueError, match="unknown adapter") as info:
        mux.admit("x", PROMPTS[0], {"adapter": "ghost"})
    assert classify_error(info.value)[0] is FaultClass.PERMANENT
    assert mux.busy == 0
    mux.close()


def test_hot_swap_keeps_the_old_generation_in_flight(lm, adapters):
    _, _, model, _ = lm
    old = single(adapters["a"][3], PROMPTS[1], cap=12)
    new = single(adapters["a2"][3], PROMPTS[1], cap=12)
    mux = serve.ContinuousEngine(model, **ENGINE, adapters={"a": adapters["a"][0]})
    mux.admit("old", PROMPTS[1], {"adapter": "a", "max_new_tokens": 12})
    streams: dict = {}
    for _ in range(2):
        for event in mux.step():
            streams.setdefault(event["rid"], []).extend(event["tokens"])
    digest = mux.attach_adapter("a", adapters["a2"][0])
    assert digest == lora.adapter_digest(adapters["a2"][0])
    mux.admit("new", PROMPTS[1], {"adapter": "a", "max_new_tokens": 12})
    drain(mux, streams)
    assert streams["old"] == old and streams["new"] == new
    assert mux.stats["adapter_swaps"] == 1 and mux.stats["adapter_attaches"] == 1
    # the retired slot is reclaimed once its lane finished
    mux.step()
    assert len(mux._adapter_free) == mux._adapters_max - 1
    mux.detach_adapter("a")
    assert mux.adapters == () and mux.stats["adapter_detaches"] == 1
    with pytest.raises(ValueError, match="unknown adapter"):
        mux.admit("gone", PROMPTS[1], {"adapter": "a"})
    with pytest.raises(ValueError, match="unknown adapter"):
        mux.detach_adapter("a")
    mux.close()


def test_prefix_tree_is_scoped_by_adapter(lm, adapters):
    _, _, model, _ = lm
    long_prompt = np.arange(1, 12, dtype=np.int32)
    oracle_b = single(adapters["b"][3], long_prompt, cap=6)
    mux = serve.ContinuousEngine(model, **{**ENGINE, "prefix_min_tokens": 3},
                                 adapters={"a": adapters["a"][0], "b": adapters["b"][0]})
    mux.admit("pa", long_prompt, {"adapter": "a", "max_new_tokens": 6})
    drain(mux, {})
    mux.admit("pb", long_prompt, {"adapter": "b", "max_new_tokens": 6})
    streams = drain(mux, {})
    assert mux.stats["adapter_prefix_blocked"] >= 1 and mux.stats["prefix_hits"] == 0
    assert streams["pb"] == oracle_b
    # the same adapter reuses its own lane
    mux.admit("pb2", long_prompt, {"adapter": "b", "max_new_tokens": 6})
    assert drain(mux, {})["pb2"] == oracle_b and mux.stats["prefix_hits"] == 1
    mux.close()


def test_kv_bundles_carry_the_adapter_identity(lm, adapters):
    _, _, model, _ = lm
    oracle = single(adapters["a"][3], PROMPTS[3])
    bank = {"a": adapters["a"][0]}
    prefill = serve.ContinuousEngine(model, **ENGINE, adapters=bank)
    bundle = prefill.prefill_only(PROMPTS[3], {"adapter": "a"})
    decoded = __import__("pickle").loads(bundle)
    assert decoded["adapter"] == "a" and decoded["quant"] == "fp"
    assert decoded["adapter_digest"] == lora.adapter_digest(adapters["a"][0])
    decode = serve.ContinuousEngine(model, **ENGINE, adapters=bank)
    decode.admit_from_kv("r", bundle, {"max_new_tokens": 8})
    assert drain(decode, {})["r"] == oracle
    # a superseded generation, a name not hosted, an engine without a bank
    decode.attach_adapter("a", adapters["a2"][0])
    with pytest.raises(ValueError, match="stale bundle"):
        decode.admit_from_kv("r2", bundle)
    other = serve.ContinuousEngine(model, **ENGINE, adapters={"b": adapters["b"][0]})
    with pytest.raises(ValueError, match="unknown adapter"):
        other.admit_from_kv("r3", bundle)
    with pytest.raises(ValueError, match="no adapter bank"):
        serve.ContinuousEngine(model, **ENGINE).admit_from_kv("r4", bundle)


def test_quality_routes_to_lane_groups_and_refusals_fall_back_to_fp(lm, adapters):
    jmodel, params, model, _ = lm
    engine = serve.ContinuousEngine(model, **ENGINE,
                                    decode_modes=("fp", "int8", "kv_quant", "full_quant"))
    assert engine.decode_modes == ("fp", "int8", "kv_quant", "full_quant")
    for i, quality in enumerate((None, "exact", "fp", "int8", "kv_quant", "full_quant",
                                 "int4")):
        engine.admit(f"r{i}", PROMPTS[i % 4], {} if quality is None else {"quality": quality})
        if engine.busy == engine.slots:
            drain(engine, {})
    streams = drain(engine, {})
    assert engine.stats["mode_refusals"] == 1  # "int4"
    assert engine.stats["mode_tokens_int8"] == engine.stats["mode_tokens_kv_quant"] == 8
    # each group streams what an engine over its model twin streams alone
    for mode, rid, prompt in (("int8", "r3", PROMPTS[3]), ("kv_quant", "r4", PROMPTS[0]),
                              ("full_quant", "r5", PROMPTS[1])):
        assert streams.get(rid, []) == single(quant.mode_variant(model, mode), prompt) or \
            rid not in streams
    # and the reference's engine routes the same requests the same way
    ref = jax_serve.ContinuousEngine(jmodel, params, **ENGINE,
                                     decode_modes=("fp", "int8", "kv_quant"))
    ours = serve.ContinuousEngine(model, **ENGINE, decode_modes=("fp", "int8", "kv_quant"))
    for engine_ in (ref, ours):
        for i, quality in enumerate(("fp", "int8", "kv_quant", "bogus")):
            engine_.admit(f"q{i}", PROMPTS[i], {"quality": quality})
    assert drain(ours, {}) == drain(ref, {})
    assert ours.stats["mode_refusals"] == ref.stats["mode_refusals"] == 1


def test_a_refused_mode_is_recorded_and_serves_fp_bit_exact():
    """A model that carries adapters has no int8 twin (``quantize_lm``
    refuses it, as an MoE model): the mode is refused at build, recorded, and
    its requests run on the fp lane, token for token."""
    tcfg = torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference")
    model = torch_tf.TransformerLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    lmodel = lora.add_lora(model, RANK)
    engine = serve.ContinuousEngine(lmodel, **ENGINE, decode_modes=("fp", "int8"))
    assert engine.decode_modes == ("fp",) and "int8" in engine._mode_refusal
    assert engine.stats["mode_refusals"] == 1
    engine.admit("q", PROMPTS[0], {"quality": "int8"})
    assert drain(engine, {})["q"] == single(lmodel, PROMPTS[0])
    assert engine.stats["mode_refusals"] == 2


def test_modes_and_bank_compose_as_quantize_then_lora(lm, adapters):
    _, _, model, tcfg = lm
    wire = adapters["a"][0]
    qlora = torch_tf.TransformerLM(dataclasses.replace(tcfg, lora_rank=RANK, quantized=True),
                                   device="cpu")
    qlora.load_state_dict({**quant.quantize_lm(model).state_dict(),
                           **lora.adapter_state(lora.add_lora(model, RANK), wire)})
    oracle = single(qlora, PROMPTS[2])
    engine = serve.ContinuousEngine(model, **ENGINE, decode_modes=("fp", "int8"),
                                    adapters={"a": wire})
    engine.admit("q", PROMPTS[2], {"adapter": "a", "quality": "int8"})
    assert drain(engine, {})["q"] == oracle
    engine.attach_adapter("b", adapters["b"][0])
    assert engine.group("int8").adapters == ("a", "b")
    engine.detach_adapter("b")
    assert engine.group("int8").adapters == ("a",)


def test_bank_refusals_are_typed_and_permanent(lm, adapters):
    _, _, model, _ = lm
    wire = adapters["a"][0]
    lmodel = adapters["a"][3]
    cases = [
        (lambda: serve.ContinuousEngine(lmodel, adapters={"a": wire}), "already carries"),
        (lambda: serve.ContinuousEngine(model, adapters={}), "adapter_rank"),
        (lambda: serve.ContinuousEngine(model, adapters={"a": wire}, adapter_rank=3),
         "rank or geometry"),
        (lambda: serve.ContinuousEngine(model, adapters={"a": wire, "b": wire},
                                        adapters_max=1), "exceed"),
        (lambda: serve.ContinuousEngine(model, adapters={"base": wire}), "reserved"),
        (lambda: serve.ContinuousEngine(model, adapter_rank=RANK).attach_adapter(
            "a", wire[:-1]), "leaves"),
        (lambda: serve.ContinuousEngine(model).attach_adapter("a", wire), "no adapter bank"),
    ]
    for call, match in cases:
        with pytest.raises(serve.AdapterUnsupported, match=match) as refusal:
            call()
        assert classify_error(refusal.value) == (FaultClass.PERMANENT,
                                                 "serve_model_unsupported")
    full = serve.ContinuousEngine(model, adapters={"a": wire}, adapters_max=1)
    with pytest.raises(serve.AdapterUnsupported, match="full"):
        full.attach_adapter("b", wire)


def test_a_bundle_packed_by_the_reference_installs_into_the_port(lm, adapters, tmp_path):
    """The reference's registry packs the wire form; the port's engine
    installs the bundle and its digest is the reference's content digest;
    the port's own bundle reads back in the reference's registry."""
    _, _, model, _ = lm
    wire = adapters["b"][0]
    data = jax_registry.pack_adapter(wire, name="b", rank=RANK)
    bundle = registry.unpack_adapter(data)
    assert bundle["digest"] == jax_registry.adapter_content_digest(wire)
    assert bundle["digest"] == registry.adapter_content_digest(wire) == lora.adapter_digest(wire)
    engine = serve.ContinuousEngine(model, **ENGINE, adapter_rank=RANK)
    assert engine.attach_adapter("b", bundle) == bundle["digest"]
    engine.admit("r", PROMPTS[2], {"adapter": "b"})
    assert drain(engine, {})["r"] == single(adapters["b"][3], PROMPTS[2])
    ours = registry.pack_adapter(wire, name="b")
    assert jax_registry.unpack_adapter(ours)["digest"] == bundle["digest"]
    book = registry.AdapterRegistry(str(tmp_path))
    record = book.put("b", data)
    assert record["content"] == bundle["digest"] and record["rank"] == RANK
    assert book.get("b")["path"].endswith(".lora") and book.digests() == {"b": bundle["digest"]}
    with pytest.raises(ValueError, match="version"):
        registry.unpack_adapter(__import__("cloudpickle").dumps({"v": 2, "leaves": []}))
