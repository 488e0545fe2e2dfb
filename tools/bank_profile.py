"""Profile decode steps of the ``adapters`` phase's engine, one configuration
at a time, on one card.

    python3 tools/bank_profile.py [lines.jsonl]
    python3 tools/bank_profile.py --cpu     # a tiny model on the CPU (a check of the script)

The 125M LM (bf16 weights from seed 0) behind a ``ContinuousEngine`` of 8
slots, ``sync_steps`` 8, with 8 requests of 128 prompt tokens in decode,
under five configurations:

* ``plain``: no decode modes, no bank; every row fp;
* ``bank``: a bank of two seeded adapters (rank 16); rows base, a, b in turn;
* ``modes``: ``decode_modes`` fp, int8, kv_quant and full_quant, two rows
  each, no bank;
* ``modes_bank``: both, rows of every mode and adapter (the adapters phase's
  session, cut to one wave);
* ``int8``: ``decode_modes`` fp and int8, every row int8.

For each: host ms per decode step (the wall of three chunks, synchronised,
over their steps), device ms per step (the profiler's kernel time over one
chunk), the device's busy share (device over host), kernels launched per
step, and the serving kernels' launches per step by route.  Prints the card
and one line per configuration, and writes them to ``lines.jsonl`` when a
path is given.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SLOTS, SYNC, PROMPT, NEW_TOKENS, TIMED_CHUNKS = 8, 8, 128, 128, 3
CONFIGS = {
    "plain": dict(modes=("fp",), bank=False, rows=lambda i: ("fp", "")),
    "bank": dict(modes=("fp",), bank=True, rows=lambda i: ("fp", ("", "a", "b")[i % 3])),
    "modes": dict(modes=cs.ADAPTER_MODES, bank=False,
                  rows=lambda i: (cs.ADAPTER_MODES[i % 4], "")),
    "modes_bank": dict(modes=cs.ADAPTER_MODES, bank=True,
                       rows=lambda i: (cs.ADAPTER_MODES[i % 4], ("", "a", "b")[i % 3])),
    "int8": dict(modes=("fp", "int8"), bank=False, rows=lambda i: ("int8", "")),
}


def profile_config(name: str, base, device: str) -> dict:
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import serve
    from covalent_tpu_plugin_torch.ops import _kernels

    spec = CONFIGS[name]
    config = base.config
    adapters = ({"a": cs.seeded_adapter(config, 1), "b": cs.seeded_adapter(config, 2)}
                if spec["bank"] else None)
    engine = serve.ContinuousEngine(base, max_batch=SLOTS, sync_steps=SYNC,
                                    max_new_tokens=NEW_TOKENS, decode_modes=spec["modes"],
                                    adapters=adapters,
                                    adapter_rank=cs.LORA_RANK if spec["bank"] else None)
    rng = np.random.default_rng(1)
    rows = []
    for i in range(SLOTS):
        mode, adapter = spec["rows"](i)
        params = {"max_new_tokens": NEW_TOKENS, "quality": mode}
        if adapter:
            params["adapter"] = adapter
        rows.append(f"{mode}/{adapter or 'base'}")
        engine.admit(str(i), rng.integers(0, config.vocab_size, PROMPT), params)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.no_grad():
        engine.step()  # the admission waves and a first chunk
        engine.step()
        sync()
        start = time.perf_counter()
        for _ in range(TIMED_CHUNKS):
            engine.step()
        sync()
        host_ms = (time.perf_counter() - start) * 1e3 / (TIMED_CHUNKS * SYNC)
        device_ms = kernels = None
        if cuda:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(
                    activities=acts,
                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
                engine.step()
                sync()
                prof.step()
                _kernels.reset_launch_counts()
                engine.step()
                sync()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
            device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / SYNC
            kernels = len(events) / SYNC
        else:
            _kernels.reset_launch_counts()
            engine.step()
        launches = {k: v / SYNC for k, v in _kernels.serving_launch_counts().items() if v}
    busy = engine.busy
    engine.close()
    return {"config": name, "decode_modes": list(spec["modes"]), "bank": spec["bank"],
            "rows": rows, "rows_live": busy, "slots": SLOTS, "sync_steps": SYNC,
            "host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms and device_ms / host_ms,
            "kernels_per_step": kernels, "serving_launches_per_step": launches,
            "tokens_per_s": SLOTS * 1e3 / host_ms}


def main() -> int:
    import torch

    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("bank_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from covalent_tpu_plugin_torch.models import decode
    from covalent_tpu_plugin_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_125m_config)

    device = "cpu" if cpu else "cuda"
    if cpu:
        config = TransformerConfig(**{**cs.SERVE_TINY, "max_seq": PROMPT + NEW_TOKENS + SYNC})
    else:
        from covalent_tpu_plugin_torch.ops import _kernels

        _kernels.build()
        config = lm_125m_config(max_seq=512)
        print(cs.nvidia_smi(), flush=True)
    base = decode.inference_params(TransformerLM(
        config, device=device, generator=torch.Generator(device=device).manual_seed(0)))
    lines = []
    for name in CONFIGS:
        line = profile_config(name, base, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args:
        with open(args[0], "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
