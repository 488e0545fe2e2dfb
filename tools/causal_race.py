"""One run of the card-only case ``test_kernels_match_plain_on_the_card[causal_mha]``,
with both of its sides kept, and the comparison of many such runs.

    python3 tools/causal_race.py run LABEL DIR   # one run: DIR/LABEL.npz, prints the verdict
    python3 tools/causal_race.py compare DIR     # every run in DIR, side by side

A run computes the case as the test does (``tests/test_torch_kernels.py``:
``_run`` on the card, then on one CPU thread, both from seed 0, and
``_mismatches`` for the verdict) and saves the four outputs of each side (out, dq, dk, dv).
``compare`` holds the card's outputs of every run against the first run's,
the CPU's likewise, bit for bit, and each side's ``out`` against a float64
computation of the same function on the CPU: the side that moves between
runs, and which side strays from the exact value, are the ones to repair.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

NAMES = ("out", "dq", "dk", "dv")
CASE, SEED = "causal_mha", 0


def run(label: str, where: str) -> int:
    import torch

    from test_torch_kernels import CASES, _mismatches, _run

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _run(torch.device("cuda"), CASES[CASE], SEED)
    torch.cuda.synchronize()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the test runs the plain side
    cpu = _run("cpu", CASES[CASE], SEED)
    torch.set_num_threads(threads)
    os.makedirs(where, exist_ok=True)
    np.savez(os.path.join(where, f"{label}.npz"),
             **{f"card_{n}": a for n, a in zip(NAMES, card)},
             **{f"cpu_{n}": a for n, a in zip(NAMES, cpu)})
    failures = _mismatches(card, cpu, SEED)
    print(f"{label}: {'FAILED ' + '; '.join(failures) if failures else 'passed'}",
          flush=True)
    return 0


def _exact_out() -> np.ndarray:
    """``out`` of the case in float64 (causal softmax attention, numpy)."""
    from test_torch_kernels import CASES

    batch, heads, kv_heads, seq_q, seq_k, dim = CASES[CASE]["shape"]
    rng = np.random.default_rng(SEED)
    q, k, v = (rng.standard_normal(s, dtype=np.float32).astype(np.float64)
               for s in ((batch, heads, seq_q, dim), (batch, kv_heads, seq_k, dim),
                         (batch, kv_heads, seq_k, dim)))
    group = heads // kv_heads
    k, v = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    scores = q @ k.transpose(0, 1, 3, 2) * dim ** -0.5
    scores[..., np.triu(np.ones((seq_q, seq_k), dtype=bool), 1)] = -np.inf
    p = np.exp(scores - scores.max(axis=-1, keepdims=True))
    return (p / p.sum(axis=-1, keepdims=True)) @ v


def compare(where: str) -> int:
    runs = sorted(f for f in os.listdir(where) if f.endswith(".npz"))
    if not runs:
        print(f"no runs in {where}")
        return 1
    data = {f[:-4]: np.load(os.path.join(where, f)) for f in runs}
    first = next(iter(data))
    exact = _exact_out()
    for side in ("card", "cpu"):
        moved = {label: [float(np.abs(d[f"{side}_{n}"].astype(np.float64)
                                      - data[first][f"{side}_{n}"]).max()) for n in NAMES]
                 for label, d in data.items()}
        differ = sorted(label for label, errs in moved.items() if any(errs))
        print(f"{side}: {len(differ)} of {len(data)} runs differ from {first} bit for bit"
              + (f": {differ}" if differ else ""))
        for label in differ:
            print(f"  {label}: max abs change (out, dq, dk, dv) {moved[label]}")
        worst = max(float(np.abs(d[f"{side}_out"] - exact).max()) for d in data.values())
        print(f"  {side} out against float64: max abs error over the runs {worst}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        sys.exit(run(sys.argv[2], sys.argv[3]))
    sys.exit(compare(sys.argv[2]))
