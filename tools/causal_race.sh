#!/bin/sh
# Repeat the card-only case test_kernels_match_plain_on_the_card[causal_mha]
# (f32, (1, 4, 4, 256, 256, 32), causal: the scalar forward, dQ and dK/dV
# kernels against their plain versions): 12 runs alone, then 12 beside a
# second process that keeps the card busy with bf16 GEMMs.  Each run's
# last line is printed; every failure's message (the largest error per
# output, its index, both values, the seed) is collected in
# chiprun_out/causal_race.txt and printed at the end.
#
#     sh tools/causal_race.sh        # on a machine with one NVIDIA card
out=chiprun_out/causal_race.txt
mkdir -p chiprun_out
: > $out
python3 -c "from covalent_tpu_plugin_torch.ops import _kernels; _kernels.build()"
run() {
  python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -k causal_mha -q \
    -p no:cacheprovider -rf > chiprun_out/causal_race_last.txt 2>&1
  tail -1 chiprun_out/causal_race_last.txt
  if grep -q failed chiprun_out/causal_race_last.txt; then
    echo "== $1 failure" >> $out
    grep -E "^E |FAILED" chiprun_out/causal_race_last.txt >> $out
  fi
}
for i in 1 2 3 4 5 6 7 8 9 10 11 12; do echo "alone $i $(run alone-$i)"; done
python3 -c "
import time
import torch
a = torch.randn(8192, 8192, device='cuda', dtype=torch.bfloat16)
end = time.time() + 600
while time.time() < end:
    for _ in range(50):
        a = (a @ a).clamp_(-1, 1)
    torch.cuda.synchronize()
" &
load=$!
sleep 5
for i in 1 2 3 4 5 6 7 8 9 10 11 12; do echo "loaded $i $(run loaded-$i)"; done
kill $load
cat $out
