#!/bin/sh
# Repeat the card-only case test_kernels_match_plain_on_the_card[causal_mha]
# (f32, (1, 4, 4, 256, 256, 32), causal: the scalar forward, dQ and dK/dV
# kernels against their plain versions): 12 runs alone, then 12 beside a
# second process that keeps the card busy with bf16 GEMMs.  Each run is a
# fresh interpreter that computes the case as the test does and saves both
# sides (tools/causal_race.py run); its verdict is printed, and every
# failure's message (the largest error per output, its index, both values,
# the seed) is collected in chiprun_out/causal_race.txt and printed at the
# end.  Then the runs are compared card with card and CPU with CPU, bit for
# bit, and each side's output with a float64 computation
# (tools/causal_race.py compare).
#
#     sh tools/causal_race.sh        # on a machine with one NVIDIA card
out=chiprun_out/causal_race.txt
runs=chiprun_out/causal_race
mkdir -p chiprun_out
rm -rf $runs
: > $out
python3 -c "from covalent_tpu_plugin_torch.ops import _kernels; _kernels.build()"
run() {
  python3 tools/causal_race.py run $1 $runs > chiprun_out/causal_race_last.txt 2>&1
  tail -1 chiprun_out/causal_race_last.txt
  if grep -q FAILED chiprun_out/causal_race_last.txt; then
    echo "== $1 failure" >> $out
    cat chiprun_out/causal_race_last.txt >> $out
  fi
}
for i in 01 02 03 04 05 06 07 08 09 10 11 12; do echo "alone $i $(run alone-$i)"; done
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
for i in 01 02 03 04 05 06 07 08 09 10 11 12; do echo "loaded $i $(run loaded-$i)"; done
kill $load
cat $out
python3 tools/causal_race.py compare $runs
