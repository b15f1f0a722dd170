#!/usr/bin/env bash
# The accel crossover table (PERF.md): bench.py at its default shape
# (640x360, 8 spp, depth 4) with each closest-hit structure on scenes from
# ~500 to ~0.93M primitives, one bench.py process per cell, on one GPU.
# Writes one JSON line per cell to ${1:-chiprun_out/crossover.jsonl}.
#
#   bash tools/accel_crossover.sh [out.jsonl]
set -u
out=${1:-chiprun_out/crossover.jsonl}
mkdir -p "$(dirname "$out")"
cell() {  # cell <args...>: one bench.py run, its JSON line appended
  echo "== bench.py $*" >&2
  python bench.py "$@" | grep '^{' >> "$out"
}
cell --scene cornell --accel tensor
cell --scene cornell --accel pallas
for scene in random triangle; do
  for accel in tensor pallas bvh; do cell --scene "$scene" --accel "$accel"; done
done
for sub in 0 1 2; do
  for accel in tensor pallas bvh; do
    cell --scene bunny --subdivide "$sub" --accel "$accel" --iters 2
  done
done
# ~0.93M triangles: the dense sweeps are O(rays x prims) — one timed run
# of the Triton sweep, none of the XLA one (~16x its sub-2 time)
cell --scene bunny --subdivide 4 --accel pallas --iters 1
cell --scene bunny --subdivide 4 --accel bvh --iters 2
cell  # the default: bunny, accel=auto
