#!/bin/bash
# The chaos, soak and end-to-end benches on one GPU, each at the root
# benches' defaults, then the two arms at BASELINE config 2's element count
# (N = 3,870,976), each under its own time limit. Run from the repo root:
#
#   bash shared_tensor_tpu_torch/benchmarks/card_runs.sh OUT [RUN ...]
#
# OUT gets each run's JSON document, stdout (RUN.out) and stderr (RUN.err);
# one line a run ("RUN rc=... N s") goes to stdout. With no RUN, every run
# below, in order. Builds the kernels, the engine and the C peer first.
set -u
O=${1:?usage: card_runs.sh OUT [RUN ...]}
shift
mkdir -p "$O"
M=shared_tensor_tpu_torch.benchmarks
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import shared_tensor_tpu_torch._build as B, shared_tensor_tpu_torch.ops.codec_cuda as CC; CC.build(); B.build_engine(); B.build_harness()' \
  > "$O/build.log" 2>&1 || { echo build failed; tail "$O/build.log"; exit 1; }

cmd() {  # the time limit and command of a run
  case $1 in
    cc_base) echo 300 python -m $M.cluster_chaos "$O/CHAOS_base.json" ;;
    cc_subs) echo 300 python -m $M.cluster_chaos "$O/CHAOS_subs.json" --subscribers 2 ;;
    cc_stripes) echo 300 python -m $M.cluster_chaos "$O/CHAOS_stripes.json" --stripes 4 ;;
    cc_shm) echo 300 python -m $M.cluster_chaos "$O/CHAOS_shm.json" --shm ;;
    cc_sharded) echo 400 python -m $M.cluster_chaos "$O/CHAOS_sharded.json" --sharded ;;
    cc_base_full) echo 600 env ST_CLUSTER_N=3870976 python -m $M.cluster_chaos "$O/CHAOS_base_full.json" ;;
    chaos_soak) echo 600 python -m $M.chaos_soak --out "$O/CHAOS_SOAK.json" ;;
    # the python arm alone at config 2's width: on the card's device tier,
    # and on the Python host tier (the same schedule on the CPU's codec)
    chaos_soak_full) echo 600 env ST_CHAOS_ARMS=python ST_CHAOS_N=3870976 \
      python -m $M.chaos_soak --out "$O/CHAOS_SOAK_full.json" ;;
    chaos_soak_full_host) echo 600 env ST_CHAOS_ARMS=python ST_CHAOS_N=3870976 \
      python -m $M.chaos_soak --device cpu --out "$O/CHAOS_SOAK_full_host.json" ;;
    e2e_sync) echo 300 python -m $M.e2e_sync ;;
    e2e_artifact) echo 900 python -m $M.e2e_artifact ;;
    adaptive_ab) echo 600 python -m $M.adaptive_ab ;;
    soak) echo 600 python -m $M.soak ;;
    soak_crash) echo 400 env ST_SOAK_SECONDS=120 ST_SOAK_CRASH=1 python -m $M.soak ;;
    soak_compat) echo 400 env ST_SOAK_SECONDS=120 ST_SOAK_COMPAT=1 python -m $M.soak ;;
    # the soak with the shared-memory lane off: every link on TCP
    soak_noshm) echo 600 env ST_SHM=0 python -m $M.soak ;;
    soak_crash_noshm) echo 400 env ST_SHM=0 ST_SOAK_SECONDS=120 ST_SOAK_CRASH=1 python -m $M.soak ;;
    engine_sweep) echo 900 python -m $M.engine_sweep "$O/ENGINE_SWEEP.json" ;;
    drain_tail) echo 300 python -m $M.drain_tail ;;
    # phase 20a of chip_smoke.py with its child started early and late
    phase20_cost) echo 300 python chip_smoke.py --phase20-cost ;;
    *) return 1 ;;
  esac
}

ALL="cc_base cc_subs cc_stripes cc_shm cc_sharded cc_base_full chaos_soak chaos_soak_full chaos_soak_full_host
     e2e_sync e2e_artifact adaptive_ab soak soak_crash soak_compat soak_noshm soak_crash_noshm engine_sweep drain_tail
     phase20_cost"
for name in ${@:-$ALL}; do
  c=$(cmd "$name") || { echo "$name: no such run"; exit 2; }
  t0=$(date +%s)
  # shellcheck disable=SC2086
  timeout $c > "$O/$name.out" 2> "$O/$name.err"
  echo "$name rc=$? $(( $(date +%s) - t0 )) s"
done
