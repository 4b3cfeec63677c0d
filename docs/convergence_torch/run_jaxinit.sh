#!/usr/bin/env bash
# The convergence runs from fresh models drawn from the JAX package's
# initialisers (truncated LeCun-normal kernels, zero biases), on one GPU, to
# set beside the JAX artifacts of docs/convergence/ and the earlier port runs
# of this directory, whose fresh models were PyTorch's default init:
#
#   _jaxinit                240x320, batch 128, 200 epochs, seed 42     (section 2)
#   _jaxinit_s43            the same at seed 43 (another val split too)
#   _jaxinit_fast           96x128, batch 256, 200 epochs              (section 3)
#   _jaxinit_prog_naive     12 epochs at 240x320 from _jaxinit_fast's best.pt
#   _jaxinit_prog_rescaled  rescale_transfer 128 -> 320 on that best.pt, then
#                           12 epochs at 240x320 from rescaled.pt       (section 4)
#
# Usage, from the repository root:
#
#   bash docs/convergence_torch/run_jaxinit.sh <workdir> [<docs-dir>] [<tag> ...]
#
# As run_all.sh: one workdir holds the 4096 generated scenes for every run
# (the packed cache rebuilds itself when the size or the split changes), and
# each run writes card_metrics<tag>.json and its two previews to <docs-dir>
# (default docs/convergence_torch). With tags, only those runs are made (the
# finetunes need _jaxinit_fast's run in the same workdir).
set -euo pipefail

work=${1:?usage: run_jaxinit.sh <workdir> [<docs-dir>] [<tag> ...]}
docs=${2:-docs/convergence_torch}
shift $(($# < 2 ? $# : 2))
tags=("$@")
[ ${#tags[@]} -gt 0 ] || tags=(_jaxinit _jaxinit_s43 _jaxinit_fast _jaxinit_prog_naive
                               _jaxinit_prog_rescaled)

card() {
    python -m stereo_depth_estimation_tpu_torch.scripts.convergence_run card \
        --samples 4096 --workdir "$work" --docs-dir "$docs" "$@"
}

fast_best() {
    cat "$work/jaxinit_fast_best"
}

for tag in "${tags[@]}"; do
    echo "=== $tag $(date -u +%FT%TZ)"
    case $tag in
        _jaxinit)
            card --epochs 200 --tag _jaxinit ;;
        _jaxinit_s43)
            card --epochs 200 --seed 43 --tag _jaxinit_s43 ;;
        _jaxinit_fast)
            card --height 96 --width 128 --batch-size 256 --epochs 200 --tag _jaxinit_fast
            run=$(ls -td "$work"/outputs/*/ | head -n 1)
            echo "${run}checkpoints/best.pt" > "$work/jaxinit_fast_best" ;;
        _jaxinit_prog_naive)
            card --epochs 12 --init-checkpoint "$(fast_best)" --tag _jaxinit_prog_naive ;;
        _jaxinit_prog_rescaled)
            python -m stereo_depth_estimation_tpu_torch.scripts.rescale_transfer \
                --checkpoint "$(fast_best)" --from-width 128 --to-width 320 \
                --out "$work/jaxinit_rescaled"
            card --epochs 12 --init-checkpoint "$work/jaxinit_rescaled/rescaled.pt" \
                --tag _jaxinit_prog_rescaled ;;
        *)
            echo "unknown run $tag" >&2; exit 2 ;;
    esac
done
