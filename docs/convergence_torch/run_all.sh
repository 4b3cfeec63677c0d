#!/usr/bin/env bash
# The convergence runs of docs/CONVERGENCE.md sections 3-6 through the port on
# one GPU, each a command of the convergence harness (or the rescale CLI):
#
#   _fast           96x128, batch 256, 200 epochs                     (section 3)
#   _prog_naive     12 epochs at 240x320 from _fast's best.pt as it is (section 4)
#   _prog_rescaled  rescale_transfer 128 -> 320 on that best.pt, then
#                   12 epochs at 240x320 from rescaled.pt              (section 4)
#   _cosine         240x320, batch 128, --lr-schedule cosine, 200 epochs (section 6)
#   _mid            128x160, batch 256, 200 epochs                    (section 5)
#
# Usage, from the repository root:
#
#   bash docs/convergence_torch/run_all.sh <workdir> [<docs-dir>] [<tag> ...]
#
# One workdir holds the 4096 generated scenes for every run; the packed cache
# there rebuilds itself when the size changes. Checkpoints (about 90 MB a
# run) stay in the workdir. Each run writes card_metrics<tag>.json and its two
# previews to <docs-dir> (default docs/convergence_torch). With tags, only
# those runs are made (the finetunes need _fast's run in the same workdir).
set -euo pipefail

work=${1:?usage: run_all.sh <workdir> [<docs-dir>] [<tag> ...]}
docs=${2:-docs/convergence_torch}
shift $(($# < 2 ? $# : 2))
tags=("$@")
[ ${#tags[@]} -gt 0 ] || tags=(_fast _prog_naive _prog_rescaled _cosine _mid)

card() {
    python -m stereo_depth_estimation_tpu_torch.scripts.convergence_run card \
        --samples 4096 --workdir "$work" --docs-dir "$docs" "$@"
}

# The fast run's best.pt, noted in the workdir when that run ends (its run
# directory is then the newest under outputs/).
fast_best() {
    cat "$work/fast_best"
}

for tag in "${tags[@]}"; do
    echo "=== $tag $(date -u +%FT%TZ)"
    case $tag in
        _fast)
            card --height 96 --width 128 --batch-size 256 --epochs 200 --tag _fast
            run=$(ls -td "$work"/outputs/*/ | head -n 1)
            echo "${run}checkpoints/best.pt" > "$work/fast_best" ;;
        _prog_naive)
            card --epochs 12 --init-checkpoint "$(fast_best)" --tag _prog_naive ;;
        _prog_rescaled)
            python -m stereo_depth_estimation_tpu_torch.scripts.rescale_transfer \
                --checkpoint "$(fast_best)" --from-width 128 --to-width 320 \
                --out "$work/rescaled_init"
            card --epochs 12 --init-checkpoint "$work/rescaled_init/rescaled.pt" \
                --tag _prog_rescaled ;;
        _cosine)
            card --epochs 200 --lr-schedule cosine --tag _cosine ;;
        _mid)
            card --height 128 --width 160 --batch-size 256 --epochs 200 --tag _mid ;;
        *)
            echo "unknown run $tag" >&2; exit 2 ;;
    esac
done
