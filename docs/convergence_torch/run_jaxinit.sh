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
#   _jaxinit_mid            128x160, batch 256, 200 epochs             (section 5)
#   _jaxinit_cosine         240x320, batch 128, --lr-schedule cosine   (section 6)
#   _jaxinit_fast_s43, _jaxinit_prog_naive_s43, _jaxinit_prog_rescaled_s43,
#   _jaxinit_fast_s44, _jaxinit_prog_naive_s44, _jaxinit_prog_rescaled_s44
#                           section 4 again at seeds 43 and 44: each
#                           finetune starts from its own seed's pretrain
#
# A tag's _s<N> suffix is the harness's --seed (the fresh weights, the
# train/val split, the augmentation and the shuffle); without one the seed is
# 42.
#
# Usage, from the repository root:
#
#   bash docs/convergence_torch/run_jaxinit.sh <workdir> [<docs-dir>] [<tag> ...]
#
# As run_all.sh: one workdir holds the 4096 generated scenes for every run
# (the packed cache rebuilds itself when the size or the split changes), and
# each run writes card_metrics<tag>.json and its two previews to <docs-dir>
# (default docs/convergence_torch). With tags, only those runs are made (a
# finetune needs its seed's _jaxinit_fast run in the same workdir).
set -euo pipefail

work=${1:?usage: run_jaxinit.sh <workdir> [<docs-dir>] [<tag> ...]}
docs=${2:-docs/convergence_torch}
shift $(($# < 2 ? $# : 2))
tags=("$@")
[ ${#tags[@]} -gt 0 ] || tags=(_jaxinit _jaxinit_s43 _jaxinit_fast _jaxinit_prog_naive
                               _jaxinit_prog_rescaled _jaxinit_mid _jaxinit_cosine
                               _jaxinit_fast_s43 _jaxinit_prog_naive_s43
                               _jaxinit_prog_rescaled_s43 _jaxinit_fast_s44
                               _jaxinit_prog_naive_s44 _jaxinit_prog_rescaled_s44)

card() {
    python -m stereo_depth_estimation_tpu_torch.scripts.convergence_run card \
        --samples 4096 --workdir "$work" --docs-dir "$docs" "$@"
}

# The seed of a tag: its _s<N> suffix, else 42.
seed_of() {
    case $1 in
        *_s[0-9]*) echo "${1##*_s}" ;;
        *) echo 42 ;;
    esac
}

# The best.pt of the pretrain with seed suffix $1 ("" or _s<N>), noted in the
# workdir when that run ends (its run directory is then the newest under
# outputs/).
fast_best() {
    cat "$work/jaxinit_fast${1}_best"
}

for tag in "${tags[@]}"; do
    echo "=== $tag $(date -u +%FT%TZ)"
    seed=$(seed_of "$tag")
    case $tag in
        _jaxinit)
            card --epochs 200 --tag _jaxinit ;;
        _jaxinit_s43)
            card --epochs 200 --seed 43 --tag _jaxinit_s43 ;;
        _jaxinit_mid)
            card --height 128 --width 160 --batch-size 256 --epochs 200 --tag _jaxinit_mid ;;
        _jaxinit_cosine)
            card --epochs 200 --lr-schedule cosine --tag _jaxinit_cosine ;;
        _jaxinit_fast | _jaxinit_fast_s[0-9]*)
            card --height 96 --width 128 --batch-size 256 --epochs 200 --seed "$seed" \
                --tag "$tag"
            run=$(ls -td "$work"/outputs/*/ | head -n 1)
            echo "${run}checkpoints/best.pt" > "$work/jaxinit_fast${tag#_jaxinit_fast}_best" ;;
        _jaxinit_prog_naive | _jaxinit_prog_naive_s[0-9]*)
            card --epochs 12 --seed "$seed" \
                --init-checkpoint "$(fast_best "${tag#_jaxinit_prog_naive}")" --tag "$tag" ;;
        _jaxinit_prog_rescaled | _jaxinit_prog_rescaled_s[0-9]*)
            s=${tag#_jaxinit_prog_rescaled}
            python -m stereo_depth_estimation_tpu_torch.scripts.rescale_transfer \
                --checkpoint "$(fast_best "$s")" --from-width 128 --to-width 320 \
                --out "$work/jaxinit_rescaled$s"
            card --epochs 12 --seed "$seed" \
                --init-checkpoint "$work/jaxinit_rescaled$s/rescaled.pt" --tag "$tag" ;;
        *)
            echo "unknown run $tag" >&2; exit 2 ;;
    esac
done
