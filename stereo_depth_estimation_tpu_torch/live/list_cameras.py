"""``foundation-stereo-list-cameras``: probe video device indices.

Counterpart of ``stereo_depth_estimation_tpu/live/list_cameras.py``:

    python -m stereo_depth_estimation_tpu_torch.live.list_cameras [--max-index N]

walks the video device indices and reports which ones deliver frames and at
what default resolution, the first step of bringing up a stereo rig.
"""

from __future__ import annotations

import argparse


def probe_cameras(max_index: int) -> list[tuple[int, int, int]]:
    """Try indices 0..max_index; return (index, width, height) for each
    device that actually produced a frame."""
    import cv2

    usable: list[tuple[int, int, int]] = []
    for index in range(max_index + 1):
        capture = cv2.VideoCapture(index)
        ok, frame = capture.read()
        capture.release()
        if ok and frame is not None:
            height, width = frame.shape[:2]
            usable.append((index, width, height))
            print(f"  #{index}: delivers {width}x{height}")
    return usable


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Probe which video device indices deliver frames."
    )
    parser.add_argument("--max-index", type=int, default=10,
                        help="Highest device index to try.")
    args = parser.parse_args(argv)

    print(f"Probing video devices 0..{args.max_index}")
    usable = probe_cameras(args.max_index)
    if not usable:
        print("No working video devices. Check connections/permissions.")
        return
    print(f"\n{len(usable)} usable device(s):")
    for index, width, height in usable:
        print(f"  #{index}: {width}x{height}")
    print("Pick two indices as --left/--right for the calibrator and viewers.")


if __name__ == "__main__":
    main()
