"""Live stereo tooling: device probing, chessboard calibration, the SGBM
classical comparator, and the depth viewer on the GPU with checkpoint hot
reload. Every tool also runs headless on stored frame pairs."""
