"""Dataset I/O: calibration files, image folders with stamps, PNG codec,
TUM keyframe trajectories."""
