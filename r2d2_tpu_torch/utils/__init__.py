"""Run utilities (port of r2d2_tpu/utils): checkpoints, the metrics file,
profiling spans and worker supervision."""
