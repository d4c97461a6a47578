"""Host replay plane (port of r2d2_tpu/replay, numpy path only): blocks,
the sum tree, the shared control plane, the host ReplayBuffer and the
actor-side SequenceAccumulator. The C++ core (r2d2_tpu/_native) is not
ported; these are the numpy reference paths."""
