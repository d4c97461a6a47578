"""Replay (port of r2d2_tpu/replay): blocks, the sum tree, the shared
control plane, the host ReplayBuffer and the actor-side
SequenceAccumulator; the tiered store, the device store and the device sum
tree; snapshots. The sum tree and the batch gathers run in
the port's C++ replay core (r2d2_tpu_torch/_native) unless the config sets
use_native_replay=False, which takes the numpy paths."""
