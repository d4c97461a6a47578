"""The port's multi-process replay drill, shared by the tests and run as the
ranks they spawn (imports nothing of JAX).

`build_and_run(mesh, params=None)` fills a MultiHostShardedReplay with
per-shard deterministic blocks and runs 3 collective updates and two
K=2 dispatches (the deferred drain included), as the JAX package's
tests/multihost_child.py does: in one process owning every shard, or as
one rank of several. The same shard contents and the layout-independent
draw seeds make every layout compute the same updates.

    python tests/torch_multihost_child.py RANK WORLD PORT SHARDS_PER_RANK \\
        [PARAMS.pt]

joins a gloo group at localhost:PORT (torchrun's variables), owns
SHARDS_PER_RANK shards on the CPU, starts from the state dict in PARAMS.pt
(or the port's own init) and prints ``CHILD_RESULT {json}``.
"""

import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def synth_block(cfg, rng: np.random.Generator):
    """A full mid-episode block drawn from `rng` (the JAX package's bench
    synth_block, call for call, so both packages draw the same block)."""
    from r2d2_tpu_torch.replay.block import Block

    B, L, n, S = cfg.burn_in_steps, cfg.learning_steps, cfg.forward_steps, cfg.seqs_per_block
    size = cfg.block_length
    stored = B + size + 1
    forward = np.full(S, n, np.int32)
    forward[-1] = 1  # the last sequence of a block cut bootstraps at +1
    return Block(
        obs=rng.integers(0, 255, size=(stored, *cfg.obs_shape), dtype=np.uint8),
        last_action=rng.integers(0, cfg.action_dim, size=stored).astype(np.uint8),
        last_reward=rng.normal(size=stored).astype(np.float32),
        action=rng.integers(0, cfg.action_dim, size=size).astype(np.uint8),
        n_step_reward=rng.normal(size=size).astype(np.float32),
        gamma=np.full(size, cfg.gamma**n, np.float32),
        hidden=(rng.normal(size=(S, 2, cfg.hidden_dim)) * 0.1).astype(np.float32),
        num_sequences=S,
        burn_in_steps=np.full(S, B, np.int32),
        learning_steps=np.full(S, L, np.int32),
        forward_steps=forward,
    )


def seed_replay(replay, cfg):
    """Two blocks into each local shard, block k of shard g from
    default_rng(100 + g): the same blocks in the same shards whatever the
    process layout. Equal priorities (weights exactly 1)."""
    rngs = {g: np.random.default_rng(100 + g) for g in replay.local_ids}
    for _ in range(2):
        for g in replay.local_ids:
            replay.add_block(synth_block(cfg, rngs[g]),
                             np.full(cfg.seqs_per_block, 1.0, np.float32), None)
    assert replay.can_sample()


def build_and_run(mesh, params=None):
    """-> (losses, checksum, params digest, tree masses). checksum: the sum
    of |parameter| plus the global tree mass, as the JAX package's helper's."""
    import torch

    from r2d2_tpu_torch.config import tiny_test
    from r2d2_tpu_torch.learner import (
        init_train_state,
        make_sharded_fused_multi_train_step,
        make_sharded_fused_train_step,
    )
    from r2d2_tpu_torch.parallel.multihost import Collectives
    from r2d2_tpu_torch.replay.multihost_store import MultiHostShardedReplay
    from r2d2_tpu_torch.train import params_digest

    cfg = tiny_test().replace(batch_size=8)
    replay = MultiHostShardedReplay(cfg, mesh, seed=5)
    seed_replay(replay, cfg)
    _, state = init_train_state(cfg, mesh.devices[replay.local_ids[0]])
    if params is not None:
        state.net.load_state_dict(params)
        state.target_net.load_state_dict(params)
    coll = Collectives()
    step_fn = make_sharded_fused_train_step(cfg, is_from_priorities=True, collectives=coll)
    losses = []
    for _ in range(3):
        state, metrics = replay.run_step(step_fn, state)
        losses.append(float(metrics["loss"]))
    multi_fn = make_sharded_fused_multi_train_step(cfg, 2, is_from_priorities=True,
                                                   collectives=coll)
    for _ in range(2):
        state, metrics = replay.run_step_k(multi_fn, state, 2)
        losses.append(float(metrics["loss"]))
    replay.drain_pending()
    checksum = float(sum(p.detach().double().abs().sum() for p in state.net.parameters()))
    masses = torch.zeros(mesh.dp, dtype=torch.float64)
    for g, shard in zip(replay.local_ids, replay.shards):
        masses[g] = shard.tree.total
    coll.sum_(masses, "tree_mass")
    checksum += float(masses.sum())
    return losses, checksum, params_digest(state.net), masses.tolist()


def main():
    import torch

    rank, world, port, per = (int(x) for x in sys.argv[1:5])
    params = torch.load(sys.argv[5]) if len(sys.argv) > 5 else None
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from r2d2_tpu_torch.parallel.multihost import initialize_distributed, make_global_mesh

    if not initialize_distributed(timeout_s=120.0):
        raise SystemExit("the process group did not form")
    mesh = make_global_mesh(["cpu"] * per)
    losses, checksum, digest, masses = build_and_run(mesh, params)
    print("CHILD_RESULT " + json.dumps({"rank": rank, "losses": losses, "checksum": checksum,
                                        "digest": digest, "masses": masses}), flush=True)


if __name__ == "__main__":
    main()
