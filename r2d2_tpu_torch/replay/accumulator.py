"""SequenceAccumulator — actor-side episode accumulator producing Blocks
(port of r2d2_tpu/replay/accumulator.py).

Accumulates one env's transitions and, every `block_length` steps or at
episode end, packs a Block: n-step returns, the terminal-as-gamma-0
encoding, per-sequence step counts, the stored recurrent state at each
sequence's true replay-window start, actor-side initial priorities in the
learner's rescaled space, and a burn-in tail carried across block
boundaries. Deterministic: no RNG. On the multi-task plane an accumulator
stamps its task id into every Block and discounts with its task's gamma
(the n-step returns and the stored bootstrap discounts), so the learner
needs no per-task discount.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.ops.priority import mixed_td_priorities_np
from r2d2_tpu_torch.ops.returns import n_step_gammas, n_step_returns
from r2d2_tpu_torch.ops.value_rescale import inverse_value_rescale_np, value_rescale_np
from r2d2_tpu_torch.replay.block import Block, state_host_dtype, to_state_host


class SequenceAccumulator:
    def __init__(self, cfg: R2D2Config, task_id: int = 0, gamma: Optional[float] = None):
        self.cfg = cfg
        self.L = cfg.learning_steps
        self.B = cfg.burn_in_steps
        self.n = cfg.forward_steps
        self.gamma = cfg.gamma if gamma is None else float(gamma)
        self.task_id = int(task_id)
        self.curr_burn_in = 0
        self.size = 0

    def __len__(self) -> int:
        return self.size

    def reset(self, init_obs: np.ndarray) -> None:
        """Seed the episode: NOOP last-action, zero reward, zero hidden.
        Observations are copied (callers may reuse their buffers)."""
        self.obs_buf: List[np.ndarray] = [np.array(init_obs)]
        self.last_action_buf: List[int] = [0]
        self.last_reward_buf: List[float] = [0.0]
        self.hidden_buf: List[np.ndarray] = [
            np.zeros((2, self.cfg.hidden_dim), dtype=state_host_dtype(self.cfg.state_dtype))
        ]
        self.action_buf: List[int] = []
        self.reward_buf: List[float] = []
        self.qval_buf: List[np.ndarray] = []
        self.curr_burn_in = 0
        self.size = 0
        self.sum_reward = 0.0
        self.done = False

    def carry_state(self) -> dict:
        """The accumulator's whole mutable state as flat numpy arrays (the
        preemption carry in the replay snapshot, npz-safe). Ragged lists
        are stacked; the counts recover the split. Carries keep the state
        dtype's host form."""
        d = {
            "obs": np.stack(self.obs_buf),
            "last_action": np.asarray(self.last_action_buf, np.int64),
            "last_reward": np.asarray(self.last_reward_buf, np.float64),
            "hidden": np.stack(self.hidden_buf),
            "action": np.asarray(self.action_buf, np.int64),
            "reward": np.asarray(self.reward_buf, np.float64),
            "meta": np.asarray([self.curr_burn_in, self.size, int(self.done)], np.int64),
            "sum_reward": np.asarray(self.sum_reward, np.float64),
        }
        if self.qval_buf:
            d["qval"] = np.stack(self.qval_buf)
        else:
            d["qval"] = np.zeros((0, self.cfg.action_dim), np.float32)
        return d

    def restore_carry(self, d: dict) -> None:
        hidden_dtype = state_host_dtype(self.cfg.state_dtype)
        self.obs_buf = list(np.asarray(d["obs"]))
        self.last_action_buf = [int(a) for a in d["last_action"]]
        self.last_reward_buf = [float(r) for r in d["last_reward"]]
        self.hidden_buf = [np.asarray(h, hidden_dtype) for h in d["hidden"]]
        self.action_buf = [int(a) for a in d["action"]]
        self.reward_buf = [float(r) for r in d["reward"]]
        self.qval_buf = [np.asarray(q, np.float32) for q in d["qval"]]
        meta = np.asarray(d["meta"])
        self.curr_burn_in = int(meta[0])
        self.size = int(meta[1])
        self.done = bool(meta[2])
        self.sum_reward = float(np.asarray(d["sum_reward"])[()])

    def add(self, action: int, reward: float, next_obs: np.ndarray,
            q_value: np.ndarray, hidden: np.ndarray) -> None:
        """Append one transition. `hidden` is the (2, H) LSTM state after
        consuming the pre-step observation, kept in the state dtype."""
        self.action_buf.append(int(action))
        self.reward_buf.append(float(reward))
        self.hidden_buf.append(to_state_host(hidden, self.cfg.state_dtype))
        self.obs_buf.append(np.array(next_obs))
        self.last_action_buf.append(int(action))
        self.last_reward_buf.append(float(reward))
        self.qval_buf.append(np.asarray(q_value, dtype=np.float32))
        self.sum_reward += float(reward)
        self.size += 1

    def finish(
        self, last_qval: Optional[np.ndarray] = None
    ) -> Tuple[Block, np.ndarray, Optional[float]]:
        """Pack the accumulated steps into a Block. last_qval=None means the
        episode terminated; otherwise it is Q(s_T) bootstrapping a cut.
        Returns (block, priorities padded to seqs_per_block, episode reward
        or None while the episode runs on)."""
        if not 0 < self.size <= self.cfg.block_length:
            raise ValueError(f"cannot pack {self.size} steps into a block")
        L, B, n = self.L, self.B, self.n
        size = self.size
        num_seq = math.ceil(size / L)
        max_fwd = min(size, n)
        self.done = last_qval is None

        gamma_n = n_step_gammas(size, self.gamma, n, done=self.done)
        qvals = self.qval_buf + [
            np.zeros_like(self.qval_buf[0]) if self.done
            else np.asarray(last_qval, dtype=np.float32)
        ]
        qval_arr = np.stack(qvals)  # (size + 1, A)
        n_step_reward = n_step_returns(np.asarray(self.reward_buf, dtype=np.float64), self.gamma, n)

        obs = np.stack(self.obs_buf)
        last_action = np.asarray(self.last_action_buf, dtype=np.uint8)
        last_reward = np.asarray(self.last_reward_buf, dtype=np.float32)
        actions = np.asarray(self.action_buf, dtype=np.uint8)

        seq_ids = np.arange(num_seq)
        burn_in = np.minimum(seq_ids * L + self.curr_burn_in, B).astype(np.int32)
        learning = np.minimum(L, size - seq_ids * L).astype(np.int32)
        cum_learning = np.cumsum(learning)
        forward = np.minimum(n, size + 1 - cum_learning).astype(np.int32)

        # true window starts, in buffer coordinates
        window_start = self.curr_burn_in + seq_ids * L - burn_in
        hiddens = np.stack([self.hidden_buf[int(w)] for w in window_start])

        # actor-side initial priorities, in the learner's rescaled space
        max_q = np.max(qval_arr[max_fwd : size + 1], axis=1)
        max_q = np.pad(max_q, (0, max_fwd - 1), "edge")[:size]
        taken_q = qval_arr[np.arange(size), actions]
        eps = self.cfg.value_rescale_eps
        target = value_rescale_np(
            n_step_reward + gamma_n * inverse_value_rescale_np(max_q, eps), eps
        )
        abs_td = np.abs(target - taken_q).astype(np.float32)

        td_padded = np.zeros((num_seq, L), dtype=np.float32)
        mask = np.zeros((num_seq, L), dtype=np.float32)
        for i in range(num_seq):
            steps = int(learning[i])
            td_padded[i, :steps] = abs_td[i * L : i * L + steps]
            mask[i, :steps] = 1.0
        priorities = np.zeros(self.cfg.seqs_per_block, dtype=np.float32)
        priorities[:num_seq] = mixed_td_priorities_np(td_padded, mask, self.cfg.td_mix_eta)

        block = Block(
            obs=obs, last_action=last_action, last_reward=last_reward,
            action=actions, n_step_reward=n_step_reward, gamma=gamma_n,
            hidden=hiddens, num_sequences=num_seq, burn_in_steps=burn_in,
            learning_steps=learning, forward_steps=forward, task=self.task_id,
        )
        episode_reward = self.sum_reward if self.done else None

        if not self.done:
            # carry the last B+1 aligned entries so the next block's early
            # sequences can burn in across the boundary
            self.obs_buf = self.obs_buf[-B - 1 :]
            self.last_action_buf = self.last_action_buf[-B - 1 :]
            self.last_reward_buf = self.last_reward_buf[-B - 1 :]
            self.hidden_buf = self.hidden_buf[-B - 1 :]
            self.curr_burn_in = len(self.obs_buf) - 1
            self.action_buf.clear()
            self.reward_buf.clear()
            self.qval_buf.clear()
            self.size = 0

        return block, priorities, episode_reward
