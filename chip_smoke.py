#!/usr/bin/env python3
"""Drive the PyTorch port (r2d2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each on
its own lines; any failure exits non-zero and prints no result:

1. card   the card's name, power limit and SM clock (nvidia-smi).
2. build  the five kernels from r2d2_tpu_torch/csrc with nvcc, in parallel;
          registers, shared memory and spills as ptxas reports them; the
          HMMA (tensor-core) instructions of each form in the built
          library's SASS (cuobjdump -sass): every bf16 form (K1, K2, K3, K4
          and K5) must have some, in every instantiation.
3. check  each kernel against its plain PyTorch version on the card: at the
          atari widths (T=85, B=64, H=512, fp32), at the xl width (H=2048)
          and at ragged small shapes, with seams at 0, mid, T-1 and mixed
          per row; the checkpointed backward at every divisor stride of T,
          with seams on segment boundaries too. The column split of every
          kernel (units per block, grid, threads, k-tile, wh slice pinned
          or streamed) is printed per shape; at the atari widths two
          launches of each must give the same bits (K3: dz, dh0, dc0; K4:
          dz and dWh; K5: dz and dWh at S=5), K4's dz must equal K2's bit
          for bit at the same inputs (the same walk in the same geometry),
          and whether K5's dz equals K2's is printed (not required).
4. train  the main path: Trainer.run_inline at the atari preset's widths
          (84x84x1 frames, nature encoder, hidden 512, burn-in / learning /
          forward 40/40/5, batch 64, fp32) on catch, with only the host
          replay sizes cut. The launch counters are zeroed just before it
          and read just after: every update launches the forward kernel
          twice (online and target unroll) and the seam backward once.
5. agree  one update's loss, priorities, gradient norm and each
          parameter's gradient norm on a sampled batch at those widths,
          through the kernels on the card, against the same update through
          the plain versions on the CPU.
6. arms   the same path under each other backward: backward_arm=fused_dwh,
          backward_arm=ckpt (stride 5) and fused_sequence=False, each with
          its counters zeroed just before and read just after (2 forward
          launches and 1 of the arm's backward kernel per update), and one
          update against the CPU as in phase 5.
7. xl     the atari preset under model preset xl (hidden 2048), fp32, the
          default backward_arm=auto, which resolves to the checkpointed arm
          at stride 85; two updates and their ms per update, and one update
          against the CPU as in phase 5.
8. time   each kernel, its plain version, its bound and, where one PyTorch
          call computes the same function, that call (the cuDNN LSTM
          forward, and its backward for the seamless backward), with CUDA
          events, at the main path's shapes and with the seams of a batch
          the main path sampled; the default arm's backward pair (K2 and
          the hprev^T @ dz matmul) beside K4, as a yardstick; T grid
          barriers alone at the forward's geometry (the column split's
          floor); the exchange alone in K2's geometry, both forms (T - 1
          steps of barrier + exchange into the stage ring, no product),
          through cp.async and through K2's bulk ring, which splits K2's
          step into barrier, exchange and products; likewise K1's step,
          both forms, at the atari widths and at xl (the exchange of h
          alone, and at xl with and without the streamed gate columns,
          in K1's geometry); K4's step, both forms, at the atari widths
          and at xl: barrier, exchange, the dWh pass (a launch's passes
          alone) and products, beside K2 and the default arm's pair in
          the same call; the forward and the
          four backwards also at xl, with cuDNN's fp32 LSTM forward and backward there (TF32 off); and the
          SM clock read while forward launches are queued.
9. chunks all five kernels with the batch in row chunks, at B=1024, H=512
          and B=256, H=2048 (T=85): against their plain versions, two
          launches each giving the same bits, and their times; the bf16
          forms of K2, K3, K4 and K5 likewise, K4-bf16's dz equal to
          K2-bf16's rounded to bf16.
10. bf16  the bf16 forms of all five kernels against their plain versions
          at the atari and xl widths and at the wide model's batch 96
          (H=1024, B=96), seams 0, mid, T-1 and mixed, K5 at S=5 and
          S=85, two launches each giving the same bits; K4-bf16's dz
          equal to K2-bf16's f32 dz rounded to bf16, bit for bit.
11. train bf16  the atari preset with its own compute dtype (bfloat16) on
          catch: 8 updates, each 2 lstm_fwd_bf16 + 1 lstm_seq_bwd_bf16
          launches, ms per update and peak memory; its xl model, whose
          backward_arm=auto resolves to ("ckpt", 5) in bf16: 2 updates of 2
          lstm_fwd_bf16 + 1 lstm_seq_bwd_ckpt_bf16; precision="bf16"
          (carries stored in bf16): 4 updates. Then the two paths of the
          bf16 forms of K4 and K3: the wide model (hidden 1024) at batch
          96, whose auto resolves to ("fused_dwh", 0) in bf16 (4 updates
          of 2 lstm_fwd_bf16 + 1 lstm_seq_bwd_fused_bf16), the same model
          at backward_arm=default (2 updates, for its peak memory beside
          the fused arm's), backward_arm=fused_dwh at the atari widths and
          fused_sequence=False (4 updates each; 2 lstm_fwd_bf16 + 1
          lstm_bwd_bf16), one update of the wide model with
          fused_sequence=False, and backward_arm=ckpt at the atari widths
          (stride 5; 4 updates of 2 lstm_fwd_bf16 + 1
          lstm_seq_bwd_ckpt_bf16), the second path of K5's bf16 form.
12. agree bf16  one bf16 update on the card against the same update
          through the plain versions on the CPU, and the bf16 update
          against the fp32 update on the card from the same parameters and
          batch (tests/test_precision.py's class: loss within 5%,
          priorities rtol 0.2 / atol 0.05): the main path, the wide model
          at batch 96 (fused_dwh), fused_sequence=False, and both paths of
          K5's bf16 form, ckpt at the atari widths and xl.
13. time bf16  each bf16 form, its plain version, its bounds (the bytes,
          and the operations at the fp32 FMA peak and at the bf16 tensor
          cores' dense peak) and cuDNN's LSTM forward and backward in bf16
          where torch takes them, at the atari widths, at the wide model's
          batch 96 and at xl; beside K4-bf16 the bf16 default arm's pair
          (K2-bf16 and the hprev^T @ dz matmul). Every bf16 form runs its
          products on the tensor cores.

14. e2e   the main path through the entry points a user calls, with
          checkpoints and a metrics file (log_interval 0): the atari preset
          in its own bf16 through Trainer.run_threaded (actor and sampler
          threads, batches staged through pinned memory), 12 updates of 2
          lstm_fwd_bf16 + 1 lstm_seq_bwd_bf16 (counts zeroed just before
          and read just after), checkpoints [6, 12], 12 finite metrics
          records; Trainer(resume=True) restores step, networks and Adam
          state bit for bit; evaluate_series over both checkpoints on 8
          catch envs, its rows printed. Then fp32 through run_inline: 8
          updates, checkpoints [4, 8].
15. modes ms per learner update over the wall (acting and sampling
          included) of run_inline and run_threaded on the bf16 and the
          fp32 main path (threaded also with samples_per_insert set so
          that it acts as much per update as inline; each threaded run
          with its batches staged through the pinned ring, and again with
          the sampler copying them from pageable memory through
          DeviceBatch.from_sampled, as inline does; inline and threaded
          also with use_native_replay=False, the numpy gathers, beside the
          native core's), env steps per update, the updates' peak device
          memory, and in threaded mode TransferTimer's overlap fraction,
          h2d and wait seconds; then 3 more updates under
          torch.profiler (inline and threaded, native and numpy, always;
          the other rows with --profile): the device's busy share and the
          host time under the spans replay/sample and learner_update, the
          rest of the wall beside them. Printed, not held to a limit.
16. odd    hidden 510 (a multiple of neither 4 nor 8) in fp32 and bf16: one
          update of 2 forward + 1 seam backward launches at 512 units (the
          model pads zero units), against the CPU as in phases 5 and 12.
17. native a numpy ReplayBuffer given the fp32 main path's replay samples
          the same batches as the native core bit for bit; both times.
18. long   the long_context preset at full width, bf16 and fp32: no LSTM
          kernel launches, the CPU update by update, lru_chunk=128, e2e.
19. preempt the preemption protocol on the bf16 main path through the CLI:
          an uninterrupted run of 6 updates, a run cut by
          R2D2_FAULTS="trainer.update@3=sigterm" (exit 85, the replay
          snapshot with its mid-run carry and a finalized checkpoint at
          step 3) and its --resume (exit 0 at step 6). The first resumed
          update's loss and priorities, and the final networks, Adam state
          and replay, must equal the uninterrupted run's bit for bit; if
          the final state does not, a second uninterrupted run decides: if
          it differs from the first, the card does not reproduce its update
          across processes (the tensors are named and held to rtol 1e-4 /
          atol 1e-5), else the resume is at fault and the phase fails. Then
          an fp32 cut in-process: request_preempt during run_threaded at
          step 4 of 8, the resume bitwise, both runs' launches counted.
20. tiered the tiered replay plane at the paper's 2,000,000 transitions
          (learning_starts cut to 2,000), bf16 and fp32, K=1 and K=4 updates
          per dispatch, beside the host plane at the same capacity in the
          same call: ms per update over the wall (8 updates inline, acting
          included), launches per dispatch (2K forward + K backward,
          counted from 0 just before), the update peak and the two slabs'
          size, TransferTimer's overlap, the process's resident memory with
          the store allocated, and under the profiler the span
          replay/staged_chunk (replay/sample for the host plane), the
          learner_update span and the device's busy share. Then with
          deterministic_staging a chunk copied back from the card equals K
          host-plane draws bit for bit and its write-backs reach the tree;
          then the disk tier (2 host and 24 disk blocks, delta-zlib): draws
          of disk-resident rows equal the rows written, and a write-back
          whose slot was overwritten since its draw is dropped.
21. device the device replay plane (the store on the card, the update
          gathering its windows from it) at the paper's 2,000,000
          transitions, fp32: from the same contents and Generator state the
          in-step gather equals the host plane's batch bit for bit; one
          fused update equals make_train_step on that batch (rtol 1e-4 /
          atol 1e-5); a K=4 dispatch equals 4 single fused steps on the
          same coordinates and launches 2K forward + K backward kernels;
          the device tree's leaves stay within the three-way bound of the
          host float64 tree (rtol 1e-5 / atol 1e-6) after ingestion and
          write-backs; a superstep of N=2 equals two of N=1 and launches
          2NK + NK; a device snapshot round trip at 16,000 transitions.
          Then, bf16 and fp32 in the same call, ms per update over the wall
          (8 updates inline, acting included) of the host plane (16,000,
          native core), the device plane at K=1 and K=4 and, in bf16
          only, the device priority plane at K=4, N=2 (all at 2,000,000),
          each with its launches, update peak, store bytes on the card
          and, under the profiler, the device's busy share (the tiered
          K=4 row is phase 20's).
22. fused --mode fused (collector and replay on the card) at the same
          widths, max_episode_steps cut to the 400-step chunk: on the card
          a collector chunk's blocks equal the host actor's
          SequenceAccumulator blocks on the same trajectories (16 envs, the
          host actor's ε draws handed in); a megastep equals its parts (the
          chunk with the entry parameters, K=4 fused updates, the slab
          write) at 16,000 transitions; the device evaluator's scores and
          truncated count; then Trainer.run_fused at 2,000,000, bf16 and
          fp32, 2 timed dispatches: ms per dispatch, updates per second,
          the chunk's env steps per second (and in bf16 its kernel
          launches, by the profiler), launches 2K + K per dispatch; and the
          CLI's --mode fused once through its main(), at 16,000 transitions.
23. procgen the procgen_impala preset (procmaze 64x64x3 -> IMPALA (16, 32,
          32) -> LSTM 512, T=85, B=64), replay cut to 16,000 transitions
          (learning_starts 2,000): the procmaze core on the card equals the
          CPU's bit for bit from the same draws (64 envs, 50 steps); a
          96-step collector chunk over 16 envs equals the host actor's
          SequenceAccumulator blocks (as phase 22, compare_blocks), fp32
          and bf16; 4 inline updates in bf16 and fp32, each 2 K1 + 1 K2 of
          its dtype, ms per update alone and over the wall, the update
          peak; one update held against the CPU (fp32 1e-4 / 1e-5; bf16
          1e-2 / 1e-3 on the whole update, priorities included, and on the
          update with the card's encoder outputs handed to both; the
          priorities' distance printed beside the IMPALA encoder's derived
          rounding bound carried to them, encoder_bound_priorities);
          run_fused with the device collector (K=2, launches 2K + K); the
          CLI once. 2 more updates of each dtype under torch.profiler:
          device time by kernel, busy share.
24. multitask MultiTaskTrainer over keydoor, drift, banditgrid and catch at
          the atari preset's widths (84x84x1, nature, LSTM 512, T=85, B=64
          in four task shares of 16, 8 actors, union action_dim 5),
          learning_starts cut to 2,000, bf16 and fp32: warmup, the acting
          step's invalid Q at -1e9, one stratified update against the CPU
          (1e-4 / 1e-5; bf16 1e-2 / 1e-3), 8 updates through train() of 2
          K1 + 1 K2 each, every stored action below its task's count, ms
          per update alone and over the wall, the update peak, per-task env
          steps, per-task evaluation rows; the sweep CLI's --multitask once
          (through its main()).

25. serve the serving plane (r2d2_tpu_torch/serve) at the atari preset's
          widths on catch (84x84x1, nature encoder, LSTM 512, 3 actions):
          every bucket 2-32, fp32 and precision=bf16, serial and pipelined
          two deep, four requests a session submitted to the running
          server (start(): the serve loop, and when pipelined the
          completion worker behind the depth-2 semaphore, two batches in
          flight): q, actions and the cache's carries equal reference_act
          at each answer's bucket and row bit for bit, 5 step shapes; one
          bucket-32 batch on the card against the CPU (1e-4 / 1e-5; bf16
          1e-2 / 1e-3); the int8 arm bit for bit its dequantized
          reference, its Q drift against fp32 under 5% of max |Q|;
          open-loop Poisson load at 500, 2,000 and 8,000 requests/s, 3 s a
          rate, per arm (fp32, bf16, int8 on bf16) over 256 sessions (cache
          32, spill slab 512, a hot reload half way, the first 20%
          discarded): one JSON line a rate and arm with requests/s,
          p50/p95/p99, SLO attainment at 50 ms, occupancy, spills, promotes,
          rejects, failed and unanswered requests and worker restarts and
          stalls (each of these four fails the phase); the carry bytes per
          session and a
          cache of 1,000,000 sessions, a batch on its last rows bit for bit;
          no LSTM kernel launched across the phase.
26. fleet the serving fleet and the live loop (r2d2_tpu_torch/serve/multi.py,
          degrade.py, scenarios.py, autoscale.py; liveloop/) at the atari
          preset's widths on catch, bf16 as it ships, two replicas on one
          card, each with its own module: the ladder's admission shed
          inside its budget; (a) 16 interleaved sessions, every answer its
          replica's reference_act at its bucket and row bit for bit,
          placements least-loaded, no session moving; (b) checkpoints
          through the fleet's watcher in fp32 and int8 weights, both
          replicas at one (step, version); (d) rungs 0 -> 3 -> 0 pinned in
          lockstep, the step kept, the version bumped, answers bit for bit
          under each arm, probe Q drift of bf16 under 5% and int8 under
          INT8_DRIFT; (c) the busier replica killed with a round queued:
          its sessions migrated, none lost, every answer continuing its
          carry bit for bit; (e) a scripted autoscaler adding a warmed
          replica at the fleet's version and draining one through
          migration; (f) flash_crowd and replica_kill with the ladder and
          the autoscaler running, one readiness row each (failing on a
          lost session, a timeout or transport outcome, or a kill not at
          its event); (g) 16 catch sessions served through LocalClient
          feeding a LiveLoopPlane, a LiveLoopTrainer on that replay
          checkpointing every LIVE_SAVE_INTERVAL updates, each update
          exactly 2 K1-bf16 + 1 K2-bf16, the fleet hot-reloading on both
          replicas, no session lost and no worker restart or stall, and the
          tap's blocks equal, stamps included, to an offline
          SequenceAccumulator's fed the served stream as recorded; ms per
          live update over the wall, served requests/s and p99, the peak.
          Then K1-bf16 and K2-bf16 timed at the live replay's seams, their
          rows in the kernels line with the live loop's launches.
27. pod   the pod loop (r2d2_tpu_torch/transport) across real processes on
          the card: `python -m r2d2_tpu_torch.transport.podloop` as one
          learner and two serve hosts on cuda:0 (tests/torch_podloop.py
          drives them), the atari preset on catch in bf16, the replay cut
          as in phase 26; 16 closed-loop catch sessions through
          PolicyClient in 4 client processes, 8 to a host, 25 requests/s
          each, for 36 s (stretched to 10 s past h0's return); at 30%
          of the window h0 is SIGKILLed and
          relaunched with its host id, spool directory and serve port. It
          fails on a duplicate block, a lost session, a learner that died
          or did not train through the outage, an h0 mark that did not pass
          its value at the kill or that misses a block the relaunched h0
          numbered, a host with no reload or with a version the learner did
          not broadcast, any learner update not exactly 2 K1-bf16 + 1
          K2-bf16 (the learner process's own counts), a host that launched
          an LSTM kernel, or a child that exits non-zero. Printed beside
          phase 26's live-loop row: ingest lag, served requests/s and
          latency, the learner's ms per update, peak and launches,
          broadcasts and reloads, wire bytes, the drill. Then K1-bf16 and
          K2-bf16 timed at the seams of a batch the learner drew, their
          "podloop" rows in the kernels line with its launches.
28. dp    data parallelism (r2d2_tpu_torch/parallel, replay/sharded_store.py,
          replay/multihost_store.py): (a) the atari_v4_8 preset on catch
          (84x84x1, nature, LSTM 512, T=85, batch 64 in four shards of 16,
          bf16, the default arm), the paper's 2,000,000 transitions in four
          stores on cuda:0 (learning_starts cut to 2,000, the actors from
          256 to 8), through Trainer.run_inline: 8 timed updates at K=1 and
          at K=4, each exactly 8 K1-bf16 + 4 K2-bf16 (2*dp and dp); ms per
          update over the wall and the learner_update span beside phase
          21's dp=1 device plane, the update peak, the store's bytes a
          shard; one sharded update against the CPU's plain versions and
          against the dp=1 update on the same 64 rows on the card (1e-2 /
          1e-3), and with a replica per shard (every replica bit-identical
          to the stepped state); a sharded snapshot at 16,000 transitions
          restored bit for bit. (b) two ranks of `python -m
          r2d2_tpu_torch.train --distributed --replay multihost --dp 2` on
          cuda:0 under torchrun's variables and gloo, one shard each (batch
          32 a shard), the replay cut as phase 26's: 8 updates, each rank
          exactly 2 K1-bf16 + 1 K2-bf16 an update, the parameters of both
          ranks bit-identical, ms per update and the time in the gradient
          and MIN all-reduces, the device of the tensors gloo reduced.
          Then K1-bf16 and K2-bf16 at the shard's shapes (B=16 and B=32),
          held against their plain versions there and timed, their
          "sharded" and "multihost" rows in the kernels line.
29. elastic M13b: elastic resharding, the sharded device planes, tp and
          fsdp. (a) the atari_v4_8 preset (bf16, dp=4 on cuda:0 x 4, replay
          16,000 / 2,000) through the train CLI's main in this process:
          6 updates uninterrupted; a run cut by
          R2D2_FAULTS="trainer.update@3=sigterm" (exit 85); the exact
          reshard (dp=4 -> dp=4) of its snapshot equal to a plain restore
          bit for bit (stores, trees, counters); a re-deal to dp=2 keeping
          the global counters; --resume --reshard at dp=4 ending on the
          uninterrupted run's networks and Adam state bit for bit, at
          dp=2 and at dp=1 on the device priority plane (exit 0 each);
          Trainer.reshard_live(dp_size=1) leaving the replay and state a
          fresh --reshard resume restores, bit for bit; the reshard's
          seconds and bytes. (b) at the paper's 2,000,000 transitions in
          four stores: priority_plane=device through Trainer.run_inline,
          supersteps of N=2 x K=4, each exactly N*K*dp*(2 K1-bf16 + 1
          K2-bf16), and one sharded superstep update held against the
          unsharded update of the same rows (1e-2 / 1e-3); --mode fused
          with the device collector on the sharded plane (K=4, each
          dispatch K*dp*(2 + 1) launches), and a sharded megastep at
          16,000 against its parts (the per-shard chunks bit for bit, the
          K updates against the unsharded ones on the concatenated store,
          1e-2 / 1e-3); two gloo ranks of the CLI's --mode fused on the
          multihost plane (MultiHostFusedRunner), their parameters
          bit-identical; ms per update over the wall, ms per dispatch and
          the update peak. (c) the wide model (hidden 1024) at the atari
          widths (T=85, B=64, bf16) on one card: 2 updates each of manual
          tp=2 x fsdp=2 (2*fsdp K1 + fsdp K2 an update), gspmd tp=2 and
          gspmd fsdp=2 (2 K1 + 1 K2), held against the tp=1 updates (loss,
          priorities and parameters, 1e-2 / 1e-3), the moment shards'
          shapes; PolicyServer(mesh=) with tp=2 answering 32 requests as
          mesh=None does, bit for bit. Then K1-bf16 and K2-bf16 at each
          path's shapes, held against their plain versions and timed,
          their rows in the kernels line.
30. graph the graph checks (r2d2_tpu_torch/analysis/graph_rules.py) on the
          card: scan_entry_points(device="cuda") over every entry point at
          tiny_test's shapes, fp32 and bf16 (the train step, the
          multi-task, resharded dp=2 and manual dp2 x tp2 x fsdp2 steps,
          act and act_select, the unroll, the fused_dwh, ckpt and auto
          arms, the superstep, the serve step with its int8 arm, the fleet
          of two, the live-loop gather, the store fields, the trace
          budget); then the train step and the serve step (none and int8)
          at the atari widths (T=85, B=64, H=512), fp32 and bf16. Every
          recorded call runs under torch.cuda.set_sync_debug_mode("error").
          Any finding fails the phase; the dispatches and launches per
          update of each train step are printed, and must be equal form by
          form.

The script's wall time is printed last among the phases. The
next-to-last lines are the kernels as one JSON object (each form with
the unit its products run on: "tensor_cores" or "fma") and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile N

adds N more updates of the main path (fp32, then bf16), of the wide
model at batch 96 (bf16, fused_dwh) and of bf16 xl (ckpt, 5) under
torch.profiler after the last phase and prints where their device time
goes, by kernel, and the device's busy share.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import concurrent.futures
import copy
import dataclasses
import json
import math
import os
import queue
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, bf16 on the tensor cores (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel vs plain version: both float32, dot products summed in other
# orders, differences carried through T recurrent steps
ATOL = 1e-4
RTOL = 1e-4
# dWh summed in the kernel (per column slice; K4 windows of steps, K5
# segments, newest first) against the plain version's per-step matmuls: each entry
# sums T*B products of both signs, so the error is held against the
# largest entry, not entry by entry
DWH_TOL = 1e-4
# a bf16 kernel form vs its plain version: both sum exact products of bf16
# values in float32 in other orders, so a value can round to the
# neighbouring bf16 value (2^-8 relative) where the two sums straddle a
# rounding boundary, and that step feeds the later steps
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2
BF16_DWH_TOL = 1e-2
# one bf16 update on the card vs the same on the CPU: the same casts, the
# encoder's and heads' bf16 products summed in other orders
BF16_AGREE = dict(rtol=1e-2, atol=1e-3)

UPDATES = 8
ARM_UPDATES = 4
XL_UPDATES = 2
PRECISION_UPDATES = 4
# the atari preset on catch, with only the host replay sizes cut from the
# preset's 2,000,000 and 50,000; ON_CATCH trains in fp32, ON_CATCH_BF16 in
# the preset's own bfloat16
ON_CATCH_BF16 = dict(env_name="catch", buffer_capacity=16_000, learning_starts=2_000)
ON_CATCH = dict(ON_CATCH_BF16, compute_dtype="float32")
# phase 14: (updates, save_interval) of the end-to-end runs through the
# entry points, bf16 threaded and fp32 inline (long_context's, phase 18,
# evaluate one checkpoint since PR 21, to pay for the env-pool row)
E2E = {"bf16": (12, 6), "fp32": (8, 4), "long_context bf16": (4, 4),
       "long_context fp32": (4, 4)}
# phase 14: the bf16 atari path trained on a host env stepped through
# ThreadedHostEnvPool (scripted: the stand-in for an ALE fleet, which the
# card's machine lacks); its workers, inline updates and warmup transitions
ENVPOOL_WORKERS = 4
ENVPOOL_UPDATES = 4
ENVPOOL_CUT = dict(env_name="scripted", buffer_capacity=16_000, learning_starts=256)
# phase 15: learner updates timed per mode, after 2 that warm the path, and
# the updates profiled after them (processing the trace of each costs time)
MODE_UPDATES = 8
PROFILED_UPDATES = 3
# phase 16: a hidden size that is a multiple of neither 4 nor 8
ODD_HIDDEN = 510
# phase 17: batches compared bit for bit, and timed, native against numpy
NATIVE_COMPARES = 5
NATIVE_TIMED = 20
# phase 18: the long_context preset with only the host replay sizes cut
# (2,048,000 -> 16 blocks of 1024; 50,000 -> 6,144 transitions, eight
# 768-step episodes); inline updates, updates held against the CPU one by
# one (fp32), and the chunk of the chunked LRU form
LONG_CONTEXT_CUT = dict(buffer_capacity=16_384, learning_starts=6_144)
LC_UPDATES = 4
LC_AGREE = 1
LC_CHUNK = 128
# phase 19: the preemption drill through the CLI on the bf16 main path (the
# replay cut as the other atari phases): PREEMPT_UPDATES updates
# uninterrupted, a SIGTERM at update PREEMPT_AT, the resume to the end; then
# an fp32 cut in-process through request_preempt during run_threaded
PREEMPT_UPDATES = 6
PREEMPT_AT = 3
THREADED_CUT = (8, 4)
# phase 20: the tiered plane at the paper's replay capacity, K updates per
# dispatch; TIERED_UPDATES timed after 2 dispatches that warm the path, and
# TIERED_PROFILED more under the profiler
TIERED_CAPACITY = 2_000_000
TIERED_KS = (1, 4)
TIERED_UPDATES = 8
TIERED_PROFILED = 4
# phases 21 and 22: the device planes at the paper's capacity; the rows of
# phase 21 as (plane, K, N, capacity), timed as phase 20's; the superstep's
# row (the device priority plane through the Trainer) in bf16 only
DEVICE_ROWS = (("host", 1, 1, 16_000), ("device", 1, 1, TIERED_CAPACITY),
               ("device", 4, 1, TIERED_CAPACITY))
SUPERSTEP_ROW = ("device", 4, 2, TIERED_CAPACITY)
DEVICE_K = 4
SNAPSHOT_CAPACITY = 16_000
# phase 22: dispatches timed after 2 that warm the path; the envs of the
# block check; the store of the megastep check (40 blocks: the preset's 8
# envs' chunk written and the next one reserved)
FUSED_DISPATCHES = 2
BLOCK_CHECK_ENVS = 16
MEGA_CAPACITY = 16_000
# phase 23: the procgen_impala preset with its replay cut as the other phases
# cut theirs; updates per dtype; the procmaze core's card-vs-CPU check (envs,
# steps); fused dispatches of K updates on procmaze
PROCGEN_CUT = dict(buffer_capacity=16_000, learning_starts=2_000)
PROCGEN_UPDATES = 4
PROCMAZE_CHECK = (64, 50)
PROCGEN_FUSED_K = 2
PROCGEN_PROFILED = 2
# phase 24: the multi-task family (the sweep's default maze,drift,bandit and
# its catch anchor) at the atari preset's widths, its replay cut likewise
MULTITASK_TASKS = ("keydoor", "drift", "banditgrid", "catch")
# learning_starts cut as the other phases cut it; the capacity stays the
# preset's: each task's ring holds one episode per 400-step block slot, and
# keydoor's and banditgrid's episodes last at most 28 and 16 steps, so a
# 16,000-transition store (10 slots a task) never reaches a task's 500
MULTITASK_CUT = dict(learning_starts=2_000)
MULTITASK_WARMUP_CAP = 20_000
MULTITASK_UPDATES = 8
MULTITASK_EVAL = dict(episodes=8, horizon=100)
# phase 25: serving at the atari widths. Buckets, the open-loop load (bench.py's
# _serve_load shape: sessions = 8 x the cache, the spill slab at twice the
# sessions), the arrival rates (requests/s) and seconds a rate, the SLO, and
# the sessions of the one large cache
SERVE_BUCKETS = (2, 4, 8, 16, 32)
SERVE_SESSIONS = 256
SERVE_CACHE = 32
SERVE_SPILL = 512
SERVE_RATES = (500, 2000, 8000)
SERVE_SECONDS = 1.5
SERVE_SLO_MS = 50.0
SERVE_STEPS = 4
# the parity check's hold on each pipelined completion (ms): the serve loop
# runs ahead to the depth bound, and a staging set is reused while its
# previous batch is still being completed
SERVE_HOLD_MS = 5.0
SESSIONS_PER_CARD = 1_000_000
# the int8 arm's Q drift against the float arm, as a fraction of the largest
# |Q| (tests/test_serve.py TestServeInt8)
INT8_DRIFT = 0.05
# phase 26: the fleet and the live loop at the atari widths, bf16 as the
# preset ships it, two replicas on one card. The parity sessions and their
# rounds; the queue bound of the ladder's admission check and the shed
# budget it arms; the scenarios' seconds, base rate and sessions; the live
# loop's catch sessions, their request rate each, its save cadence, the
# updates it runs, the updates it runs after the traffic stops (the same
# process, the fleet idle) and its deadline (s), and the tap's queue depth (deep
# enough that the check against the offline accumulator sees no drop)
FLEET_SESSIONS = 16
FLEET_ROUNDS = 3
FLEET_QUEUE = 64
FLEET_SHED_BUDGET = 8
SCENARIO_SECONDS = 2.5
SCENARIO_RATE = 100.0
SCENARIO_SESSIONS = 32
LIVE_SESSIONS = 16
LIVE_RATE = 25.0
LIVE_SAVE_INTERVAL = 8
LIVE_UPDATES = 24
LIVE_IDLE_UPDATES = 8
LIVE_DEADLINE = 45.0
LIVE_TAP_DEPTH = 4096
# phase 27: the pod loop, a learner and two serve hosts as processes on one
# card at the atari preset's widths, the replay cut as phase 26 cuts it;
# the sessions and offered rate of phase 26's live loop, in client
# processes of 4 sessions; the window is stretched past the relaunched h0's
# return (a host takes about 20-28 s to come up on the card) to leave it
# time to serve
POD_SETS = ("buffer_capacity=16000", "learning_starts=2000")
POD_HOSTS = 2
POD_SESSIONS = 16
POD_RATE = 25.0
POD_SECONDS = 36.0
POD_KILL_AT = 0.3
# phase 28: the atari_v4_8 preset (dp=4, batch 64, the paper's 2,000,000
# transitions in four shards) on catch, its four shards on cuda:0, with
# learning_starts cut as the other phases cut it and the preset's 256 actors
# cut to the atari preset's 8; updates timed per K after one dispatch (at
# least 2 updates) that warms the path; the multihost run's two ranks on
# cuda:0 (one shard each, batch 32 a shard), the replay cut as phase 26's
DP_CUT = dict(env_name="catch", learning_starts=2_000, num_actors=8)
DP_KS = (1, 4)
DP_UPDATES = 8
MULTIHOST_SETS = ("buffer_capacity=16000", "learning_starts=2000", "num_actors=8")
MULTIHOST_UPDATES = 8
# phase 29: (a) the reshard drill on the atari_v4_8 preset at dp=4 on cuda:0,
# the replay cut as phase 28's multihost run (16,000 / 2,000): RESHARD_UPDATES
# updates, the cut at RESHARD_AT; (b) the sharded device planes at the
# paper's capacity: supersteps of N x K updates (one warms the path, then
# SUPERSTEPS timed), fused dispatches of K (FUSED_SHARDED_WARM warm, then
# FUSED_SHARDED timed), the two multihost ranks' fused run cut as phase
# 28's (MULTIHOST_FUSED updates); (c) tp and fsdp on the wide model
# (hidden 1024) at the atari widths, TP_UPDATES updates a layout, and one
# bucket of SERVE_MESH_REQUESTS requests served through PolicyServer(mesh=)
RESHARD_UPDATES = 6
RESHARD_AT = 3
SUPERSTEP_NK = (2, 4)
SUPERSTEPS = 2
FUSED_SHARDED_K = 4
FUSED_SHARDED_WARM = 0
FUSED_SHARDED = 2
MULTIHOST_FUSED = 4
FUSED_RANK_STARTS = 600
TP_UPDATES = 2
TP_LAYOUTS = (("manual tp=2 x fsdp=2", 2, 2), ("gspmd tp=2", 2, 1), ("gspmd fsdp=2", 1, 2))
SERVE_MESH_REQUESTS = 32
# the disk-tier check: 2 host blocks and 24 disk blocks under them (an
# 84x84 catch episode fills one 400-step block with 82 steps, so 26 blocks
# reach learning_starts=2,000 and the disk ring wraps soon after)
DISK_CHECK = dict(buffer_capacity=800, replay_disk_capacity=9_600, learning_starts=2_000)
# the row-chunk shapes of phase 9: twice the rows a block holds at once
CHUNKED = ((85, 1024, 512), (85, 256, 2048))
# the wide model preset's hidden size, and the batch at which its
# backward_arm=auto resolves to ("fused_dwh", 0) in bf16 (the default arm's
# 133.7 MB of f32 dz over the 128 MiB budget, the fused arm's bf16 dz under)
WIDE_H = 1024
WIDE_BATCH = 96
T0 = time.perf_counter()


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def say(phase, msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase:6s} {msg}", flush=True)


def smi(query):
    """nvidia-smi's csv line for card 0 and the given fields."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_line():
    return smi("name,power.limit")


def hmma_counts(libraries):
    """{kernel form: [HMMA instructions of each instantiation]} in the SASS
    of the built libraries ({source: path}), by cuobjdump."""
    import re

    from r2d2_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    for src, path in libraries.items():
        out = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                             timeout=120)
        if out.returncode != 0:
            fail(f"cuobjdump -sass {path} failed: {out.stderr.strip()[:300]}")
        for function in out.stdout.split("Function : ")[1:]:
            name = function.split("\n", 1)[0]
            for dtype, form in (("I13__nv_bfloat16", f"{src}_bf16"), ("If", src)):
                if f"{src}_kernel{dtype}" in name:
                    counts.setdefault(form, []).append(len(re.findall(r"\bHMMA\b", function)))
    return counts


def median_ms(fn, reps=15, flush=None):
    """Median of `reps` timed calls (CUDA events), after warm-up; `flush`
    runs untimed before each call so the call finds a cold L2."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want):
    """(max |got - want|, whether every element is within ATOL + RTOL*|want|)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= ATOL + RTOL * want.abs()).all())


def dwh_err(got, want):
    """(max |got - want|, whether it is within DWH_TOL * max |want|)."""
    diff = float((got - want).abs().max())
    return diff, diff <= DWH_TOL * float(want.abs().max())


def drive(cfg, updates, dev):
    """Build a Trainer on cfg, fill its replay, then zero the launch counts,
    run `updates` updates and read the counts. -> (trainer, launches,
    metrics, host ms per update, the updates' peak device memory in GiB
    above what was allocated before them: activations, residuals and
    kernel workspaces, without parameters or optimizer state)."""
    import torch
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer

    tr = Trainer(cfg.replace(training_steps=updates), device=dev)
    tr.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    tr.run_inline()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts.items() if v}
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    m = tr.metrics()
    if m["step"] != updates or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        fail(f"training did not finish with a finite loss: {m}")
    return tr, launches, m, [s * 1e3 for s in tr.update_seconds], peak


def one_update(net, target, cfg, sampled, where, latents=None):
    """(loss, priorities, gradient norm, each parameter's gradient norm) of
    one update of `net` on a sampled batch, on `where`, without stepping
    the optimizer. `latents` = (online, target) encoder outputs for the
    batch's frames hands both networks those latents in place of their
    encoders (whose parameters then take no gradient)."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch, make_loss_fn

    net = copy.deepcopy(net).to(where)
    net.zero_grad(set_to_none=True)
    target = copy.deepcopy(target).to(where)
    if latents is not None:
        net.enc, target.enc = (_Given(x.to(where)) for x in latents)
    b = DeviceBatch.from_sampled(sampled, where)
    denom = torch.clamp(b.learning_steps.sum().float(), min=1.0)
    loss, (prio, _) = make_loss_fn(cfg)(net, target, b, denom)
    loss.backward()
    norms = torch.stack([p.grad.float().norm() for p in net.parameters() if p.grad is not None])
    return [x.detach().cpu() for x in (loss, prio, norms.norm(), norms)]


def _Given(latent):
    """A module standing in for an encoder: returns `latent` whatever its
    input."""
    import torch

    class Given(torch.nn.Module):
        def forward(self, x):
            return latent

    return Given()


def encoder_latents(tr, sampled):
    """The online and target encoders' outputs on the card for a sampled
    batch's frames, as the networks' _core_input computes them."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch

    obs = DeviceBatch.from_sampled(sampled, "cuda").obs
    x = obs.reshape(-1, *obs.shape[2:]).to(tr.state.net.dtype) / 255.0
    with torch.no_grad():
        return tr.state.net.enc(x), tr.state.target_net.enc(x)


AGREE_NAMES = ("loss", "priorities", "grad_norm", "grad_norm per parameter")


def encoder_bound_priorities(tr, label, sampled, results, rtol, atol, dev="cuda"):
    """Print the whole bf16 update's priorities' distance, card against CPU
    (`results` from agree, which holds them at rtol / atol), beside the
    IMPALA encoder's derived rounding bound carried to them, plus rtol /
    atol: how much of the bound the distance takes.

    rounding_bound.impala_rounding_bound gives, latent by latent, how far two
    implementations that round at the same points can be apart (the card's
    cuDNN and the CPU's oneDNN, each summing in float32 in its own order;
    tests/test_torch_impala_bf16.py holds the same bound against flax). A
    sequence's priority depends on its own frames' latents only, so one
    backward of the summed priorities, with the online and the target
    latents as inputs, gives each sequence's sensitivities; to first order
    |dp_b| <= sum_j |dp_b / dz_j| E_j over both networks' latents of row b.
    The bound is that plus atol + rtol |p_cpu|; it is looser than rtol /
    atol alone, so it is printed, not held."""
    import torch
    from r2d2_tpu_torch.learner import DeviceBatch
    from r2d2_tpu_torch.models.rounding_bound import impala_rounding_bound
    from r2d2_tpu_torch.ops.act_tail import first_argmax
    from r2d2_tpu_torch.ops.priority import mixed_td_priorities
    from r2d2_tpu_torch.ops.value_rescale import inverse_value_rescale, value_rescale

    t0 = time.perf_counter()
    cfg, net, target = tr.cfg, tr.state.net, tr.state.target_net
    b = DeviceBatch.from_sampled(sampled, dev)
    x = b.obs.reshape(-1, *b.obs.shape[2:]).to(net.dtype) / 255.0
    zs, es = [], []
    for n in (net, target):
        z, e = impala_rounding_bound(n.enc, x)
        zs.append(z.to(net.dtype).requires_grad_(True))
        es.append(e)
    on, tg = copy.deepcopy(net), copy.deepcopy(target)
    on.enc, tg.enc = _Given(zs[0]), _Given(zs[1])
    args = (b.obs, b.last_action, b.last_reward, b.hidden, b.burn_in_steps,
            b.learning_steps, b.forward_steps, b.task)
    q_learn, q_boot, mask = on(*args)
    _, q_boot_tg, _ = tg(*args)
    a_star = first_argmax(q_boot.detach())
    q_tgt = torch.gather(q_boot_tg, -1, a_star[..., None].long())[..., 0].float()
    eps = cfg.value_rescale_eps
    y = value_rescale(b.n_step_reward.float() + b.gamma.float() * inverse_value_rescale(q_tgt, eps),
                      eps)
    q_taken = torch.gather(q_learn, -1, b.action[..., None])[..., 0].float()
    prio = mixed_td_priorities(torch.abs(y - q_taken) * mask, mask, cfg.td_mix_eta)
    grads = torch.autograd.grad(prio.sum(), zs)
    B = b.obs.shape[0]
    sens = sum((g.float().abs() * e).reshape(B, -1).sum(1) for g, e in zip(grads, es)).cpu()
    card, cpu = results["cuda"][1], results["cpu"][1]
    diff = (card - cpu).abs()
    bound = sens + atol + rtol * cpu.abs()
    e_rel = max(float(e.max()) / float(z.detach().float().abs().max()) for z, e in zip(zs, es))
    say("agree", f"{label} priorities against the encoder's derived bound: max |diff| "
        f"{float(diff.max()):.3e}, the encoder's latent bound up to {e_rel:.3e} of the largest "
        f"latent, carried to the priorities {float(sens.min()):.3e}..{float(sens.max()):.3e} "
        f"(median {float(sens.median()):.3e}); worst |diff| / bound "
        f"{float((diff / bound).max()):.3f}; within rtol {rtol} atol {atol} alone: "
        f"{bool((diff <= atol + rtol * cpu.abs()).all())}; {time.perf_counter() - t0:.1f}s")
    del on, tg, zs, es, grads
    if dev == "cuda":
        torch.cuda.empty_cache()


def agree(tr, label, rtol=1e-4, atol=1e-5, sampled=None, latents=None, results=None):
    """One update on a sampled batch (drawn from the trainer's replay unless
    given) through the kernels on the card against the same update through
    the plain versions on the CPU (with `latents`, both given the card's
    encoder outputs: encoder_latents); prints every comparison, then fails
    if one is outside rtol / atol; -> the batch.
    `results`, a dict, receives both sides' (loss, priorities, gradient
    norm, per-parameter norms) under "cuda" and "cpu".
    Without `results` or `latents` the CPU half runs on copies of the
    networks and the batch taken now, on the agree worker once
    agree_release() or agree_drain() lets it, and agree_drain() prints and
    holds it."""
    if sampled is None:
        sampled = tr.replay.sample_batch(tr.sample_rng)
    t = time.perf_counter()
    nets = (tr.state.net, tr.state.target_net)
    card = one_update(*nets, tr.cfg, sampled, "cuda", latents)
    if results is None and latents is None:
        taken = (*(copy.deepcopy(n).cpu() for n in nets), tr.cfg, copy.deepcopy(sampled))
        _AGREE_PENDING.append((label, rtol, atol, len(sampled.idxes), card,
                               _agree_submit(*taken)))
        return sampled
    results = {} if results is None else results
    results["cuda"] = card
    results["cpu"] = one_update(*nets, tr.cfg, sampled, "cpu", latents)
    agree_report(label, rtol, atol, len(sampled.idxes), card, results["cpu"],
                 time.perf_counter() - t)
    return sampled


# agree's deferred CPU halves: one worker thread (torch's CPU ops release
# the interpreter lock, so the card's phases go on beside it), which runs
# them only while the gate is open: between agree_release() and the next
# agree_drain(), in phases that time no host-bound work and no launch-bound
# sequence (the plain versions' and the libraries' times); the comparisons
# owed, in order. A daemon: a failed phase's exit never waits for it.
_AGREE_WORKER = []
_AGREE_JOBS = queue.Queue()
_AGREE_GATE = threading.Event()
_AGREE_PENDING = []


def _agree_loop():
    while True:
        job, args = _AGREE_JOBS.get()
        _AGREE_GATE.wait()
        try:
            t = time.perf_counter()
            job.set_result((one_update(*args, "cpu"), time.perf_counter() - t))
        except BaseException as e:  # handed to agree_drain, which raises it
            job.set_exception(e)


def _agree_submit(net, target, cfg, sampled):
    if not _AGREE_WORKER:
        _AGREE_WORKER.append(threading.Thread(target=_agree_loop, name="agree", daemon=True))
        _AGREE_WORKER[0].start()
    job = concurrent.futures.Future()
    _AGREE_JOBS.put((job, (net, target, cfg, sampled)))
    return job


def agree_release():
    """Let the agree worker run the CPU halves owed, beside the phases
    that follow, until the next agree_drain()."""
    _AGREE_GATE.set()


def agree_drain():
    """Run every deferred CPU half of agree to its end, print its
    comparisons and fail on the first outside its limits; the gate closes
    again after. Called before phases 11, 15, 17, 20, 25 and 30 (the
    wrappers' dispatch counts); agree_release() before 9, 14 and 19."""
    _AGREE_GATE.set()
    while _AGREE_PENDING:
        label, rtol, atol, rows, card, job = _AGREE_PENDING.pop(0)
        cpu, seconds = job.result()
        agree_report(label, rtol, atol, rows, card, cpu, seconds)
    _AGREE_GATE.clear()


def agree_report(label, rtol, atol, rows, card, cpu, seconds):
    """Print the card's and the CPU's (loss, priorities, gradient norm,
    per-parameter norms) side by side; fail if one is outside rtol / atol."""
    import torch

    bad = []
    for name, a, b in zip(AGREE_NAMES, card, cpu):
        diff = float((a - b).abs().max())
        excess = float(((a - b).abs() - (atol + rtol * b.abs())).max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            bad.append(f"{name} {diff:.3e}")
        say("agree", f"{label} {name}: card {a.flatten()[0].item():.6f} vs cpu "
            f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e}, largest |cpu| "
            f"{float(b.abs().max()):.3e}, excess over rtol {rtol} atol {atol}: {excess:+.3e})")
    say("agree", f"{label}: {rows} rows, {seconds:.1f}s")
    if bad:
        fail(f"{label}: through the kernels differs from the CPU's plain versions: "
             + ", ".join(bad))


# the trainer's host spans (utils/profiling.py); the profiler also shows
# each as a device-side annotation over the kernels it launched
SPANS = ("replay/sample", "replay/staged_chunk", "learner_update", "fused_megastep")


def device_us(e):
    """A profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(events):
    """The device's own events (kernels, copies, memsets) of key_averages():
    not the span annotations, whose time is their kernels' again."""
    return [e for e in events if str(e.device_type).endswith("CUDA") and e.key not in SPANS
            and device_us(e) > 0]


def span_ms(events):
    """{span: (host ms, device ms)} summed over key_averages()."""
    out = {k: [0.0, 0.0] for k in SPANS}
    for e in events:
        if e.key in SPANS:
            cuda = str(e.device_type).endswith("CUDA")
            out[e.key][cuda] += (device_us(e) if cuda else e.cpu_time_total) / 1e3
    return out


def profile_updates(tr, n, label):
    """Run n more updates of a path under torch.profiler; print the device
    time by kernel name and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        tr.run_inline()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    # device-side events only (kernels, copies, memsets): the operators that
    # launch them report the same time again as their own
    events = prof.key_averages()
    rows = sorted(((device_us(e), e.count, e.key) for e in device_events(events)), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    say("prof", f"{label}: {n} updates (actor steps included) in {wall_ms:.1f} ms wall; device busy "
        f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}; per "
        "update, host and device ms under each span: " + ", ".join(
            f"{k} {h / n:.2f} / {d / n:.2f}" for k, (h, d) in span_ms(events).items()))
    for us, count, key in rows[:16]:
        say("prof", f"{us / 1e3 / n:9.3f} ms/update {us / 1e3 / busy_ms:6.1%} x{count // n:<4d} "
            f"{key[:90]}")


def states_equal(a, b):
    """Whether two TrainStates hold the same step and every tensor of their
    networks and optimizer state bit for bit."""
    import torch

    if a.step != b.step:
        return False
    for x, y in ((a.net, b.net), (a.target_net, b.target_net)):
        sx, sy = x.state_dict(), y.state_dict()
        if list(sx) != list(sy) or not all(torch.equal(sx[k], sy[k]) for k in sx):
            return False
    ox, oy = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return bool(ox) and set(ox) == set(oy) and all(
        torch.equal(v, oy[i][k]) for i in ox for k, v in ox[i].items())


def e2e(label, cfg, mode, dev, tmp, expect=None):
    """A path through the entry points a user calls: train with
    checkpoints and a metrics file (run_threaded or run_inline), resume
    from the last checkpoint, evaluate the checkpoint series. The launch
    counts are zeroed just before the run and read just after: by default
    2 forward and 1 seam backward launches an update; `expect(updates)`
    gives another path's."""
    import torch
    from r2d2_tpu_torch.envs.catch import CatchVecEnv, catch_params
    from r2d2_tpu_torch.evaluate import evaluate_series
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.checkpoint import list_checkpoint_steps

    updates, every = E2E[label]
    cfg = cfg.replace(training_steps=updates, save_interval=every, log_interval=0.0,
                      checkpoint_dir=os.path.join(tmp, f"{label}_ckpt"),
                      metrics_path=os.path.join(tmp, f"{label}.jsonl"))
    t = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    tr.warmup()
    K.reset_launch_counts()
    t_run = time.perf_counter()
    (tr.run_threaded if mode == "threaded" else tr.run_inline)()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {k: v for k, v in K.launch_counts.items() if v}
    tr.metrics_logger.close()
    sfx = "_bf16" if cfg.resolved_compute_dtype == "bfloat16" else ""
    want = expect(updates) if expect else {f"lstm_fwd{sfx}": 2 * updates,
                                           f"lstm_seq_bwd{sfx}": updates}
    if launches != want:
        fail(f"e2e {label} {mode}: expected the launches {want}, got {launches}")
    steps = list_checkpoint_steps(cfg.checkpoint_dir)
    if steps != list(range(every, updates + 1, every)):
        fail(f"e2e {label} {mode}: checkpoints {steps}")
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    recs = [r for r in recs if "loss" in r]
    if [r["step"] for r in recs] != list(range(1, updates + 1)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["q_mean"]) for r in recs):
        fail(f"e2e {label} {mode}: the metrics file holds {len(recs)} update records, "
             f"expected {updates} finite ones")
    say("e2e", f"{label} {mode}: {updates} updates in {t_run:.2f}s after warmup "
        f"({time.perf_counter() - t:.1f}s with it), launches {launches}, checkpoints "
        f"{steps}, {len(recs)} metrics records, last {json.dumps(recs[-1])}")
    resumed = Trainer(cfg, device=dev, resume=True)
    if not states_equal(resumed.state, tr.state):
        fail(f"e2e {label}: the resumed TrainState differs from the trained one")
    say("e2e", f"{label}: Trainer(resume=True) restored step {resumed.state.step}, online and "
        f"target nets and the Adam state bit for bit on the card; env steps carried "
        f"{resumed.env_steps_offset}")
    del resumed
    t = time.perf_counter()
    rows = evaluate_series(tr.cfg, CatchVecEnv(8, cfg.obs_shape[0], cfg.obs_shape[1], seed=123,
                                               **catch_params(cfg.env_name)), device=dev)
    if [r["step"] for r in rows] != steps or not all(math.isfinite(r["mean_reward"])
                                                       for r in rows):
        fail(f"e2e {label}: evaluation rows {rows}")
    say("e2e", f"{label}: evaluate_series over {steps} on 8 catch envs in "
        f"{time.perf_counter() - t:.1f}s")
    return tr


def envpool_row(cfg, dev):
    """The threaded host env pool on the bf16 main path, through the entry
    points a user calls: `env_pool_workers` makes train.build_vec_env hand
    the actor a ThreadedHostEnvPool, whose `envpool` threads step the host
    envs while the learner trains ENVPOOL_UPDATES inline updates. Fails
    unless the pool was built, its threads stepped every env step, and the
    updates launched their kernels (counts zeroed just before)."""
    import torch
    from r2d2_tpu_torch.actor import ThreadedHostEnvPool
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer

    t = time.perf_counter()
    tr = Trainer(cfg.replace(env_pool_workers=ENVPOOL_WORKERS, training_steps=ENVPOOL_UPDATES,
                             log_interval=0.0, **ENVPOOL_CUT), device=dev)
    pool = tr.vec_env
    try:
        if type(pool) is not ThreadedHostEnvPool:
            fail(f"envpool: build_vec_env returned {type(pool).__name__}, not the pool")
        tr.warmup()
        K.reset_launch_counts()
        t_run = time.perf_counter()
        tr.run_inline()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        launches = {k: v for k, v in K.launch_counts.items() if v}
        threads = sorted(th.name for th in pool._pool._threads)
    finally:
        pool.close()
    want = {"lstm_fwd_bf16": 2 * ENVPOOL_UPDATES, "lstm_seq_bwd_bf16": ENVPOOL_UPDATES}
    if launches != want:
        fail(f"envpool: expected the launches {want}, got {launches}")
    if not threads or len(threads) > ENVPOOL_WORKERS or not all(
            n.startswith("envpool") for n in threads):
        fail(f"envpool: the pool's threads {threads}")
    if tr.actor.total_steps <= 0 or tr.state.step != ENVPOOL_UPDATES:
        fail(f"envpool: {tr.actor.total_steps} env steps, step {tr.state.step}")
    say("envpool", f"ThreadedHostEnvPool ({ENVPOOL_WORKERS} workers, threads {threads}) "
        f"stepped {tr.cfg.num_actors} scripted envs {tr.actor.total_steps} env steps; "
        f"{ENVPOOL_UPDATES} bf16 updates in {t_run:.2f}s after warmup "
        f"({time.perf_counter() - t:.1f}s with it), launches {launches}")
    return {"workers": ENVPOOL_WORKERS, "threads": threads,
            "env_steps": tr.actor.total_steps, "updates": ENVPOOL_UPDATES,
            "ms_per_update": t_run * 1e3 / ENVPOOL_UPDATES}


def modes(label, cfg, dev, profile):
    """ms per learner update over the wall, acting and sampling included,
    of run_inline and run_threaded (free-running actors, and throttled by
    samples_per_insert to inline's env steps per update; each with the
    batches staged through the pinned ring, and "pageable": the sampler's
    batches copied by DeviceBatch.from_sampled on its thread; inline and
    threaded also with the numpy replay gathers, use_native_replay=False,
    beside the native core's) on one path: after
    2 updates that warm it, MODE_UPDATES more, timed from the end of the
    first to the end of the last (the steady state; run_ms_per_update is
    the whole run's wall, the threads' start and stop included); TransferTimer's overlap, h2d and wait seconds;
    the updates' peak device memory above what was allocated before them
    (in threaded mode with the queued batches). Then PROFILED_UPDATES more
    under torch.profiler (for inline and threaded mode always, native and
    numpy; for the other rows with `profile`): the device's busy share and
    the host time under each span."""
    import torch
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.profiling import start_trace

    out = {}
    # the samples_per_insert at which threaded mode acts as much per update
    # as inline mode (one actor step of num_actors env steps per update)
    matched = cfg.batch_size * cfg.learning_steps / cfg.num_actors
    for mode, spi, native in (
            ("inline", 0.0, True), ("threaded", 0.0, True), ("threaded pageable", 0.0, True),
            ("threaded", matched, True), ("threaded pageable", matched, True),
            ("inline", 0.0, False), ("threaded", 0.0, False)):
        tr = Trainer(cfg.replace(training_steps=2, samples_per_insert=spi,
                                 use_native_replay=native), device=dev)
        if mode == "threaded pageable":
            tr._sample_staged = tr.sample  # the sampler copies as inline mode does
        run = tr.run_inline if mode == "inline" else tr.run_threaded
        run()
        # inline and threaded mode, with the native core and with numpy, are
        # always profiled too: the host time under replay/sample and the
        # device's busy share
        profiled = profile or (not spi and mode in ("inline", "threaded"))
        if spi:
            mode = f"{mode} spi={spi:g}"
        if not native:
            mode = f"{mode} numpy"
        row = {"path": label, "mode": mode}
        for phase in ("timed", "profiled") if profiled else ("timed",):
            n = MODE_UPDATES if phase == "timed" else PROFILED_UPDATES
            tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n)
            tr.xfer.reset()
            acted = tr.actor.total_steps
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            prof = start_trace() if phase == "profiled" else None
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if prof is None:
                ends = tr.update_ends[-MODE_UPDATES:]
                row.update(ms_per_update=(ends[-1] - ends[0]) * 1e3 / (MODE_UPDATES - 1),
                           run_ms_per_update=wall_ms / MODE_UPDATES,
                           env_steps_per_update=(tr.actor.total_steps - acted) / MODE_UPDATES,
                           peak_gib=(torch.cuda.max_memory_allocated() - before) / 2**30,
                           **(tr.xfer.stats() if run == tr.run_threaded else {}))
                continue
            prof.__exit__(None, None, None)
            events = prof.key_averages()
            busy = sum(device_us(e) for e in device_events(events)) / 1e3
            row.update(profiled_ms_per_update=wall_ms / n, device_busy=busy / wall_ms)
            for k, (host, device) in span_ms(events).items():
                row[f"{k}_host_ms_per_update"] = host / n
                row[f"{k}_device_ms_per_update"] = device / n
            # inline: the actor's share; threaded: the spans overlap on
            # their threads, and this is what the main thread's span leaves
            row["rest_ms_per_update"] = row["profiled_ms_per_update"] - sum(
                row[f"{k}_host_ms_per_update"] for k in SPANS)
        say("modes", json.dumps(row))
        out[mode] = row
        del tr
    say("modes", f"{label}: ms per update over the wall of {MODE_UPDATES} updates, acting "
        "included (env steps per update): " + ", ".join(
            f"{m} {r['ms_per_update']:.2f} ({r['env_steps_per_update']:.1f})"
            for m, r in out.items()))
    say("modes", f"{label}: replay/sample host ms per update and the device's busy share, "
        "profiled: " + ", ".join(
            f"{m} {r['replay/sample_host_ms_per_update']:.2f} ms, {r['device_busy']:.1%}"
            for m, r in out.items() if "device_busy" in r))
    return out


def openmp_runtimes():
    """The OpenMP runtime libraries (GNU, LLVM or Intel) mapped into this
    process."""
    import re

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if line.strip()}
    return sorted(p for p in paths if re.match(r"lib(g|i|)omp", os.path.basename(p)))


def native_phase(tr):
    """The native replay core at the main path's shapes: a numpy ReplayBuffer
    given the trainer's replay contents (every store, the sum tree and the
    ring's counters) and both sampled with equal Generator streams must give
    the same batches bit for bit; then both sample_batch host times, the
    gather's OpenMP threads and the OpenMP runtimes in the process (torch's
    and the core's)."""
    import numpy as np
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    native = tr.replay
    if native.native is None:
        fail("native: the main path's replay does not run the native core")
    numpy_rb = ReplayBuffer(tr.cfg.replace(use_native_replay=False))
    for k, v in vars(native).items():
        if isinstance(v, np.ndarray):
            setattr(numpy_rb, k, v.copy())
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            setattr(numpy_rb, k, v)
    numpy_rb.tree.tree[:] = native.tree.tree
    for seed in range(NATIVE_COMPARES):
        a = native.sample_batch(np.random.default_rng(seed))
        b = numpy_rb.sample_batch(np.random.default_rng(seed))
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = (np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
                    if isinstance(x, np.ndarray) else x == y)
            if not same:
                fail(f"native: sample_batch's {f.name} differs from the numpy path's (seed {seed})")
    times = {}
    for label, rb in (("native", native), ("numpy", numpy_rb)):
        rng = np.random.default_rng(0)
        ts = []
        for _ in range(NATIVE_TIMED):
            t = time.perf_counter()
            rb.sample_batch(rng)
            ts.append((time.perf_counter() - t) * 1e3)
        times[label] = statistics.median(ts)
    c = tr.cfg
    say("native", f"{NATIVE_COMPARES} batches at B={c.batch_size} T={c.seq_len} obs "
        f"{c.obs_shape} ({c.batch_size * c.seq_len * math.prod(c.obs_shape) / 1e6:.1f} MB of "
        f"frames) equal the numpy path's bit for bit; sample_batch host ms, median of "
        f"{NATIVE_TIMED}: native {times['native']:.2f}, numpy {times['numpy']:.2f}; the gather "
        f"runs {native.native.gather_threads()} OpenMP threads; OpenMP runtimes in the "
        f"process: {openmp_runtimes()}")


def long_context_phase(dev, tmp):
    """The long_context preset at full width (memory_catch:10:8:4 at 26x26,
    IMPALA (8, 16), LRU hidden 128, T=581, B=64) as it ships (bf16) and in
    float32: LC_UPDATES inline updates (no LSTM kernel may launch), ms per
    update, the update's peak memory and the LRU core's own, the wall per
    update over acting and sampling; agreement with the CPU (float32: the
    same LC_AGREE updates stepped on both, update for update; bf16: one
    update); lru_chunk=128: one update that agrees with the scan form on the
    same batch; then e2e (checkpoints, bitwise resume, evaluate_series).
    Only the host replay sizes are cut."""
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.learner import DeviceBatch, make_optimizer, make_train_step
    from r2d2_tpu_torch.models.r2d2 import R2D2Network

    for label, extra, tol in (("bf16", {}, BF16_AGREE),
                              ("fp32", {"compute_dtype": "float32"}, {})):
        cfg = PRESETS["long_context"]().replace(**LONG_CONTEXT_CUT, **extra)
        t = time.perf_counter()
        tr, launches, m, ms, peak = drive(cfg, LC_UPDATES, dev)
        ends = tr.update_ends
        wall = (ends[-1] - ends[0]) * 1e3 / (len(ends) - 1)
        c = tr.cfg
        say("long", f"{label}: {c.env_name} obs {c.obs_shape}, {c.encoder} "
            f"{c.impala_channels}, {c.recurrent_core} hidden {c.hidden_dim}, T={c.seq_len} "
            f"({c.burn_in_steps}/{c.learning_steps}/{c.forward_steps}), batch {c.batch_size}, "
            f"{c.resolved_compute_dtype}, cosine lr, arm {tr.backward_arm}; cut: "
            f"buffer_capacity {c.buffer_capacity} (preset 2048000), learning_starts "
            f"{c.learning_starts} (preset 50000); {LC_UPDATES} updates, loss {m['loss']:.6f}; "
            f"ms/update {', '.join(f'{v:.1f}' for v in ms)} (host clock); wall per update "
            f"over acting and sampling {wall:.1f} ms; update peak device memory {peak:.3f} GiB; "
            f"LSTM kernel launches {launches} ({time.perf_counter() - t:.1f}s with warmup)")
        if launches:
            fail(f"long_context {label}: the LRU path launched LSTM kernels: {launches}")
        if c.resolved_compute_dtype != ("bfloat16" if label == "bf16" else "float32"):
            fail(f"long_context {label}: compute dtype {c.resolved_compute_dtype}")
        say("long", f"{label}: the LRU core alone (forward and backward, B={c.batch_size} "
            f"T={c.seq_len}): peak {lru_core_peak(tr, dev):.3f} GiB above its inputs")

        # the CPU, update for update (bf16: one update)
        if label == "fp32":
            states = {}
            for where in ("cuda", "cpu"):
                s_ = copy.deepcopy(tr.state)
                for net in (s_.net, s_.target_net):
                    net.to(where)
                s_.optimizer = make_optimizer(c, s_.net.parameters())
                s_.optimizer.load_state_dict(tr.state.optimizer.state_dict())
                states[where] = s_
            step = make_train_step(c)
            for i in range(LC_AGREE):
                sampled = tr.replay.sample_batch(tr.sample_rng)
                res = {w: step(states[w], DeviceBatch.from_sampled(sampled, w))
                       for w in states}
                for name, a, b in (("loss", res["cuda"][1]["loss"], res["cpu"][1]["loss"]),
                                   ("priorities", res["cuda"][2], res["cpu"][2])):
                    a, b = a.detach().cpu(), b.detach()
                    diff = float((a - b).abs().max())
                    if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                        fail(f"long_context fp32 update {i + 1}: {name} on the card differs "
                             f"from the CPU's: {diff:.3e}")
                    say("agree", f"long_context fp32 update {i + 1} {name}: max |card - cpu| "
                        f"{diff:.3e} (rtol 1e-4 atol 1e-5)")
            for (name, a), b in zip(states["cuda"].net.state_dict().items(),
                                    states["cpu"].net.state_dict().values()):
                if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5):
                    fail(f"long_context fp32: parameter {name} after {LC_AGREE} updates "
                         f"differs: {float((a.cpu() - b).abs().max()):.3e}")
            say("agree", f"long_context fp32: every parameter after {LC_AGREE} updates within "
                "rtol 1e-4 atol 1e-5 of the CPU's")
            del states
        else:
            agree(tr, "long_context bf16", **tol)

        # lru_chunk=128: one update on the card against the scan form
        k_cfg = c.replace(lru_chunk=LC_CHUNK, training_steps=1)
        k_tr, k_launches, k_m, k_ms, k_peak = drive(k_cfg, 1, dev)
        if k_launches:
            fail(f"long_context {label} lru_chunk: LSTM kernel launches {k_launches}")
        sampled = tr.replay.sample_batch(tr.sample_rng)
        res = {}
        for form, f_cfg in (("scan", c), ("chunk", k_cfg)):
            nets = []
            for src in (tr.state.net, tr.state.target_net):
                n = R2D2Network.from_config(f_cfg, device=dev)
                n.load_state_dict(src.state_dict())
                nets.append(n)
            res[form] = one_update(*nets, f_cfg, sampled, "cuda")
        rt = tol.get("rtol", 1e-4)
        at = tol.get("atol", 1e-5)
        for name, a, b in zip(("loss", "priorities", "grad_norm", "grad_norm per parameter"),
                              res["chunk"], res["scan"]):
            diff = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=rt, atol=at):
                fail(f"long_context {label}: lru_chunk={LC_CHUNK}'s {name} differs from the "
                     f"scan form's: {diff:.3e}")
        say("long", f"{label} lru_chunk={LC_CHUNK}: 1 update {k_ms[0]:.1f} ms, peak "
            f"{k_peak:.3f} GiB; one update on a sampled batch agrees with the scan form "
            f"(loss {float(res['chunk'][0]):.6f} vs {float(res['scan'][0]):.6f}; rtol {rt} "
            f"atol {at})")
        del k_tr

        e2e(f"long_context {label}", cfg, "inline", dev, tmp, expect=lambda n: {})
        del tr


def lru_core_peak(tr, dev):
    """Peak device memory (GiB) of one forward and backward of a trainer's
    LRU core alone, on a batch of its width and length, above its inputs."""
    import torch

    c = tr.cfg
    core = copy.deepcopy(tr.state.net.core)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(c.batch_size, c.seq_len, core.in_dim, device=dev, generator=g)
    x = x.to(c.torch_compute_dtype).requires_grad_(True)
    carry = (torch.zeros(c.batch_size, c.hidden_dim, device=dev),) * 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    outs, _ = core(x, carry)
    outs.float().sum().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**30


# the trainer CLI as `python -m r2d2_tpu_torch.train`, with every priority
# write-back recorded in order ((idxes, priorities) per update) into the npz
# named by PRIOS_OUT at exit (the preemption's exit code included)
_RECORDED_CLI = """
import atexit, os, runpy, sys
import numpy as np
from r2d2_tpu_torch.replay.control_plane import ReplayControlPlane
calls = []
update = ReplayControlPlane.update_priorities
def record(self, idxes, td, *a, **kw):
    calls.append((np.array(idxes), np.array(td)))
    return update(self, idxes, td, *a, **kw)
ReplayControlPlane.update_priorities = record
atexit.register(lambda: np.savez(os.environ["PRIOS_OUT"], *[x for c in calls for x in c]))
sys.argv = ["r2d2_tpu_torch.train"] + sys.argv[1:]
runpy.run_module("r2d2_tpu_torch.train", run_name="__main__", alter_sys=True)
"""


def cli_main(main, args, fault=None):
    """An entry point's main(ARGS) in this process (no interpreter start or
    CUDA context of its own): -> (exit code, the JSON lines it printed).
    Launch counts are zeroed first; `fault` is R2D2_FAULTS for the call."""
    import contextlib
    import io

    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.utils import faults

    buf = io.StringIO()
    code = 0
    K.reset_launch_counts()
    if fault:
        os.environ["R2D2_FAULTS"] = fault
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        os.environ.pop("R2D2_FAULTS", None)
        faults.uninstall()
    return code, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def train_main(args, fault=None):
    """`python -m r2d2_tpu_torch.train ARGS` in this process (cli_main):
    -> (exit code, its JSON line or {})."""
    from r2d2_tpu_torch import train

    code, lines = cli_main(train.main, args, fault)
    return code, (lines[-1] if lines else {})


def run_cli(tmp, tag, ckpt, args, faults=None):
    """One trainer CLI run of the preemption drill (bf16 atari preset on
    catch, replay cut). -> (exit code, last JSON line or None, per-update
    losses {step: loss}, per-update (idxes, priorities), stderr tail)."""
    return finish_cli(start_cli(tmp, tag, ckpt, args, faults))


def start_cli(tmp, tag, ckpt, args, faults=None):
    """run_cli's process, started and not waited for (finish_cli waits):
    independent runs of the drill share the card at once."""
    metrics = os.path.join(tmp, f"{tag}.jsonl")
    prios = os.path.join(tmp, f"{tag}_prios.npz")
    cmd = [sys.executable, "-c", _RECORDED_CLI, "--preset", "atari", "--env", "catch",
           "--mode", "inline", "--steps", str(PREEMPT_UPDATES), "--snapshot-replay",
           "--metrics", metrics,
           "--set", f"buffer_capacity={ON_CATCH_BF16['buffer_capacity']}",
           "--set", f"learning_starts={ON_CATCH_BF16['learning_starts']}",
           "--set", f"checkpoint_dir={ckpt}", "--set", f"save_interval={PREEMPT_UPDATES}",
           "--set", "log_interval=0", *args]
    env = {**os.environ, "PYTHONPATH": HERE, "PRIOS_OUT": prios}
    env.pop("R2D2_FAULTS", None)
    if faults:
        env["R2D2_FAULTS"] = faults
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tag, faults, metrics, prios, time.perf_counter()


def finish_cli(started):
    """Wait for a start_cli process (killed after 900 s) -> run_cli's
    tuple."""
    proc, tag, faults, metrics, prios, t = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    last = None
    for line in reversed(out.stdout.strip().splitlines()):
        if line.startswith("{"):
            last = json.loads(line)
            break
    losses = {}
    if os.path.exists(metrics):
        for line in open(metrics):
            r = json.loads(line)
            if "loss" in r:
                losses[r["step"]] = r["loss"]
    calls = []
    if os.path.exists(prios):
        import numpy as np

        with np.load(prios) as d:
            arrs = [d[f"arr_{i}"] for i in range(len(d.files))]
        calls = list(zip(arrs[0::2], arrs[1::2]))
    say("preempt", f"{tag}: exit {out.returncode} in {time.perf_counter() - t:.1f}s"
        + (f" ({faults})" if faults else "") + f"; {len(calls)} updates recorded; "
        f"last line {json.dumps(last)}")
    return out.returncode, last, losses, calls, out.stderr[-3000:]


def load_checkpoint_tensors(ckpt, step):
    """{name: tensor} of every network and Adam tensor of a checkpoint."""
    import torch

    p = torch.load(os.path.join(ckpt, f"step_{step}", "state.pt"), map_location="cpu",
                   weights_only=True)
    out = {f"net.{k}": v for k, v in p["net"].items()}
    out.update({f"target_net.{k}": v for k, v in p["target_net"].items()})
    for i, st in p["optimizer"]["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def preempt_phase(dev, tmp):
    """Phase 19: the preemption protocol on the card. Three CLI runs of the
    bf16 main path (the first two at once): uninterrupted for
    PREEMPT_UPDATES updates, cut by
    R2D2_FAULTS="trainer.update@PREEMPT_AT=sigterm" (exit 85, the replay
    snapshot with its carry and a finalized checkpoint at the cut), then
    --resume (exit 0). The first resumed update's loss and priorities must
    equal the uninterrupted run's at that step bit for bit, and so must the
    final networks, Adam state and replay; if the final state differs, a
    second uninterrupted run tells a card that does not reproduce its
    backward from process to process (the state then held to the fp32-update
    limit and the differing tensors named) from a resume at fault (which
    fails). Then an fp32 cut in-process: request_preempt during
    run_threaded, the resume bitwise, and its launches."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step

    n, k = PREEMPT_UPDATES, PREEMPT_AT
    t0 = time.perf_counter()
    a_dir, bc_dir = os.path.join(tmp, "a"), os.path.join(tmp, "bc")
    # the uninterrupted and the cut run are independent processes: both at once
    runs = [start_cli(tmp, "uninterrupted", a_dir, []),
            start_cli(tmp, "cut", bc_dir, [], faults=f"trainer.update@{k}=sigterm")]
    try:
        rc_a, last_a, loss_a, prio_a, err_a = finish_cli(runs[0])
    finally:
        rc_b, last_b, loss_b, prio_b, err_b = finish_cli(runs[1])
    if rc_a != 0 or len(prio_a) != n:
        fail(f"preempt: the uninterrupted run exited {rc_a}: {err_a}")
    snap = os.path.join(bc_dir, "replay_snapshot.npz")
    if rc_b != 85 or not (last_b or {}).get("preempted"):
        fail(f"preempt: the SIGTERM run exited {rc_b}, not 85: {err_b}")
    if latest_checkpoint_step(bc_dir) != k or not os.path.exists(snap):
        fail(f"preempt: after the cut the checkpoints end at {latest_checkpoint_step(bc_dir)} "
             f"(want {k}), snapshot present: {os.path.exists(snap)}")
    with np.load(snap) as d:
        carry_step = int(d["x_carry_step"])
        carried = sorted({key.split("_")[1] for key in d.files if key.startswith("x_")})
    if carry_step != k:
        fail(f"preempt: the snapshot's carry is at step {carry_step}, not {k}")
    say("preempt", f"cut at step {k}: exit 85, checkpoint step_{k}, replay_snapshot.npz "
        f"{os.path.getsize(snap) / 1e6:.1f} MB with the carry ({', '.join(carried)})")
    rc_c, last_c, loss_c, prio_c, err_c = run_cli(tmp, "resumed", bc_dir, ["--resume"])
    if rc_c != 0 or (last_c or {}).get("resumed_from") != k or last_c.get("step") != n:
        fail(f"preempt: the resumed run exited {rc_c} ({last_c}): {err_c}")

    def same_update(la, pa, lb, pb):
        return la == lb and np.array_equal(pa[0], pb[0]) and np.array_equal(pa[1], pb[1])

    first_ok = same_update(loss_a.get(k + 1), prio_a[k], loss_c.get(k + 1), prio_c[0])
    prefix_ok = all(same_update(loss_a.get(i + 1), prio_a[i], loss_b.get(i + 1), prio_b[i])
                    for i in range(k))
    say("preempt", f"update {k + 1}, the first resumed: loss {loss_c.get(k + 1)!r} vs the "
        f"uninterrupted run's {loss_a.get(k + 1)!r}; priorities max |diff| "
        f"{float(np.abs(prio_c[0][1] - prio_a[k][1]).max()):.3e}, idxes equal "
        f"{np.array_equal(prio_c[0][0], prio_a[k][0])}: "
        f"{'bit for bit' if first_ok else 'DIFFERENT'}; updates 1-{k} of the cut run against "
        f"the uninterrupted run's: {'bit for bit' if prefix_ok else 'DIFFERENT'}")
    ta, tc = load_checkpoint_tensors(a_dir, n), load_checkpoint_tensors(bc_dir, n)
    differ = [name for name in ta if not torch.equal(ta[name], tc[name])]
    with np.load(os.path.join(a_dir, "replay_snapshot.npz")) as da, \
            np.load(os.path.join(bc_dir, "replay_snapshot.npz")) as dc:
        replay_differ = [key for key in da.files
                         if key not in dc.files or not np.array_equal(da[key], dc[key])]
    if first_ok and not differ and not replay_differ:
        say("preempt", f"step {n}: networks, Adam state ({len(ta)} tensors) and the whole "
            f"replay ({len(replay_differ) or 'every'} array of the snapshot) equal the "
            "uninterrupted run's bit for bit; updates "
            f"{k + 1}-{n} losses equal: {all(loss_a[i] == loss_c[i] for i in range(k + 1, n + 1))}"
            f" ({time.perf_counter() - t0:.1f}s)")
    else:
        # a second uninterrupted run: does the card reproduce its own run?
        a2_dir = os.path.join(tmp, "a2")
        rc_2, _, loss_2, prio_2, err_2 = run_cli(tmp, "uninterrupted again", a2_dir, [])
        if rc_2 != 0:
            fail(f"preempt: the second uninterrupted run exited {rc_2}: {err_2}")
        t2 = load_checkpoint_tensors(a2_dir, n)
        repro = [name for name in ta if not torch.equal(ta[name], t2[name])]
        steps_2 = [i + 1 for i in range(n)
                   if not same_update(loss_a.get(i + 1), prio_a[i], loss_2.get(i + 1), prio_2[i])]
        if not repro and not steps_2:
            fail(f"preempt: two uninterrupted runs agree bit for bit but the resumed one does "
                 f"not: the resume path is at fault (first update equal {first_ok}; tensors "
                 f"{differ[:8]}; replay arrays {replay_differ[:8]})")
        say("preempt", f"two uninterrupted runs differ from process to process: updates "
            f"{steps_2} differ, final tensors {len(repro)} of {len(ta)} differ, first "
            f"{repro[:6]}; the card does not reproduce its update across processes")
        worst = 0.0
        for name in ta:
            a_, c_ = ta[name].float(), tc[name].float()
            worst = max(worst, float((a_ - c_).abs().max()))
            if not torch.allclose(c_, a_, rtol=1e-4, atol=1e-5):
                fail(f"preempt: {name} after the resume differs from the uninterrupted run's "
                     f"beyond rtol 1e-4 atol 1e-5: {float((a_ - c_).abs().max()):.3e}")
        la, lc = loss_a[k + 1], loss_c[k + 1]
        if abs(la - lc) > 1e-5 + 1e-4 * abs(la) or not np.allclose(
                prio_c[0][1], prio_a[k][1], rtol=1e-4, atol=1e-5):
            fail(f"preempt: the first resumed update leaves the fp32-update limit: loss "
                 f"{lc!r} vs {la!r}")
        say("preempt", f"held at the fp32-update limit instead (rtol 1e-4 atol 1e-5): the "
            f"first resumed update and every final tensor (max |diff| {worst:.3e}); differing "
            f"replay arrays {replay_differ[:8]}")

    # the threaded cut, fp32, in-process ----------------------------------
    updates, cut = THREADED_CUT
    cfg = PRESETS["atari"]().replace(**ON_CATCH, training_steps=updates, snapshot_replay=True,
                                     save_interval=1000,
                                     checkpoint_dir=os.path.join(tmp, "threaded"))
    tr = Trainer(cfg, device=dev)
    tr.warmup()
    one = tr._one_update

    def update_then_cut(item):
        out = one(item)
        if tr._step == cut:
            tr.request_preempt()
        return out

    tr._one_update = update_then_cut
    K.reset_launch_counts()
    tr.run_threaded()
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if not tr.preempted or tr._step != cut or latest_checkpoint_step(cfg.checkpoint_dir) != cut:
        fail(f"preempt: the threaded cut stopped at step {tr._step} (preempted "
             f"{tr.preempted}), checkpoint {latest_checkpoint_step(cfg.checkpoint_dir)}")
    if launches != {"lstm_fwd": 2 * cut, "lstm_seq_bwd": cut}:
        fail(f"preempt: the threaded run's launches {launches}")
    resumed = Trainer(cfg, device=dev, resume=True)
    if not states_equal(resumed.state, tr.state) or resumed.replay.env_steps != \
            tr.replay.env_steps or resumed.actor.total_steps != tr.actor.total_steps:
        fail("preempt: the threaded cut's resume differs from the cut state")
    K.reset_launch_counts()
    resumed.run_threaded()
    torch.cuda.synchronize()
    r_launches = {key: v for key, v in K.launch_counts.items() if v}
    if resumed._step != updates or r_launches != {"lstm_fwd": 2 * (updates - cut),
                                                  "lstm_seq_bwd": updates - cut}:
        fail(f"preempt: the threaded resume reached step {resumed._step}, launches "
             f"{r_launches}")
    say("preempt", f"fp32 run_threaded cut by request_preempt at step {cut}: launches "
        f"{launches}, checkpoint and snapshot at the cut; Trainer(resume=True) restored "
        f"the networks, Adam state, replay ({resumed.replay.env_steps} env steps) and the "
        f"actor's streams; the resumed run_threaded reached step {updates} with launches "
        f"{r_launches} ({time.perf_counter() - t0:.1f}s in the phase)")


def rss_gib():
    """This process's resident memory, GiB (/proc/self/status VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def tiered_rows(label, base, dev, specs=None):
    """Phase 20's rows of one compute dtype (and phase 21's, given `specs`,
    (plane, K, N, capacity) each): the host plane (native core) and the
    tiered plane at K in TIERED_KS, all at TIERED_CAPACITY, inline:
    2 dispatches that warm the path, TIERED_UPDATES updates timed (ms per
    update over the wall, acting included; launches, counted from 0 just
    before; the update peak; TransferTimer), then TIERED_PROFILED more under
    the profiler (the spans' host ms per update, the device's busy share).
    -> {row: dict}, and the last tiered trainer."""
    import gc

    import torch
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer
    from r2d2_tpu_torch.utils.profiling import start_trace

    sfx = "_bf16" if base.resolved_compute_dtype == "bfloat16" else ""
    if specs is None:
        specs = [("host", 1, 1, base.buffer_capacity)] + [
            ("tiered", k, 1, base.buffer_capacity) for k in TIERED_KS]
    out, last = {}, None
    for plane, k, n_super, capacity in specs:
        row = {"path": label, "plane": plane, "K": k, "capacity": capacity}
        q = k * n_super  # updates per dispatch (per superstep on the device tree)
        extra = {}
        if n_super > 1:
            row["N"] = n_super
            extra = dict(priority_plane="device", superstep_dispatches=n_super)
        rss0 = rss_gib()
        cfg = base.replace(replay_plane=plane, updates_per_dispatch=k, training_steps=2 * q,
                           buffer_capacity=capacity, **extra)
        tr = Trainer(cfg, device=dev)
        tr.run_inline()
        row["rss_gib"], row["rss_added_gib"] = rss_gib(), rss_gib() - rss0
        if plane == "device":
            row["store_gb_on_card"] = tr.replay.nbytes() / 1e9
        else:
            row["obs_store_virtual_gb"] = tr.replay.obs_store.nbytes / 1e9
        for phase in ("timed", "profiled"):
            # whole dispatches, and two to time between (a superstep is 8)
            n = TIERED_UPDATES if phase == "timed" else TIERED_PROFILED
            n = -(-max(n, 2 * q if phase == "timed" else q) // q) * q
            tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n)
            tr.xfer.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            K.reset_launch_counts()
            prof = start_trace() if phase == "profiled" else None
            t0 = time.perf_counter()
            tr.run_inline()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {key: v for key, v in K.launch_counts.items() if v}
            if launches != {f"lstm_fwd{sfx}": 2 * n, f"lstm_seq_bwd{sfx}": n}:
                fail(f"tiered {label} {plane} K={k}: {n} updates launched {launches}")
            if prof is None:
                ends = tr.update_ends[-(n // q):]
                row.update(ms_per_update=(ends[-1] - ends[0]) * 1e3 / ((len(ends) - 1) * q),
                           launches_per_dispatch={key: v * q // n for key, v in launches.items()},
                           peak_gib=(torch.cuda.max_memory_allocated() - before) / 2**30,
                           allocated_gib=before / 2**30, **tr.xfer.stats())
                if plane == "tiered":
                    row["slab_mb"] = tr.plane.ring.nbytes() / 1e6
                    row["pinned_mb"] = 2 * tr.plane.ring.nbytes() / 1e6
                continue
            prof.__exit__(None, None, None)
            events = prof.key_averages()
            busy = sum(device_us(e) for e in device_events(events)) / 1e3
            row.update(profiled_ms_per_update=wall_ms / n, device_busy=busy / wall_ms)
            for key, (host, device) in span_ms(events).items():
                row[f"{key}_host_ms_per_update"] = host / n
        if not math.isfinite(tr.metrics()["loss"]):
            fail(f"tiered {label} {plane} K={k}: loss {tr.metrics()['loss']}")
        say("tiered" if plane != "device" else "device", json.dumps(row))
        out[f"{plane} K={k}" + (f" N={n_super}" if n_super > 1 else "")] = row
        if plane == "tiered":
            del last
            last = tr
        else:
            del tr
        gc.collect()
        torch.cuda.empty_cache()
    return out, last


def tiered_phase(dev, tmp):
    """Phase 20: the tiered plane at the paper's 2,000,000-transition
    replay (the atari preset on catch, learning_starts cut to 2,000), bf16
    and fp32, K=1 and 4, beside the host plane in the same call (rows:
    tiered_rows); then, with deterministic_staging, a chunk copied back from
    the card equals K host-plane draws from the same Generator state and
    contents bit for bit, its priority write-backs reach the tree; then the
    disk tier (2 host blocks, 24 disk blocks, delta-zlib): draws of
    disk-resident rows equal the rows written, and a write-back whose slot
    was overwritten is dropped."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
    from r2d2_tpu_torch.replay.sum_tree import SumTree
    from r2d2_tpu_torch.replay.tiered_store import stage_chunk
    from r2d2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    card = card_line()
    rows = {}
    b_cfg = PRESETS["atari"]().replace(env_name="catch", buffer_capacity=TIERED_CAPACITY,
                                       learning_starts=ON_CATCH["learning_starts"])
    for label, extra in (("bf16", {}), ("fp32", {"compute_dtype": "float32"})):
        r, tr = tiered_rows(label, b_cfg.replace(**extra), dev)
        rows[label] = r
        if label == "bf16":
            keep = tr
        else:
            del tr
    say("tiered", f"[{card}] ms per update over the wall (acting included), "
        f"{TIERED_UPDATES} updates, replay {TIERED_CAPACITY}: " + "; ".join(
            f"{label} " + ", ".join(f"{name} {r['ms_per_update']:.2f}" for name, r in rs.items())
            for label, rs in rows.items()))
    def sampling_ms(r):
        return (r["replay/sample_host_ms_per_update"]
                + r["replay/staged_chunk_host_ms_per_update"])

    say("tiered", "busy share, span host ms per update (replay/sample or replay/staged_chunk, "
        "learner_update), h2d overlap: " + "; ".join(
            f"{label} {name} {r['device_busy']:.1%}, {sampling_ms(r):.2f}, "
            f"{r['learner_update_host_ms_per_update']:.2f}, {r['h2d_overlap_fraction']:.3f}"
            for label, rs in rows.items() for name, r in rs.items()))

    # deterministic staging: a chunk on the card equals K host draws
    tr, k = keep, TIERED_KS[-1]
    rp = tr.replay
    state = tr.sample_rng.bit_generator.state
    chunk = stage_chunk(rp, tr.sample_rng, k, tr.plane.ring)
    torch.cuda.current_stream().wait_event(chunk.event)
    got = {name: t.cpu().numpy() for name, t in chunk.batch.items()}
    got["hidden"] = got["hidden"].view(np.uint16) if got["hidden"].dtype == np.int16 else \
        got["hidden"]
    spec = np.random.default_rng()
    spec.bit_generator.state = state
    for j in range(k):
        b = ReplayBuffer.sample_batch(rp, spec)
        for name, v in got.items():
            if not np.array_equal(v[j], getattr(b, name)):
                fail(f"tiered: staged batch {j}'s {name} differs from the host plane's draw")
        if not np.array_equal(chunk.idxes[j], b.idxes):
            fail(f"tiered: staged batch {j}'s idxes differ from the host plane's")
    if spec.bit_generator.state != tr.sample_rng.bit_generator.state:
        fail("tiered: the stage consumed the Generator differently from K host draws")
    written = []
    apply = rp.update_priorities

    def recording(idx, td, *a):
        written.append((np.array(idx), np.array(td)))
        return apply(idx, td, *a)

    rp.update_priorities = recording
    tr.state, _ = tr.plane.update(tr.state, chunk)
    tr.plane.drain_pending()
    rp.update_priorities = apply
    ref = SumTree(rp.tree.capacity, rp.tree.prio_exponent, rp.tree.is_exponent, native=rp.native)
    for idx, td in written:
        ref.update(idx, td)
    idx_all = np.concatenate([w[0] for w in written])
    if len(written) != k or not np.array_equal(rp.tree.priorities_of(idx_all),
                                               ref.priorities_of(idx_all)):
        fail(f"tiered: the dispatch's {len(written)} write-backs did not reach the tree")
    say("tiered", f"deterministic staging at K={k}: the chunk copied back from the card equals "
        f"{k} host-plane draws from the same Generator state bit for bit (every field); "
        f"its {k} write-backs reached the tree ({len(idx_all)} leaves)")
    del keep, tr

    # the disk tier below the host slab ------------------------------------
    d_cfg = PRESETS["atari"]().replace(
        env_name="catch", replay_plane="tiered", updates_per_dispatch=2,
        deterministic_staging=True, block_codec="delta-zlib", training_steps=2,
        replay_disk_dir=os.path.join(tmp, "disk"), **DISK_CHECK)
    tr = Trainer(d_cfg, device=dev)
    rp = tr.replay
    blocks = []
    push = tr.actor.push_block

    def keep_block(block, prios, ep):
        blocks.append((block.obs.copy(), block.action.copy(), block.burn_in_steps.copy()))
        return push(block, prios, ep)

    tr.actor.push_block = keep_block
    tr.warmup()
    nb, S, L = d_cfg.num_blocks, d_cfg.seqs_per_block, d_cfg.learning_steps
    chunk = tr.sample()
    torch.cuda.current_stream().wait_event(chunk.event)
    obs = chunk.batch["obs"].cpu().numpy()
    act = chunk.batch["action"].cpu().numpy()
    checked = 0
    for j in range(2):
        for i, idx in enumerate(chunk.idxes[j]):
            blk, s = divmod(int(idx), S)
            if blk < nb:
                continue
            rec = rp._disk_record(blk - nb)
            match = [w for w in blocks if np.array_equal(rec["obs"][: len(w[0])], w[0])]
            if not match:
                fail(f"tiered: disk slot {blk - nb} holds no block that was written")
            w_obs, w_act, w_burn = match[0]
            start = int(w_burn[0]) + s * L - int(w_burn[s])
            rows_ = np.clip(start + np.arange(d_cfg.seq_len), 0, d_cfg.block_slot_len - 1)
            slab = np.zeros((d_cfg.block_slot_len, *d_cfg.obs_shape), np.uint8)
            slab[: len(w_obs)] = w_obs
            lrows = np.clip(s * L + np.arange(L), 0, d_cfg.block_length - 1)
            if not (np.array_equal(obs[j, i], slab[rows_]) and np.array_equal(
                    act[j, i], np.pad(w_act, (0, d_cfg.block_length - len(w_act)))[lrows])):
                fail(f"tiered: a disk-resident draw (slot {blk - nb}) differs from the rows "
                     "written")
            checked += 1
    if not checked:
        fail("tiered: no draw landed on a disk-resident block")
    stats = rp.disk_stats()
    tr.state, _ = tr.plane.update(tr.state, chunk)  # pending, not yet applied
    prios, pend = tr.plane._pending
    tr.plane._pending = None
    old = pend.old_advances
    steps = 0
    while not (rp.slot_stamp[pend.idxes // S] > old).any() and steps < 2000:
        tr.actor.step()
        steps += 1
    mutated = rp.slot_stamp[pend.idxes // S] > old
    before = rp.tree.priorities_of(pend.idxes.ravel()).reshape(pend.idxes.shape)
    tr.plane.drain_pending((np.full(pend.idxes.shape, 7.0, np.float32), pend))
    after = rp.tree.priorities_of(pend.idxes.ravel()).reshape(pend.idxes.shape)
    live = ~mutated & ~np.isin(pend.idxes, pend.idxes[mutated])
    if not mutated.any() or not np.array_equal(after[mutated], before[mutated]) or not \
            np.allclose(after[live], 7.0 ** d_cfg.prio_exponent, rtol=1e-12):
        fail(f"tiered: the stale write-back was not dropped ({int(mutated.sum())} rows in "
             "mutated slots)")
    say("tiered", f"disk tier ({d_cfg.buffer_capacity} host + {d_cfg.replay_disk_capacity} "
        f"disk transitions, delta-zlib): {checked} draws of disk-resident rows copied back "
        f"from the card equal the rows written; {stats}; after {steps} more actor steps "
        f"{int(mutated.sum())} of {mutated.size} rows sat in mutated slots and their "
        f"write-back was dropped, the other {int(live.sum())} applied "
        f"({time.perf_counter() - t0:.1f}s in the phase)")
    del tr
    return rows


def _close(a, b, rtol=1e-4, atol=1e-5):
    """(max |a - b|, within rtol / atol, bit for bit) of two tensors."""
    import torch

    a, b = a.detach().float(), b.detach().float()
    return (float((a - b).abs().max()), bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
            bool(torch.equal(a, b)))


def _states_close(a, b, label):
    """Hold two TrainStates' networks to rtol 1e-4 / atol 1e-5; -> (max
    |diff|, bit for bit)."""
    worst, same = 0.0, True
    for x, y in zip(list(a.net.parameters()) + list(a.target_net.parameters()),
                    list(b.net.parameters()) + list(b.target_net.parameters())):
        d, ok, eq = _close(x, y)
        if not ok:
            fail(f"{label}: parameters differ by {d:.3e}")
        worst, same = max(worst, d), same and eq
    if a.step != b.step:
        fail(f"{label}: steps {a.step} != {b.step}")
    return worst, same


def device_phase(dev, tmp):
    """Phase 21: the device replay plane at the paper's 2,000,000
    transitions (the atari preset on catch, learning_starts cut to 2,000):
    the fp32 checks (the in-step gather against the host plane's batch, a
    fused update against make_train_step, a K=4 dispatch against 4 single
    steps, the device tree against the host tree, a superstep of N=2
    against two of N=1, a device snapshot round trip at a small capacity),
    then the planes' rows in bf16 and fp32 (tiered_rows over
    DEVICE_ROWS, and SUPERSTEP_ROW in bf16)."""
    import copy
    import gc

    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.learner import (
        DeviceBatch,
        make_fused_multi_train_step,
        make_fused_train_step,
        make_store_gather,
        make_train_step,
    )
    from r2d2_tpu_torch.megastep import (
        make_priority_superstep,
        superstep_generators,
        superstep_uniforms,
    )
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
    from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay
    from r2d2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    card = card_line()
    b_cfg = PRESETS["atari"]().replace(env_name="catch", buffer_capacity=TIERED_CAPACITY,
                                       learning_starts=ON_CATCH["learning_starts"])
    k = DEVICE_K
    cfg = b_cfg.replace(compute_dtype="float32", replay_plane="device", priority_plane="device",
                        updates_per_dispatch=k, superstep_dispatches=2, training_steps=2 * k)
    tr = Trainer(cfg, device=dev)
    host = ReplayBuffer(cfg.replace(replay_plane="host", priority_plane="host",
                                    updates_per_dispatch=1, superstep_dispatches=1))
    push = tr.actor.push_block

    def both(block, prios, ep):
        host.add_block(block, prios, ep)
        return push(block, prios, ep)

    tr.actor.push_block = both
    tr.warmup()
    rp = tr.replay
    say("device", f"[{card}] fp32 device plane, {TIERED_CAPACITY} transitions: store "
        f"{rp.nbytes() / 1e9:.2f} GB on the card ({torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated), {len(rp)} transitions ingested")

    # the in-step gather against the host plane's batch, bit for bit
    gens = [np.random.default_rng() for _ in range(2)]
    for g in gens:
        g.bit_generator.state = tr.sample_rng.bit_generator.state
    hb = host.sample_batch(gens[0])
    si = rp.sample_indices(gens[1])
    if not np.array_equal(hb.idxes, si.idxes):
        fail("device: the device plane drew other coordinates than the host plane")
    coords = tuple(torch.from_numpy(x).to(dev) for x in (si.b, si.s, si.is_weights))
    got = make_store_gather(cfg)(rp.stores, *coords)
    want = DeviceBatch.from_sampled(hb, dev)
    for name in DeviceBatch._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"device: the in-step gather's {name} differs from the host plane's batch")
    say("device", f"the in-step gather of {len(si.idxes)} windows equals the host plane's batch "
        "bit for bit (every field)")

    # one fused update against make_train_step on the host batch
    sa, sb = copy.deepcopy(tr.state), copy.deepcopy(tr.state)
    sa, ma, pa = make_fused_train_step(cfg)(sa, rp.stores, *coords)
    sb, mb, pb = make_train_step(cfg)(sb, want)
    d_loss, ok_l, eq_l = _close(ma["loss"], mb["loss"])
    d_prio, ok_p, eq_p = _close(pa, pb)
    if not (ok_l and ok_p):
        fail(f"device: the fused update differs from make_train_step (loss {d_loss:.3e}, "
             f"priorities {d_prio:.3e})")
    d_par, eq_par = _states_close(sa, sb, "device fused update")
    say("device", f"one fused update vs make_train_step on the host batch: loss {d_loss:.3e}, "
        f"priorities {d_prio:.3e}, parameters {d_par:.3e} (rtol 1e-4 / atol 1e-5; bit for bit: "
        f"{eq_l and eq_p and eq_par})")

    # a K-update dispatch against K single fused steps, and its launches
    draws = [rp.sample_indices(tr.sample_rng) for _ in range(k)]
    stack = [torch.from_numpy(np.stack([getattr(d, f) for d in draws])).to(dev)
             for f in ("b", "s", "is_weights")]
    sa, sb = copy.deepcopy(tr.state), copy.deepcopy(tr.state)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    sa, ma, pa = make_fused_multi_train_step(cfg, k)(sa, rp.stores, *stack)
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != {"lstm_fwd": 2 * k, "lstm_seq_bwd": k}:
        fail(f"device: a K={k} dispatch launched {launches}")
    one = make_fused_train_step(cfg)
    prios = []
    for j in range(k):
        sb, mb, p = one(sb, rp.stores, *(x[j] for x in stack))
        prios.append(p)
    d_prio, ok_p, eq_p = _close(pa, torch.stack(prios))
    if not ok_p:
        fail(f"device: the K={k} dispatch's priorities differ from {k} single steps: {d_prio:.3e}")
    d_par, eq_par = _states_close(sa, sb, "device K dispatch")
    say("device", f"a K={k} dispatch vs {k} single fused steps: priorities {d_prio:.3e}, "
        f"parameters {d_par:.3e} (bit for bit: {eq_p and eq_par}); launches {launches}")

    # the device tree against the host tree, after ingestion and write-backs
    def tree_bound(when):
        d, h = rp.dtree.leaves().astype(np.float64), rp.tree.leaves()
        if not np.allclose(d, h, rtol=1e-5, atol=1e-6):
            fail(f"device: the device tree's leaves left the host tree's bound {when}")
        tot = abs(rp.dtree.total - float(rp.tree.tree[0])) / max(float(rp.tree.tree[0]), 1e-30)
        return float(np.abs(d - h).max()), tot

    lb, tb = tree_bound("after ingestion")
    for d, row in zip(draws, pa.cpu().numpy()):
        rp.update_priorities(d.idxes, row, d.old_ptr, d.old_advances)
    la, ta = tree_bound("after write-backs")
    say("device", f"device tree vs host float64 tree ({rp.tree.capacity} leaves): max |leaf "
        f"diff| {lb:.3e} after ingestion, {la:.3e} after {k} write-backs; total rel. diff "
        f"{tb:.2e}, {ta:.2e} (bound rtol 1e-5 / atol 1e-6)")

    # a superstep of N=2 against two of N=1, and its launches
    nss = torch.from_numpy(rp.num_seq_store).to(dev)
    u = superstep_uniforms(superstep_generators(cfg.seed + 4, 0, 2, dev), k, cfg.batch_size, dev)
    sa, sb = copy.deepcopy(tr.state), copy.deepcopy(tr.state)
    tree0 = rp.dtree.tree
    torch.cuda.synchronize()
    K.reset_launch_counts()
    sa, ta_, _ = make_priority_superstep(cfg, 2, k)(sa, rp.stores, tree0.clone(), nss, u)
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != {"lstm_fwd": 4 * k, "lstm_seq_bwd": 2 * k}:
        fail(f"device: a superstep of N=2, K={k} launched {launches}")
    ss1 = make_priority_superstep(cfg, 1, k)
    sb, tb_, _ = ss1(sb, rp.stores, tree0.clone(), nss, u[0:1])
    sb, tb_, _ = ss1(sb, rp.stores, tb_, nss, u[1:2])
    d_tree, ok_t, eq_t = _close(ta_, tb_)
    if not ok_t:
        fail(f"device: superstep N=2 vs 2 x N=1 trees differ by {d_tree:.3e}")
    d_par, eq_par = _states_close(sa, sb, "device superstep")
    say("device", f"superstep N=2, K={k} vs 2 superstep-1 calls: tree {d_tree:.3e}, parameters "
        f"{d_par:.3e} (bit for bit: {eq_t and eq_par}); launches {launches}")
    del tr, host, sa, sb, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # a device snapshot round trip at a small capacity
    s_cfg = cfg.replace(buffer_capacity=SNAPSHOT_CAPACITY)
    tr = Trainer(s_cfg, device=dev)
    tr.warmup()
    path = os.path.join(tmp, "device_snapshot.npz")
    save_replay(tr.replay, path)
    fresh = DeviceReplayBuffer(s_cfg, dev)
    restore_replay(fresh, path)
    for key, t in tr.replay.stores.items():
        if not torch.equal(t, fresh.stores[key]):
            fail(f"device: the snapshot round trip changed store {key}")
    if not (torch.equal(tr.replay.dtree.tree, fresh.dtree.tree)
            and fresh.block_ptr == tr.replay.block_ptr and len(fresh) == len(tr.replay)):
        fail("device: the snapshot round trip changed the tree or the counters")
    say("device", f"device snapshot at {SNAPSHOT_CAPACITY} transitions: {os.path.getsize(path) / 1e6:.1f} "
        "MB, restored bit for bit (stores, device tree, counters)")
    del tr, fresh
    gc.collect()
    torch.cuda.empty_cache()

    # the planes' rows, bf16 and fp32, in this call
    rows = {}
    for label, extra in (("bf16", {}), ("fp32", {"compute_dtype": "float32"})):
        specs = DEVICE_ROWS + ((SUPERSTEP_ROW,) if label == "bf16" else ())
        rows[label], last = tiered_rows(label, b_cfg.replace(**extra), dev, specs=specs)
        del last
        gc.collect()
        torch.cuda.empty_cache()
    say("device", f"[{card}] ms per update over the wall (acting included), {TIERED_UPDATES} "
        "updates inline (two supersteps for the N=2 row): " + "; ".join(
            f"{label} " + ", ".join(f"{name} {r['ms_per_update']:.2f}" for name, r in rs.items())
            for label, rs in rows.items()))
    say("device", "busy share, update peak GiB, store GB on the card: " + "; ".join(
        f"{label} {name} {r['device_busy']:.1%}, {r['peak_gib']:.2f}, "
        f"{r.get('store_gb_on_card', 0.0):.2f}"
        for label, rs in rows.items() for name, r in rs.items()))
    say("device", f"phase done ({time.perf_counter() - t0:.1f}s in the phase)")
    return rows


def compare_blocks(label, cfg, out, pushed):
    """A collector chunk's packed blocks (make_collect_fn's result `out`)
    against the host actor's SequenceAccumulator blocks on the same
    trajectories, `pushed[i]` = (block, priorities, episode reward) of slot
    i: frames, actions, rewards, returns, discounts and counters bit for
    bit, the slot's terminal flag, carries and priorities to rtol 1e-5 /
    atol 1e-6. Fails on a difference; -> the largest carry and priority
    differences."""
    import numpy as np
    import torch

    from r2d2_tpu_torch.replay.block import to_state_host

    fields, prios, num_seq, sizes, dones = out[:5]
    worst = {"hidden": 0.0, "priorities": 0.0}
    for i, (block, host_prios, ep_reward) in enumerate(pushed):
        size, ns = int(sizes[i]), int(num_seq[i])
        exact = {
            "obs": (fields["obs"][i, : size + 1].cpu().numpy(), block.obs),
            "last_action": (fields["last_action"][i, : size + 1].cpu().numpy(),
                            block.last_action.astype(np.int32)),
            "last_reward": (fields["last_reward"][i, : size + 1].cpu().numpy(),
                            block.last_reward),
            "action": (fields["action"][i, :size].cpu().numpy(), block.action.astype(np.int32)),
            "n_step_reward": (fields["n_step_reward"][i, :size].cpu().numpy(),
                              block.n_step_reward),
            "gamma": (fields["gamma"][i, :size].cpu().numpy(), block.gamma),
            "burn_in": (fields["burn_in"][i, :ns].cpu().numpy(), block.burn_in_steps),
            "learning": (fields["learning"][i, :ns].cpu().numpy(), block.learning_steps),
            "forward": (fields["forward"][i, :ns].cpu().numpy(), block.forward_steps),
        }
        if size != len(block.action) or bool(dones[i]) != (ep_reward is not None):
            fail(f"{label}: slot {i} recorded {size} steps (done {bool(dones[i])}), the host "
                 f"actor {len(block.action)} (done {ep_reward is not None})")
        for name, (got, want) in exact.items():
            if not np.array_equal(got, want):
                fail(f"{label}: slot {i}'s {name} differs from the host accumulator's")
        hid = to_state_host(fields["hidden"][i, :ns], cfg.state_dtype)
        hid_f = torch.from_numpy(hid.view(np.int16)).view(torch.bfloat16).float().numpy() \
            if hid.dtype == np.uint16 else hid
        want_f = torch.from_numpy(block.hidden.view(np.int16)).view(torch.bfloat16).float() \
            .numpy() if block.hidden.dtype == np.uint16 else block.hidden
        worst["hidden"] = max(worst["hidden"], float(np.abs(hid_f - want_f).max()))
        worst["priorities"] = max(worst["priorities"], float(np.abs(
            prios[i].cpu().numpy() - host_prios).max()))
        if not (np.allclose(hid_f, want_f, rtol=1e-5, atol=1e-6)
                and np.allclose(prios[i].cpu().numpy(), host_prios, rtol=1e-5, atol=1e-6)):
            fail(f"{label}: slot {i}'s carries or priorities differ from the host's ({worst})")
    return worst


def fused_phase(dev, tmp):
    """Phase 22: --mode fused at the atari widths on catch, max_episode_steps
    cut to the 400-step chunk: the collector's blocks against the host
    accumulator's on the card, a megastep against its parts, the device
    evaluator, Trainer.run_fused at 2,000,000 in bf16 and fp32 (ms per
    dispatch, updates per second, the chunk's env steps per second and
    kernel launches), and the CLI's --mode fused once in a subprocess."""
    import copy
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from r2d2_tpu_torch.actor import ParamStore, VectorizedActor
    from r2d2_tpu_torch.collect import (
        CollectDraws,
        DeviceCollector,
        GivenDraws,
        make_collect_fn,
    )
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.envs.catch import CatchState, CatchVecEnv, TensorCatchEnv
    from r2d2_tpu_torch.evaluate import evaluate_params_device
    from r2d2_tpu_torch.learner import init_train_state, make_fused_multi_train_step
    from r2d2_tpu_torch.megastep import make_megastep
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.replay.device_store import DeviceReplayBuffer
    from r2d2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    card = card_line()
    k = DEVICE_K
    base = PRESETS["atari"]().replace(
        env_name="catch", buffer_capacity=TIERED_CAPACITY,
        learning_starts=ON_CATCH["learning_starts"], max_episode_steps=400, collector="device",
        replay_plane="device", updates_per_dispatch=k)
    chunk = min(base.block_length, base.max_episode_steps)
    H, W = base.obs_shape[:2]

    # the collector's blocks against the host accumulator's, same trajectories
    for label, extra in (("fp32", {"compute_dtype": "float32"}), ("bf16", {})):
        E = BLOCK_CHECK_ENVS
        cfg = base.replace(num_actors=E, buffer_capacity=MEGA_CAPACITY, action_dim=3, **extra)
        _, st = init_train_state(cfg, dev)
        net = st.net
        eps = np.linspace(0.0, 1.0, E).astype(np.float32)
        vec = CatchVecEnv(E, H, W, seed=4)
        pushed = []
        actor = VectorizedActor(cfg, copy.deepcopy(net), ParamStore(net), vec, eps,
                                lambda b, p, r: pushed.append((b, p, r)), seed=11, device=dev)
        start = CatchState(*(torch.from_numpy(v.copy()).to(dev) for v in vec._state))
        while len(pushed) < E:
            actor.step()
        rng = np.random.default_rng(11)
        u, a = [], []
        for _ in range(chunk):
            u.append(rng.random(E).astype(np.float32))
            a.append(rng.integers(0, 3, size=E))
        out = make_collect_fn(cfg, TensorCatchEnv(H, W), E, chunk)(
            net, start, torch.from_numpy(eps).to(dev),
            GivenDraws(np.stack(u), np.stack(a), resets=start))
        fields = out[0]
        worst = compare_blocks(f"fused {label}", cfg, out, pushed)
        say("fused", f"{label}: a {chunk}-step chunk over {E} catch envs at {H}x{W} equals the host "
            f"actor's blocks (frames, actions, rewards, returns, discounts, counters bit for "
            f"bit; max |diff| carries {worst['hidden']:.3e}, priorities "
            f"{worst['priorities']:.3e}, held to rtol 1e-5 / atol 1e-6)")
        del net, st, actor, fields

    # a megastep against its parts, at a store that holds a chunk
    cfg = base.replace(buffer_capacity=MEGA_CAPACITY, compute_dtype="float32", action_dim=3)
    fn_env = TensorCatchEnv(H, W)
    _, state = init_train_state(cfg, dev)
    replay = DeviceReplayBuffer(cfg, dev)
    col = DeviceCollector(cfg, copy.deepcopy(state.net), ParamStore(state.net), fn_env, replay,
                          seed=7, device=dev)
    col.step()
    E = cfg.num_actors
    rng = np.random.default_rng(3)
    with replay.lock:
        ptr0 = replay._reserve_advance(E)
        draws = [replay._draw_sample_idx(rng) for _ in range(k)]
    b, s, w = (torch.from_numpy(np.stack([getattr(d, f) for d in draws])).to(dev)
               for f in ("b", "s", "is_weights"))
    stores_b = {key: t.clone() for key, t in replay.stores.items()}
    state_b = copy.deepcopy(state)
    gen_b = torch.Generator(device=dev)
    gen_b.set_state(col.draws.generator.get_state())
    torch.cuda.synchronize()
    K.reset_launch_counts()
    state_a, ma, pa, chunk_a, _ = make_megastep(cfg, fn_env, E, chunk, k)(
        state, replay.stores, col.env_state, col.epsilons, col.draws, b, s, w, ptr0)
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != {"lstm_fwd": 2 * k, "lstm_seq_bwd": k}:
        fail(f"fused: a megastep of K={k} launched {launches}")
    fields, cp, ns, sz, dn, er, _ = make_collect_fn(cfg, fn_env, E, chunk)(
        copy.deepcopy(state_b.net), col.env_state, col.epsilons, CollectDraws(gen_b))
    state_b, mb, pb = make_fused_multi_train_step(cfg, k)(state_b, stores_b, b, s, w)
    for key, t in stores_b.items():
        t[ptr0:ptr0 + E].copy_(fields[key])
    d_prio, ok_p, eq_p = _close(pa, pb)
    d_par, eq_par = _states_close(state_a, state_b, "fused megastep")
    same_stores = all(torch.equal(replay.stores[key], stores_b[key]) for key in stores_b)
    same_chunk = all(_close(x, y, 1e-5, 1e-6)[1] for x, y in zip(chunk_a, (cp, ns, sz, dn, er)))
    if not (ok_p and same_stores and same_chunk):
        fail(f"fused: the megastep differs from its parts (priorities {d_prio:.3e}, stores "
             f"equal {same_stores}, chunk bookkeeping close {same_chunk})")
    say("fused", f"a megastep (K={k}, {E} envs x {chunk} steps, {MEGA_CAPACITY} transitions) equals "
        f"its parts: priorities {d_prio:.3e}, parameters {d_par:.3e} (bit for bit: "
        f"{eq_p and eq_par}), the store after the slab write bit for bit; launches {launches}")

    # the device evaluator
    mean, truncated = evaluate_params_device(cfg, state_a.net, fn_env, num_envs=16, seed=123,
                                             return_stats=True)
    if not math.isfinite(mean):
        fail(f"fused: the device evaluator returned {mean}")
    say("fused", f"device evaluator: 16 episodes, mean reward {mean:+.4f}, {truncated} truncated")
    del state, state_a, state_b, replay, col, stores_b, fields
    gc.collect()
    torch.cuda.empty_cache()

    # Trainer.run_fused at the paper's capacity, bf16 and fp32
    rows = {}
    for label, extra in (("bf16", {}), ("fp32", {"compute_dtype": "float32"})):
        sfx = "_bf16" if label == "bf16" else ""
        tr = Trainer(base.replace(training_steps=2 * k, **extra), device=dev)
        tr.run_fused()
        # the chunk alone: its time and its kernel launches
        collect = make_collect_fn(tr.cfg, tr.fn_env, E, chunk)
        draws = CollectDraws(torch.Generator(device=dev).manual_seed(1))
        env0 = draws.reset(tr.fn_env, E, dev)
        collect(tr.state.net, env0, tr.actor.epsilons, draws)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        out = collect(tr.state.net, env0, tr.actor.epsilons, draws)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - c0
        recorded = int(out[3].sum())
        kernels = None
        if label == "bf16":
            # the device's events only: a chunk's tens of thousands of
            # launches make the host side of a trace slow to process
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                collect(tr.state.net, env0, tr.actor.epsilons, draws)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in device_events(prof.key_averages()))
        n = FUSED_DISPATCHES
        tr.cfg = tr.cfg.replace(training_steps=tr.cfg.training_steps + n * k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        tr.run_fused()
        torch.cuda.synchronize()
        launches = {key: v for key, v in K.launch_counts.items() if v}
        if launches != {f"lstm_fwd{sfx}": 2 * k * n, f"lstm_seq_bwd{sfx}": k * n}:
            fail(f"fused {label}: {n} dispatches launched {launches}")
        ends = tr.update_ends[-n:]
        ms = (ends[-1] - ends[0]) * 1e3 / (n - 1)
        m = tr.metrics()
        if not math.isfinite(m["loss"]):
            fail(f"fused {label}: loss {m['loss']}")
        row = {"path": label, "K": k, "envs": E, "chunk": chunk, "ms_per_dispatch": ms,
               "updates_per_s": k * 1e3 / ms, "chunk_ms": chunk_s * 1e3,
               "chunk_env_steps_per_s": E * chunk / chunk_s,
               "chunk_recorded_steps_per_s": recorded / chunk_s,
               "chunk_kernel_launches": kernels,
               "launches_per_dispatch": {key: v // n for key, v in launches.items()},
               "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "store_gb_on_card": tr.replay.nbytes() / 1e9, "loss": m["loss"]}
        say("fused", json.dumps(row))
        rows[label] = row
        del tr, collect, out
        gc.collect()
        torch.cuda.empty_cache()
    say("fused", f"[{card}] ms per dispatch (K={k} updates + a {chunk}-step chunk of {E} envs): "
        + ", ".join(f"{label} {r['ms_per_dispatch']:.1f} ({r['updates_per_s']:.1f} updates/s, "
                    f"chunk {r['chunk_ms']:.1f} ms, {r['chunk_env_steps_per_s']:.0f} env steps/s)"
                    for label, r in rows.items())
        + f"; the bf16 chunk launched {rows['bf16']['chunk_kernel_launches']} kernels")

    # the CLI's --mode fused, once, through its main()
    args = ["--preset", "atari", "--env", "catch", "--mode", "fused", "--updates-per-dispatch",
            str(k), "--steps", str(2 * k), "--set",
            f"learning_starts={ON_CATCH['learning_starts']}", "--set", "max_episode_steps=400",
            "--set", f"buffer_capacity={MEGA_CAPACITY}"]
    code, res = train_main(args)
    if code != 0:
        fail(f"fused: the CLI's --mode fused exited {code}")
    if res["mode"] != "fused" or res["step"] != 2 * k or not math.isfinite(res["loss"]):
        fail(f"fused: the CLI's --mode fused gave {res}")
    say("fused", f"CLI --mode fused (bf16, {MEGA_CAPACITY} transitions): step {res['step']}, "
        f"loss {res['loss']:.6f}, {res['env_steps']} env steps, {res['seconds']:.1f}s "
        f"({time.perf_counter() - t0:.1f}s in the phase)")
    return rows


def procgen_phase(dev, tmp):
    """Phase 23: the procgen_impala path (procmaze -> IMPALA (16, 32, 32) ->
    LSTM 512, 64x64x3, T=85, B=64) at full width on the card, replay cut to
    16,000 transitions (learning_starts 2,000): the procmaze core on the
    card against the CPU bit for bit; the device collector's blocks against
    the host accumulator's; the preset in bf16 and fp32 through
    Trainer.run_inline (2 K1 + 1 K2 launches of the dtype per update, ms
    per update alone and over the wall, the update peak) with one update
    held against the CPU; run_fused with the device collector; the CLI."""
    import copy
    import gc

    import numpy as np
    import torch

    from r2d2_tpu_torch.actor import ParamStore, VectorizedActor
    from r2d2_tpu_torch.collect import GivenDraws, make_collect_fn
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.envs.procmaze import ProcMazeState
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.train import Trainer, build_fn_env, build_vec_env

    t0 = time.perf_counter()
    card = card_line()
    base = PRESETS["procgen_impala"]().replace(**PROCGEN_CUT)
    H, W, C = base.obs_shape

    # the core on the card against the CPU, from the same draws
    env = build_fn_env(base)
    E, steps = PROCMAZE_CHECK
    draws = env.level_draws(E, torch.Generator().manual_seed(0), "cpu")
    states = {d: env.reset(E, device=d, draws=tuple(x.to(d) for x in draws)) for d in ("cpu", dev)}
    rng = np.random.default_rng(0)
    ends = 0
    for t in range(steps):
        a = torch.from_numpy(rng.integers(0, env.NUM_ACTIONS, E).astype(np.int32))
        if not torch.equal(env.render(states[dev]).cpu(), env.render(states["cpu"])):
            fail(f"procgen: the procmaze frames on the card differ from the CPU's at step {t}")
        out = {d: env.step(st, a.to(d)) for d, st in states.items()}
        states = {d: o[0] for d, o in out.items()}
        got, want = [*out[dev][1:], *states[dev]], [*out["cpu"][1:], *states["cpu"]]
        if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
            fail(f"procgen: the procmaze step on the card differs from the CPU's at step {t}")
        ends += int(out["cpu"][2].sum())
    say("procgen", f"procmaze core ({env.g}x{env.g} cells of {env.cell} px, {H}x{W}x{C}): {E} "
        f"envs x {steps} steps on the card equal the CPU's bit for bit (frames, rewards, "
        f"dones, states; {ends} episode ends)")

    # the device collector's blocks against the host accumulator's
    chunk = base.max_episode_steps
    for label, extra in (("fp32", {"compute_dtype": "float32"}), ("bf16", {})):
        E = BLOCK_CHECK_ENVS
        cfg = base.replace(num_actors=E, **extra)
        _, st = init_train_state(cfg, dev)
        net = st.net
        eps = np.linspace(0.0, 1.0, E).astype(np.float32)
        vec = build_vec_env(cfg, seed=4, device=dev)
        pushed, slots = [], []
        actor = VectorizedActor(cfg, copy.deepcopy(net), ParamStore(net), vec, eps,
                                lambda b, p, r: pushed.append((b, p, r)), seed=11, device=dev)
        start = ProcMazeState(*(x.clone() for x in vec._state))
        for i, acc in enumerate(actor.accs):  # the slot of every pushed block
            acc.finish = (lambda f, i: lambda *a, **k: (slots.append(i), f(*a, **k))[1])(
                acc.finish, i)
        for _ in range(chunk + 1):  # a truncation is pushed one step later
            actor.step()
        first = {}
        for i, item in zip(slots, pushed):
            first.setdefault(i, item)
        if sorted(first) != list(range(E)):
            fail(f"procgen: the host actor pushed blocks for slots {sorted(first)} only")
        rng = np.random.default_rng(11)  # the host actor's draws, step by step
        u, a = map(np.stack, zip(*((rng.random(E).astype(np.float32),
                                    rng.integers(0, cfg.action_dim, size=E))
                                   for _ in range(chunk))))
        out = make_collect_fn(cfg, vec.env, E, chunk)(
            net, start, torch.from_numpy(eps).to(dev), GivenDraws(u, a, resets=start))
        worst = compare_blocks(f"procgen {label}", cfg, out, [first[i] for i in range(E)])
        say("procgen", f"{label}: a {chunk}-step collector chunk over {E} procmaze envs equals the "
            f"host actor's blocks ({int(out[4].sum())} terminal, the rest truncated; frames, "
            f"actions, rewards, returns, discounts, counters bit for bit; max |diff| carries "
            f"{worst['hidden']:.3e}, priorities {worst['priorities']:.3e})")
        del net, st, actor, vec, out

    # the preset through Trainer.run_inline, bf16 and fp32
    rows = {}
    n = PROCGEN_UPDATES
    for label, extra, tol in (("bf16", {}, BF16_AGREE), ("fp32", {"compute_dtype": "float32"},
                                                         {})):
        sfx = "_bf16" if label == "bf16" else ""
        tr, launches, m, ms, peak = drive(base.replace(**extra), n, dev)
        if launches != {f"lstm_fwd{sfx}": 2 * n, f"lstm_seq_bwd{sfx}": n}:
            fail(f"procgen {label}: {n} updates launched {launches}")
        ends = tr.update_ends[-n:]
        row = {"path": label, "updates": n, "ms_per_update": statistics.median(ms[1:]),
               "ms_per_update_wall": (ends[-1] - ends[0]) * 1e3 / (n - 1),
               "update_peak_gib": peak, "launches_per_update": {k: v // n for k, v in
                                                                launches.items()},
               "env_steps": m["env_steps"], "loss": m["loss"]}
        say("procgen", json.dumps(row))
        if label == "bf16":
            # the whole bf16 update held at the bf16 tolerances, the update
            # behind the encoder too; the encoder's derived rounding bound
            # carried to the priorities is printed beside their distance
            results = {}
            sampled = agree(tr, f"procgen {label}", **tol, results=results)
            agree(tr, f"procgen {label}, the card's encoder outputs handed to both", **tol,
                  sampled=sampled, latents=encoder_latents(tr, sampled))
            encoder_bound_priorities(tr, f"procgen {label}", sampled, results, **tol)
        else:
            agree(tr, f"procgen {label}", **tol)
        profile_updates(tr, PROCGEN_PROFILED, f"procgen {label}")
        rows[label] = row
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # the device collector through Trainer.run_fused
    k = PROCGEN_FUSED_K
    tr = Trainer(base.replace(collector="device", replay_plane="device",
                              updates_per_dispatch=k, training_steps=k), device=dev)
    tr.run_fused()
    tr.cfg = tr.cfg.replace(training_steps=3 * k)
    K.reset_launch_counts()
    tr.run_fused()
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != {"lstm_fwd_bf16": 4 * k, "lstm_seq_bwd_bf16": 2 * k}:
        fail(f"procgen fused: 2 dispatches of K={k} launched {launches}")
    m = tr.metrics()
    say("procgen", f"bf16 --mode fused (device collector, {tr.cfg.num_actors} envs x {chunk}-step "
        f"chunks, K={k}): step {m['step']}, loss {m['loss']:.6f}, {m['env_steps']} env steps, "
        f"launches {launches}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI, once, through its main()
    args = ["--preset", "procgen_impala", "--steps", str(n), "--set",
            f"learning_starts={PROCGEN_CUT['learning_starts']}", "--set",
            f"buffer_capacity={PROCGEN_CUT['buffer_capacity']}", "--set",
            f"checkpoint_dir={os.path.join(tmp, 'procgen_ckpt')}"]
    code, res = train_main(args)
    if code != 0:
        fail(f"procgen: the CLI exited {code}")
    if res["step"] != n or not math.isfinite(res["loss"]):
        fail(f"procgen: the CLI gave {res}")
    say("procgen", f"CLI --preset procgen_impala --steps {n}: step {res['step']}, loss "
        f"{res['loss']:.6f}, {res['env_steps']} env steps, {res['seconds']:.1f}s")
    say("procgen", f"[{card}] ms per update (alone / over the wall, acting included): "
        + ", ".join(f"{lb} {r['ms_per_update']:.2f} / {r['ms_per_update_wall']:.2f}, update "
                    f"peak {r['update_peak_gib']:.2f} GiB" for lb, r in rows.items())
        + f"; phase {time.perf_counter() - t0:.1f}s")
    return rows


def multitask_phase(dev, tmp):
    """Phase 24: MultiTaskTrainer over keydoor, drift, banditgrid and catch
    at the atari preset's widths (84x84x1, nature, LSTM 512, T=85, B=64 in
    four task shares of 16, 8 actors: 2 per task, the union action_dim 5),
    replay cut to 16,000 transitions (learning_starts 2,000), bf16 and
    fp32: warmup, one stratified update held against the CPU, the acting
    step's masked Q, 8 updates through train() (2 K1 + 1 K2 per update, ms
    per update alone and over the wall, the update peak, per-task env
    steps), every stored action inside its task's native range, per-task
    evaluation rows; then the sweep CLI's --multitask once."""
    import gc

    import numpy as np
    import torch

    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.multitask import MultiTaskTrainer
    from r2d2_tpu_torch.ops import lstm_kernel as K

    t0 = time.perf_counter()
    card = card_line()
    base = PRESETS["atari"]().replace(**MULTITASK_CUT)
    n = MULTITASK_UPDATES
    rows = {}
    for label, extra, tol in (("bf16", {}, BF16_AGREE), ("fp32", {"compute_dtype": "float32"},
                                                         {})):
        sfx = "_bf16" if label == "bf16" else ""
        tr = MultiTaskTrainer(base.replace(**extra), MULTITASK_TASKS, device=dev)
        c = tr.cfg
        if (c.action_dim, tr.batch_split, [a.env.num_envs for a in tr.actors]) != (
                5, [16] * 4, [2] * 4):
            fail(f"multitask: geometry {c.action_dim}, {tr.batch_split}")
        w = time.perf_counter()
        tr.warmup(max_steps_per_task=MULTITASK_WARMUP_CAP)
        warm_s = time.perf_counter() - w
        # the acting step: a 3-action task's tail is floored at -1e9
        actor = tr.actors[MULTITASK_TASKS.index("catch")]
        with torch.no_grad():
            q, _ = actor.policy.act(torch.from_numpy(actor.obs).to(dev),
                                    torch.from_numpy(actor.last_action).to(dev),
                                    torch.from_numpy(actor.last_reward).to(dev), actor.carry,
                                    actor.task_vec)
        if not (q[:, 3:] == -1e9).all() or not (q[:, :3] > -1e8).all():
            fail(f"multitask {label}: the catch actor's Q rows are {q.tolist()}")
        sampled, _ = tr.draw_stratified()
        agree(tr, f"multitask {label}", sampled=sampled, **tol)
        ms = []
        update = tr.update

        def timed(update=update, ms=ms):
            u = time.perf_counter()
            m = update()  # ends in the priorities' copy to the host
            ms.append((time.perf_counter() - u) * 1e3)
            return m

        tr.update = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        w = time.perf_counter()
        m = tr.train(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w) * 1e3 / n
        launches = {key: v for key, v in K.launch_counts.items() if v}
        if launches != {f"lstm_fwd{sfx}": 2 * n, f"lstm_seq_bwd{sfx}": n}:
            fail(f"multitask {label}: {n} updates launched {launches}")
        if not math.isfinite(float(m["loss"])):
            fail(f"multitask {label}: loss {float(m['loss'])}")
        for spec, replay in zip(tr.specs, tr.replays):
            if int(replay.action_store.max()) >= spec.action_dim:
                fail(f"multitask {label}: task {spec.task_id} ({spec.env_name}) stored action "
                     f"{int(replay.action_store.max())} of {spec.action_dim}")
        row = {"path": label, "updates": n, "ms_per_update": statistics.median(ms),
               "ms_per_update_wall": wall_ms,
               "update_peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "warmup_s": warm_s, "launches_per_update": {k: v // n for k, v in
                                                           launches.items()},
               "task_env_steps": {s.env_name: r.env_steps for s, r in zip(tr.specs,
                                                                         tr.replays)},
               "loss": float(m["loss"])}
        say("multitask", json.dumps(row))
        for ev in tr.evaluate(**MULTITASK_EVAL):
            say("multitask", f"{label} evaluate: {json.dumps(ev)}")
        rows[label] = row
        del tr, actor
        gc.collect()
        torch.cuda.empty_cache()

    # the sweep CLI's --multitask (the atari preset maps to tiny_test there),
    # through its main()
    from r2d2_tpu_torch import sweep

    root = os.path.join(tmp, "sweep")
    code, lines = cli_main(sweep.main, ["--multitask", "--preset", "tiny_test", "--steps", "4",
                                        "--root", root])
    if code != 0:
        fail(f"multitask: the sweep CLI exited {code}")
    srows = lines[-4:]
    if [r["env"] for r in srows] != ["keydoor", "drift", "banditgrid", "catch"]:
        fail(f"multitask: the sweep CLI printed {srows}")
    say("multitask", "sweep --multitask --preset tiny_test --steps 4: one row per task: "
        + ", ".join(f"{r['env']} {r['mean_return']:+.3f}" for r in srows))
    say("multitask", f"[{card}] ms per update (alone / over the wall, acting included): "
        + ", ".join(f"{lb} {r['ms_per_update']:.2f} / {r['ms_per_update_wall']:.2f}, update "
                    f"peak {r['update_peak_gib']:.2f} GiB" for lb, r in rows.items())
        + f"; phase {time.perf_counter() - t0:.1f}s")
    return rows


def _serve_through_loop(srv, groups, hold_ms=0.0):
    """Serve each group through the server's own loop: the group's requests
    (a list of steps, each a list of (sid, obs, reward, reset) rows, one row
    a session) are all queued, then start() runs the serve loop (and, with
    serve_pipeline, the completion worker behind the depth-2 semaphore)
    until every future resolves, then stop(). With the queue full before
    the loop starts, the batcher forms one batch a step (a session's later
    requests are deferred), back to back. `hold_ms` delays each completion,
    so the serve loop runs ahead to the depth bound. Fails on a worker
    restart or stall, or a request left in flight. -> (each group's results,
    step by step, row by row; the most batches dispatched and not yet
    completed at once)."""
    import threading

    stage, complete = srv._stage_and_dispatch, srv._complete
    lock, depth = threading.Lock(), [0, 0]

    def staged(batch):
        rec = stage(batch)
        with lock:
            depth[0] += 1
            depth[1] = max(depth)
        return rec

    def completed(rec):
        time.sleep(hold_ms / 1e3)
        with lock:
            depth[0] -= 1
        complete(rec)

    srv._stage_and_dispatch, srv._complete = staged, completed
    out = []
    try:
        for steps in groups:
            futures = [[srv.submit(sid, obs, reward=r, reset=reset)
                        for sid, obs, r, reset in rows] for rows in steps]
            srv.start(watch_checkpoints=False)
            try:
                out.append([[f.result(timeout=30.0) for f in fs] for fs in futures])
                counts = srv.check()
            finally:
                srv.stop()
            if any(counts.values()) or srv._inflight:
                fail(f"serve: {counts}, {len(srv._inflight)} requests left in flight")
    finally:
        del srv._stage_and_dispatch, srv._complete
    return out, depth[1]


def serve_parity(cfg, label, pipelined, dev):
    """Every bucket's sessions, SERVE_STEPS requests each, served through
    the running server (_serve_through_loop; pipelined, each completion
    held SERVE_HOLD_MS so two batches are in flight), each answer against
    reference_act at the bucket and row it reports, the session's carry and
    last action carried on: q, actions and the carries written in the
    cache, bit for bit; -> the server."""
    import numpy as np
    import torch
    from r2d2_tpu_torch.ops.act_tail import first_argmax
    from r2d2_tpu_torch.serve import PolicyServer, ServeConfig, reference_act

    srv = PolicyServer(cfg.replace(serve_pipeline=pipelined),
                       ServeConfig(buckets=SERVE_BUCKETS, max_wait_ms=0.0, cache_capacity=128),
                       device=dev)
    srv.warmup()
    params = srv.served_params()
    rng = np.random.default_rng(0)
    groups = []
    for b in SERVE_BUCKETS:
        steps = []
        for step in range(SERVE_STEPS):
            obs = rng.integers(0, 255, (b, *cfg.obs_shape), dtype=np.uint8)
            rew = rng.normal(size=b).astype(np.float32) * (step > 0)
            steps.append([(f"{label}-{b}-{i}", obs[i], float(rew[i]), step == 0)
                          for i in range(b)])
        groups.append(steps)
    results, depth = _serve_through_loop(srv, groups, SERVE_HOLD_MS if pipelined else 0.0)
    zero = torch.zeros((1, cfg.hidden_dim), dtype=cfg.state_dtype, device=dev)
    carries, batches = {}, 0
    for steps, res in zip(groups, results):
        for rows, answers in zip(steps, res):
            batches += 1
            for (sid, obs, r, _), got in zip(rows, answers):
                h, c, last = carries.get(sid, (zero, zero, 0))
                q, (h, c) = reference_act(srv.net, params, obs[None], np.array([last]),
                                          np.array([r], np.float32), (h, c),
                                          min_batch=got.bucket, row=got.row)
                want = q[0].cpu().numpy()
                last = int(first_argmax(q)[0])
                carries[sid] = (h.to(cfg.state_dtype), c.to(cfg.state_dtype), last)
                if not (np.array_equal(got.q, want) and got.action == last
                        and got.bucket == len(rows)):
                    fail(f"serve {label}: {sid} at bucket {got.bucket} row {got.row} (a "
                         f"{len(rows)}-row step) differs from reference_act (max |dq| "
                         f"{float(np.abs(got.q - want).max()):.3e})")
    # the carries after each session's last step, read from the cache's rows
    for sid, (h, c, _) in carries.items():
        slot = srv.cache._slots[sid]
        if not (torch.equal(srv.cache.h[slot], h[0]) and torch.equal(srv.cache.c[slot], c[0])):
            fail(f"serve {label}: the cache's carry of {sid} differs from reference_act's")
    if depth != (2 if pipelined else 1):
        fail(f"serve {label}: at most {depth} batches were in flight at once")
    say("serve", f"{label}: {batches} batches through the serve loop over buckets "
        f"{SERVE_BUCKETS} ({SERVE_STEPS} a bucket, carries carried on; up to {depth} in "
        f"flight): q, actions and cached carries equal reference_act at the reported bucket "
        f"and row bit for bit; step shapes {srv.trace_count}")
    if srv.trace_count != len(SERVE_BUCKETS):
        fail(f"serve {label}: {srv.trace_count} step shapes for {len(SERVE_BUCKETS)} buckets")
    return srv


def serve_load(cfg, label, dev, tmp, card):
    """Open-loop Poisson arrivals over SERVE_SESSIONS sessions (cache
    SERVE_CACHE, spill slab SERVE_SPILL), buckets 2-32, a hot reload half
    way through each rate's window, the first 20% of a window discarded;
    one JSON line a rate. A rate fails on a request that fails (other than
    a rejection by the full queue) or is never answered, and on a restart
    or stall of a serve worker."""
    import threading
    from concurrent.futures import wait

    import numpy as np
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.serve import PolicyServer, QueueFullError, ServeConfig
    from r2d2_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = os.path.join(tmp, f"serve_{label}")
    srv = PolicyServer(cfg.replace(serve_spill=SERVE_SPILL),
                       ServeConfig(buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                                   cache_capacity=SERVE_CACHE, poll_interval_s=0.2),
                       checkpoint_dir=ckpt, device=dev)
    _, state = init_train_state(cfg, dev, seed=srv.serve_cfg.seed)
    save_checkpoint(ckpt, state, 0, 0.0)
    srv.warmup()
    srv.start()
    obs = np.random.default_rng(1).integers(0, 255, (SERVE_SESSIONS, *cfg.obs_shape),
                                            dtype=np.uint8)
    rows = []
    try:
        for k, rate in enumerate(SERVE_RATES):
            records, futures, stop = [], [], threading.Event()
            b0, st0 = (srv.batcher.batches, srv.batcher.occupancy_sum), srv.cache.stats()
            rej0, reloads0, workers0 = srv.batcher.rejected, srv.reloads, srv.check()
            t0 = time.perf_counter()

            def arrivals():
                rng = np.random.default_rng(1234 + k)
                seen, next_t = set(), time.perf_counter()
                while not stop.is_set():
                    next_t += rng.exponential(1.0 / rate)
                    delay = next_t - time.perf_counter()
                    if delay > 0 and stop.wait(delay):
                        break
                    i = int(rng.integers(0, SERVE_SESSIONS))
                    sid = f"load-{i}"
                    t_sub = time.perf_counter()
                    fut = srv.submit(sid, obs[i], reward=0.0, reset=sid not in seen)
                    futures.append(fut)
                    seen.add(sid)

                    def done(f, t_sub=t_sub):
                        e = f.exception()
                        records.append((t_sub - t0, time.perf_counter() - t_sub if e is None
                                        else None, None if e is None else
                                        ("rejected" if isinstance(e, QueueFullError)
                                         else "error")))

                    fut.add_done_callback(done)

            th = threading.Thread(target=arrivals, daemon=True)
            th.start()
            time.sleep(SERVE_SECONDS / 2)
            state.step = 100 * (k + 1)  # the hot reload, half way through
            save_checkpoint(ckpt, state, 0, 0.0)
            time.sleep(SERVE_SECONDS / 2)
            stop.set()
            elapsed = time.perf_counter() - t0  # the arrival window
            th.join(timeout=10.0)
            wait(futures, timeout=30.0)  # the last futures resolve
            time.sleep(0.1)  # and their callbacks run
            workers = {n: v - workers0[n] for n, v in srv.check().items()}
            warm = 0.2 * SERVE_SECONDS
            measured = [r for r in records if r[0] >= warm]
            ok = np.sort([lat for _, lat, _ in measured if lat is not None])
            p50, p95, p99 = (float(np.percentile(ok, q) * 1e3) if ok.size else float("nan")
                             for q in (50, 95, 99))
            st = srv.cache.stats()
            batches = srv.batcher.batches - b0[0]
            row = {"arm": label, "arrival_rate": rate, "seconds": SERVE_SECONDS,
                   "requests_per_s": ok.size / max(elapsed - warm, 1e-9),
                   "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
                   "slo_ms": SERVE_SLO_MS,
                   "slo_attainment": int((ok <= SERVE_SLO_MS / 1e3).sum()) / max(len(measured), 1),
                   "mean_batch_occupancy": (srv.batcher.occupancy_sum - b0[1]) / max(batches, 1),
                   "batches": batches,
                   "spills": st["cache_spills"] - st0["cache_spills"],
                   "promotes": st["cache_promotes"] - st0["cache_promotes"],
                   "rejects": srv.batcher.rejected - rej0,
                   "errors": sum(r[2] == "error" for r in records),
                   "unanswered": len(futures) - len(records), **workers,
                   "reloads": srv.reloads - reloads0,
                   "warmup_requests": len(records) - len(measured), "card": card}
            say("serve", json.dumps(row))
            if (row["reloads"] < 1 or not ok.size or row["errors"] or row["unanswered"]
                    or any(workers.values())):
                fail(f"serve load {label} at {rate}/s: {row}")
            rows.append(row)
        srv.check()
    finally:
        srv.stop()
    return rows


def serve_phase(dev, tmp):
    """Phase 25: the serving plane (M14a) at the atari preset's widths on
    catch (84x84x1, nature encoder, LSTM 512, 3 actions): served answers
    bit for bit equal to reference_act at every bucket, fp32 and bf16,
    serial and pipelined; a served batch on the card against the same on
    the CPU; the int8 arm's drift; open-loop load at three rates per arm;
    the carry bytes per session and one cache of 1,000,000 sessions; and no
    LSTM kernel launched across the phase."""
    import gc

    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.serve import LocalClient, PolicyServer, ServeConfig, reference_act

    t0 = time.perf_counter()
    card = card_line()
    launches0 = dict(K.launch_counts)
    base = PRESETS["atari"]().replace(action_dim=3, **ON_CATCH_BF16)
    arms = {"fp32": base.replace(compute_dtype="float32"),
            "bf16": base.replace(precision="bf16"),
            "int8": base.replace(precision="bf16", serve_quantization="int8")}

    # parity: every bucket, fp32 and bf16, serial and pipelined
    for label in ("fp32", "bf16"):
        for pipelined in (False, True):
            srv = serve_parity(arms[label], f"{label} {'pipelined' if pipelined else 'serial'}",
                               pipelined, dev)
        # one served batch on the card against the same batch on the CPU
        cpu = PolicyServer(arms[label], ServeConfig(buckets=(32,), cache_capacity=64),
                           params={k: v.cpu() for k, v in srv.served_params().items()},
                           device="cpu")
        rng = np.random.default_rng(5)
        obs = rng.integers(0, 255, (32, *base.obs_shape), dtype=np.uint8)
        group = [[[(f"cpu-{i}", obs[i], 0.0, True) for i in range(32)]]]
        got, want = (np.stack([r.q for r in _serve_through_loop(s, group)[0][0][0]])
                     for s in (srv, cpu))
        tol = {} if label == "fp32" else BF16_AGREE
        rtol, atol = tol.get("rtol", 1e-4), tol.get("atol", 1e-5)
        ok = bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))
        say("serve", f"{label}: one bucket-32 batch on the card against the CPU: max |dq| "
            f"{float(np.abs(got - want).max()):.3e} (rtol {rtol}, atol {atol})")
        if not ok:
            fail(f"serve {label}: the card's batch differs from the CPU's")
        del srv, cpu
        gc.collect()
        torch.cuda.empty_cache()

    # the int8 arm: bit for bit its dequantized reference, drift bounded
    # against the float arm on one session's stream
    scfg = ServeConfig(buckets=(2, 4), max_wait_ms=1.0, cache_capacity=16)
    fp = PolicyServer(arms["fp32"], scfg, device=dev)
    q8 = PolicyServer(arms["fp32"].replace(serve_quantization="int8"), scfg, device=dev)
    for s in (fp, q8):
        s.warmup()
        s.start()
    deq = q8.served_params()
    rng = np.random.default_rng(0)
    h = c = torch.zeros((1, base.hidden_dim), device=dev)
    last, drift, top = 0, 0.0, 0.0
    try:
        for t in range(12):
            o = rng.integers(0, 255, base.obs_shape, dtype=np.uint8)
            r = 0.0 if t == 0 else float(rng.random())
            a = LocalClient(fp).act("s", o, reward=r, reset=t == 0)
            b = LocalClient(q8).act("s", o, reward=r, reset=t == 0)
            qr, (h, c) = reference_act(q8.net, deq, o[None], np.array([last]),
                                       np.array([r], np.float32), (h, c), min_batch=b.bucket,
                                       row=b.row)
            if not np.array_equal(qr[0].cpu().numpy(), b.q):
                fail("serve int8: the served Q differs from reference_act on the "
                     "dequantized parameters")
            last = b.action
            drift = max(drift, float(np.abs(b.q - a.q).max()))
            top = max(top, float(np.abs(a.q).max()))
    finally:
        fp.stop()
        q8.stop()
    say("serve", f"int8 ({q8.quantized_leaves} leaves): bit for bit its dequantized reference; "
        f"Q drift against fp32 {drift:.3e} of max |Q| {top:.3e} = {drift / top:.4f} (bound "
        f"{INT8_DRIFT})")
    if drift / top >= INT8_DRIFT:
        fail(f"serve int8: drift {drift / top:.4f} over {INT8_DRIFT}")
    del fp, q8
    gc.collect()
    torch.cuda.empty_cache()

    # open-loop load, three rates an arm
    rows = {label: serve_load(cfg, label, dev, tmp, card) for label, cfg in arms.items()}

    # sessions per card
    from r2d2_tpu_torch.serve.state_cache import RecurrentStateCache

    per = {lb: RecurrentStateCache(1, base.hidden_dim, dtype=arms[lb].state_dtype,
                                   device=dev).session_carry_bytes for lb in ("fp32", "bf16")}
    big = PolicyServer(arms["fp32"], ServeConfig(buckets=(32,), cache_capacity=SESSIONS_PER_CARD),
                       device=dev)
    big.warmup()
    res = _serve_through_loop(big, [[[(f"big-{i}", obs[i], 0.0, True)
                                      for i in range(32)]]])[0][0][0]
    slots = [big.cache._slots[f"big-{i}"] for i in range(32)]
    q, _ = reference_act(big.net, big.served_params(), obs, np.zeros(32, np.int32),
                         np.zeros(32, np.float32),
                         (torch.zeros((32, base.hidden_dim), device=dev),) * 2, min_batch=32)
    if not np.array_equal(np.stack([r.q for r in res]), q.cpu().numpy()):
        fail("serve: the batch on the 1,000,000-session cache's last rows differs from "
             "reference_act")
    say("serve", f"sessions per card: {per['fp32']} carry bytes a session in fp32, "
        f"{per['bf16']} in bf16 (H={base.hidden_dim}); a cache of {SESSIONS_PER_CARD:,} "
        f"sessions holds {big.cache.device_bytes():,} bytes on the card; a batch of 32 on its "
        f"rows {min(slots)}..{max(slots)} equals reference_act bit for bit")
    del big
    gc.collect()
    torch.cuda.empty_cache()

    moved = {k: v - launches0.get(k, 0) for k, v in K.launch_counts.items()
             if v != launches0.get(k, 0)}
    if moved:
        fail(f"serve: the phase launched LSTM kernels: {moved}")
    say("serve", f"[{card}] no LSTM kernel launched across the phase; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return rows


def _offline_blocks(cfg, rows):
    """A session's served rows (tap records: obs, action, q, reward, reset,
    epsilon, version, carries) through a bare SequenceAccumulator with the
    serving shift applied by hand, as tests/test_torch_liveloop.py's
    offline reference does, the final partial cut from its pending Q (the
    tap's flush). -> [(block, priorities, episode reward, eps stamps,
    version stamps)]."""
    import numpy as np
    from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator

    acc, out, eps_s, ver_s, pending = SequenceAccumulator(cfg), [], [], [], None

    def cut(last_q):
        out.append((*acc.finish(last_qval=last_q), np.asarray(eps_s, np.float32),
                    np.asarray(ver_s, np.int64)))
        eps_s.clear()
        ver_s.clear()

    for t, r in enumerate(rows):
        if t == 0:
            acc.reset(r["obs"])
        else:
            a, q, hid, eps, ver = pending
            acc.add(a, r["reward"], r["obs"], q, hid)
            eps_s.append(eps)
            ver_s.append(ver)
            if r["reset"]:
                cut(None)
                acc.reset(r["obs"])
            elif acc.size == cfg.block_length:
                cut(r["q"])
        pending = (r["action"], r["q"], np.stack([r["h"], r["c"]]), r["eps"], r["version"])
    if acc.size > 0:
        cut(pending[1])
    return out


def fleet_phase(dev, tmp):
    """Phase 26: the serving fleet (M14b) and the live loop (M15) at the
    atari preset's widths on catch, bf16 as the preset ships it, two
    replicas on one card: (a) fleet parity and affinity, (b) reloads in
    lockstep, (d) the ladder's rungs, (c) a kill with migration, (e) a
    scripted autoscaler's scale-up and drain, (f) the flash_crowd and
    replica_kill scenarios with the ladder and the autoscaler running, (g)
    the live loop training on served traffic and hot-reloading the fleet.
    -> the live loop's kernel launches and a batch of its replay's seams,
    for the kernels line."""
    import gc
    import threading

    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.learner import init_train_state
    from r2d2_tpu_torch.envs.catch import CatchHostEnv
    from r2d2_tpu_torch.liveloop import LiveLoopPlane, LiveLoopTrainer
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.serve import (
        RUNGS,
        AutoscaleConfig,
        Autoscaler,
        LocalClient,
        MultiDeviceServer,
        QueueFullError,
        ScenarioRunner,
        ServeConfig,
        SessionRouter,
        builtin_scenarios,
        reference_act,
    )
    from r2d2_tpu_torch.utils.checkpoint import latest_checkpoint_step, save_checkpoint

    t0 = time.perf_counter()
    card = card_line()
    base = PRESETS["atari"]().replace(action_dim=3, **ON_CATCH_BF16)
    H = base.hidden_dim

    # (a)-(e) on one fleet: the ladder on, pinned at rung 0 until (d)
    ckpt = os.path.join(tmp, "fleet")
    os.makedirs(ckpt)
    cfg = base.replace(serve_degrade=True, serve_spill=4 * FLEET_SESSIONS)
    fleet = MultiDeviceServer(cfg, ServeConfig(buckets=SERVE_BUCKETS, max_wait_ms=1.0,
                                               queue_depth=FLEET_QUEUE, cache_capacity=64,
                                               poll_interval_s=0.05),
                              checkpoint_dir=ckpt, devices=[dev, dev])
    a_net, b_net = (r.net for r in fleet.replicas)
    if a_net is b_net or {p.data_ptr() for p in a_net.parameters()} & {
            p.data_ptr() for p in b_net.parameters()}:
        fail("fleet: two replicas share a network module")
    fleet.degrade.pin(0)
    fleet.warmup()
    shapes = [r.trace_count for r in fleet.replicas]
    if shapes != [3 * len(SERVE_BUCKETS)] * 2:
        fail(f"fleet: warmup ran {shapes} step shapes, not 3 arms x {len(SERVE_BUCKETS)} buckets")

    # the admission rung's bounded shed, on queues no loop drains yet
    fleet.degrade.pin("admit")
    limit = fleet.replicas[0].batcher.stats()["admit_limit"]
    fleet.set_admission(limit, budget=FLEET_SHED_BUDGET)
    per = limit + FLEET_SHED_BUDGET + 4
    obs0 = np.zeros(base.obs_shape, np.uint8)
    futs = [fleet.submit(f"shed-{i}", obs0, reset=True) for i in range(2 * per)]
    shed = sum(isinstance(f.exception(timeout=0) if f.done() else None, QueueFullError)
               for f in futs)
    if shed != 2 * FLEET_SHED_BUDGET or fleet.stats()["shed"] != shed:
        fail(f"fleet: {shed} sheds of {2 * per} submissions at the watermark {limit} with a "
             f"budget of {FLEET_SHED_BUDGET} a replica")
    fleet.degrade.pin(0)
    fleet.start()
    admitted = [f for f in futs if not (f.done() and f.exception() is not None)]
    for f in admitted:
        f.result(timeout=30.0)
    for i in range(2 * per):
        fleet.evict(f"shed-{i}")
    say("fleet", f"ladder admission at queue {limit} of {FLEET_QUEUE}: {shed} of {2 * per} "
        f"submissions shed with QueueFullError inside a budget of {FLEET_SHED_BUDGET} a "
        f"replica, then admitted again; the {len(admitted)} admitted all answered")

    zero = torch.zeros((1, H), device=dev)
    sess = {}
    rng = np.random.default_rng(26)

    def serve_round(sids, label, kill=None):
        """One request a session, all queued at once (the batches form by
        replica); each answer against its replica's reference_act at its
        bucket and row, the session's carry and action carried on. `kill`
        retires that replica while the round is queued. -> the kill's
        outcome."""
        obs = rng.integers(0, 255, (len(sids), *base.obs_shape), dtype=np.uint8)
        rew = rng.normal(size=len(sids)).astype(np.float32)
        fresh = [sid not in sess for sid in sids]
        fs = [fleet.submit(sid, obs[i], reward=float(rew[i]), reset=fresh[i])
              for i, sid in enumerate(sids)]
        outcome = None if kill is None else fleet.kill_replica(kill)
        for i, (sid, f) in enumerate(zip(sids, fs)):
            res = f.result(timeout=30.0)
            rep = fleet.replica_for(sid)
            h, c, last = sess.get(sid, (zero, zero, 0))
            reward = 0.0 if fresh[i] else float(rew[i])
            q, (h, c) = reference_act(rep.net, rep.served_params(), obs[i][None],
                                      np.array([last]), np.array([reward], np.float32), (h, c),
                                      min_batch=res.bucket, row=res.row)
            if not np.array_equal(q[0].cpu().numpy(), res.q) or \
                    res.params_version != rep._published[2]:
                fail(f"fleet {label}: {sid} at bucket {res.bucket} row {res.row} (version "
                     f"{res.params_version}) differs from its replica's reference_act (max |dq| "
                     f"{float(np.abs(q[0].cpu().numpy() - res.q).max()):.3e})")
            sess[sid] = (h.to(cfg.state_dtype), c.to(cfg.state_dtype), res.action)
        return outcome

    def lockstep(label):
        alive = fleet._alive()
        cells = {(r._published[1], r._published[2], r._published[3]) for r in alive}
        want = {(fleet._ckpt_step, fleet._version, fleet._arm)}
        if cells != want:
            fail(f"fleet {label}: the replicas publish {cells}, the fleet {want}")

    # (a) parity and affinity
    sids = [f"fleet-{i}" for i in range(FLEET_SESSIONS)]
    serve_round(sids, "parity")
    owners = {sid: fleet.router.peek(sid) for sid in sids}
    sim = SessionRouter(2)
    if [sim.route(sid) for sid in sids] != [owners[s] for s in sids] or \
            fleet.router.counts() != [FLEET_SESSIONS // 2] * 2:
        fail(f"fleet: placements {owners} are not least-loaded (counts "
             f"{fleet.router.counts()})")
    for k in range(FLEET_ROUNDS - 1):
        serve_round(sids, "parity")
    if {sid: fleet.router.peek(sid) for sid in sids} != owners:
        fail("fleet: a session changed replica")
    say("fleet", f"(a) {FLEET_SESSIONS} sessions x {FLEET_ROUNDS} rounds over 2 replicas on "
        f"{dev} (each its own module): every answer equals its replica's reference_act at its "
        f"bucket and row bit for bit; placements least-loaded (counts "
        f"{fleet.router.counts()}, as a fresh router places them); no session moved")

    # (b) reloads through the fleet's watcher, the full arm then int8
    _, state = init_train_state(cfg, dev, seed=fleet.serve_cfg.seed)

    def publish(step, scale):
        with torch.no_grad():
            for p in state.net.parameters():
                p.mul_(scale)
        state.step = step
        save_checkpoint(ckpt, state, 0, 0.0)
        deadline = time.monotonic() + 20.0
        while fleet._ckpt_step != step and time.monotonic() < deadline:
            time.sleep(0.01)
        if fleet._ckpt_step != step or latest_checkpoint_step(ckpt) != step:
            fail(f"fleet: the watcher never published step {step}")

    publish(1, 1.01)
    lockstep("reload fp32")
    serve_round(sids, "reload fp32")
    fleet.set_arm("int8")
    publish(2, 0.99)
    lockstep("reload int8")
    q8 = [{k: v for k, v in r._published[0].items() if isinstance(v, dict)}
          for r in fleet.replicas]
    if not q8[0] or q8[0].keys() != q8[1].keys() or any(
            not torch.equal(q8[0][k][kk], q8[1][k][kk]) for k in q8[0] for kk in q8[0][k]):
        fail("fleet: the replicas' int8 tensors differ after the reload")
    serve_round(sids, "reload int8")
    fleet.set_arm("full")
    say("fleet", f"(b) checkpoints 1 (fp32 weights) and 2 (int8, {len(q8[0])} quantized leaves "
        f"each, the same bits on both) through the watcher: both replicas at (step, version) "
        f"({fleet._ckpt_step}, {fleet._version}) in lockstep; every answer bit for bit its "
        f"reference; {fleet.reloads} reloads")

    # (d) the ladder, pinned 0 -> 3 -> 0
    probes = rng.integers(0, 255, (4, *base.obs_shape), dtype=np.uint8)
    probe_q = {}
    stamps0 = len(fleet.degrade.transitions)
    for n, rung in enumerate((0, 1, 2, 3, 2, 1, 0)):
        before = (fleet._ckpt_step, fleet._version, fleet._arm)
        fleet.degrade.pin(rung)
        arm = {2: "bf16", 3: "int8"}.get(rung, "full")
        lockstep(f"rung {RUNGS[rung]}")
        if fleet._arm != arm or fleet._ckpt_step != before[0] or \
                fleet._version != before[1] + (arm != before[2]):
            fail(f"fleet: rung {RUNGS[rung]} published {fleet._arm} at (step, version) "
                 f"({fleet._ckpt_step}, {fleet._version}) after {before}")
        serve_round(sids, f"rung {RUNGS[rung]}")
        pf = [fleet.submit(f"probe-{n}-{k}", probes[k], reset=True) for k in range(4)]
        probe_q.setdefault(arm, np.stack([f.result(timeout=30.0).q for f in pf]))
        for k in range(4):
            fleet.evict(f"probe-{n}-{k}")
    top = float(np.abs(probe_q["full"]).max())
    drift = {a: float(np.abs(probe_q[a] - probe_q["full"]).max()) / top for a in ("bf16", "int8")}
    stamps = fleet.degrade.transitions[stamps0:]
    if drift["bf16"] >= 0.05 or drift["int8"] >= INT8_DRIFT or len(stamps) != 6 or any(
            t[3] != "pinned" for t in stamps):
        fail(f"fleet ladder: drift {drift}, transitions {stamps}")
    say("fleet", f"(d) rungs 0->3->0 pinned on both replicas in lockstep, ckpt_step kept, the "
        f"version bumped at each arm change; every answer bit for bit its reference under the "
        f"arm it was served in; probe Q drift against the full arm: bf16 {drift['bf16']:.4f}, "
        f"int8 {drift['int8']:.4f} of max |Q| {top:.3e} (bounds 0.05, {INT8_DRIFT}); "
        f"{len(stamps)} transitions stamped 'pinned'; [{card}]")

    # (c) kill the busier replica with a round queued on it
    counts = fleet.router.counts()
    victim = max(range(2), key=lambda i: (counts[i], i))
    out = serve_round(sids, "kill", kill=victim)
    st = fleet.stats()
    if out != {"migrated": counts[victim], "lost": 0, "restarted": 0} or st["sessions_lost"]:
        fail(f"fleet: the kill of replica {victim} ({counts[victim]} sessions): {out}")
    serve_round(sids, "after the kill")
    say("fleet", f"(c) replica {victim} killed with a round queued: {out['migrated']} sessions "
        f"migrated (its {counts[victim]}), 0 lost, {st['requests_rerouted']} queued requests "
        f"carried over; every answer continues its carry bit for bit")

    # (e) a scripted autoscaler: pressure adds a warmed replica, health
    # drains the less-loaded one through migration
    auto = Autoscaler(fleet, AutoscaleConfig(min_replicas=1, max_replicas=2, dwell_up=2,
                                             dwell_down=2, cooldown_s=0.0, min_samples=4,
                                             drain_requires_idle=False))
    auto.window.reset()
    for _ in range(8):
        auto.window.observe(0.2)
    events = [auto.evaluate_once() for _ in range(2)]
    new = fleet.replicas[-1]
    if events != [None, "up"] or fleet.active_replicas() != 2 or \
            new.trace_count != 3 * len(SERVE_BUCKETS):
        fail(f"fleet autoscale up: {events}, {fleet.active_replicas()} active, the new "
             f"replica's step shapes {new.trace_count}")
    lockstep("scale up")
    gen_b = [f"fleet-b{i}" for i in range(FLEET_SESSIONS // 2)]
    serve_round(sids + gen_b, "scaled up")
    if any(fleet.replica_for(s) is not new for s in gen_b):
        fail("fleet: new sessions did not go to the added (least-loaded) replica")
    auto.window.reset()
    for _ in range(8):
        auto.window.observe(0.001)
    events = [auto.evaluate_once() for _ in range(2)]
    st = fleet.stats()
    if events != [None, "down"] or fleet.active_replicas() != 1 or st["sessions_lost"] or \
            st["sessions_migrated"] != counts[victim] + len(gen_b):
        fail(f"fleet autoscale down: {events}, {st['sessions_migrated']} migrated, "
             f"{st['sessions_lost']} lost")
    serve_round(sids + gen_b, "drained")
    fleet.check()
    say("fleet", f"(e) scripted signal: a pressured window added replica {len(fleet.replicas) - 1} "
        f"(warmed, {new.trace_count} step shapes, at the fleet's version {fleet._version}), "
        f"{len(gen_b)} new sessions landed on it; a healthy one drained it through migration "
        f"({len(gen_b)} migrated, 0 lost); every answer of the {len(sids) + len(gen_b)} "
        f"sessions bit for bit; phase so far {time.perf_counter() - t0:.1f}s")
    fleet.stop()
    del fleet, auto, a_net, b_net, state
    gc.collect()
    torch.cuda.empty_cache()

    # (f) scenarios with the ladder and the autoscaler running
    f_cfg = base.replace(serve_degrade=True, serve_autoscale=True, serve_devices=2,
                         autoscale_min_replicas=2, autoscale_max_replicas=3,
                         serve_degrade_slo_ms=SERVE_SLO_MS, serve_spill=8 * SCENARIO_SESSIONS)
    fleet = MultiDeviceServer(f_cfg, ServeConfig(buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                                                 cache_capacity=64), devices=[dev, dev])
    fleet.warmup()
    fleet.start()
    specs = {s.name: s for s in builtin_scenarios(base_rate=SCENARIO_RATE,
                                                  duration_s=SCENARIO_SECONDS,
                                                  sessions=SCENARIO_SESSIONS, seed=0)}
    try:
        for name in ("flash_crowd", "replica_kill"):
            s0 = fleet.stats()
            row = ScenarioRunner(fleet, specs[name], slo_ms=SERVE_SLO_MS).run()
            s1 = fleet.stats()
            row.update({
                "sessions_lost": s1["sessions_lost"] - s0["sessions_lost"],
                "sessions_migrated": s1["sessions_migrated"] - s0["sessions_migrated"],
                "scale_ups": s1["autoscale_scale_ups"] - s0["autoscale_scale_ups"],
                "scale_downs": s1["autoscale_scale_downs"] - s0["autoscale_scale_downs"],
                "rung_ups": s1["degrade_rung_ups"] - s0["degrade_rung_ups"],
                "rung_downs": s1["degrade_rung_downs"] - s0["degrade_rung_downs"],
                "active_replicas": fleet.active_replicas(), "card": card})
            say("fleet", "(f) " + json.dumps(row))
            kills = 1 if specs[name].kill_at > 0 else 0
            if (row["sessions_lost"] or row["errors"]["timeout"] or row["errors"]["transport"]
                    or row["replica_kills"] != kills or not row["ok"]):
                fail(f"fleet scenario {name}: {row}")
        counts = fleet.check()
        if any(counts.values()):
            fail(f"fleet scenarios: worker restarts or stalls {counts}")
    finally:
        fleet.stop()
    del fleet
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the live loop: catch sessions served by the fleet feed replay,
    # the trainer learns from it and the fleet hot-reloads its checkpoints
    g_cfg = base.replace(liveloop=True, checkpoint_dir=os.path.join(tmp, "live"),
                         save_interval=LIVE_SAVE_INTERVAL, serve_spill=4 * LIVE_SESSIONS,
                         liveloop_tap_depth=LIVE_TAP_DEPTH)
    trainer = LiveLoopTrainer(g_cfg, device=dev)
    fleet = MultiDeviceServer(g_cfg, ServeConfig(buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                                                 cache_capacity=64, poll_interval_s=0.25),
                              checkpoint_dir=g_cfg.checkpoint_dir, devices=[dev, dev])
    plane = LiveLoopPlane(g_cfg, fleet, trainer.replay, seed=0)
    records, emitted = [], []
    observe = plane.tap.observe_batch

    def record(sids, obs, actions, q, rewards, resets, eps, ckpt_step, version, h, c, slots,
               rows=None):
        records.append((list(sids), obs, np.array(actions), np.array(q), rewards, resets,
                        eps, int(version), rows))
        return observe(sids, obs, actions, q, rewards, resets, eps, ckpt_step, version, h, c,
                       slots, rows=rows)

    def emit(block, prios, ep_reward):
        emitted.append((block, prios, ep_reward, plane.tap.audit_tail[-1]))
        plane.bridge.offer(block, prios, ep_reward)

    plane.tap.observe_batch = record
    plane.tap.set_emit(emit)
    fleet.warmup()
    fleet.start(watch_checkpoints=True)
    plane.start()
    versions0 = [r._published[2] for r in fleet.replicas]
    stop, lock = threading.Event(), threading.Lock()
    client_log = {f"live-{i}": [] for i in range(LIVE_SESSIONS)}
    lat = []

    def session(i):
        sid = f"live-{i}"
        env = CatchHostEnv(height=g_cfg.obs_shape[0], width=g_cfg.obs_shape[1], seed=1000 + i)
        srng = np.random.default_rng(1000 + i)
        client = LocalClient(fleet)
        obs, reward, reset = env.reset(), 0.0, True
        while not stop.is_set():
            t_sub = time.perf_counter()
            res = client.act(sid, obs, reward=reward, reset=reset)
            with lock:
                lat.append((t_sub, time.perf_counter() - t_sub))
            client_log[sid].append((obs, np.float32(reward), reset, res.action))
            obs, reward, done, _ = env.step(res.action)
            reset = bool(done)
            if done:
                obs = env.reset()  # the terminal reward rides the reset request
            time.sleep(srng.exponential(1.0 / LIVE_RATE))

    threads = [threading.Thread(target=session, args=(i,), daemon=True)
               for i in range(LIVE_SESSIONS)]
    for th in threads:
        th.start()
    t_live = time.perf_counter()
    deadline = time.monotonic() + LIVE_DEADLINE
    updates, bad, t_train = 0, [], None
    launches = {}  # the measured launches of every live update, added up

    def update():
        before = dict(K.launch_counts)
        n = trainer.train(1)
        moved = {k: v - before.get(k, 0) for k, v in K.launch_counts.items()
                 if v != before.get(k, 0)}
        if moved != {"lstm_fwd_bf16": 2, "lstm_seq_bwd_bf16": 1}:
            bad.append(moved)
        for k, v in moved.items():
            launches[k] = launches.get(k, 0) + v
        return n

    try:
        while updates < LIVE_UPDATES and time.monotonic() < deadline:
            plane.check()
            if not trainer.can_train():
                time.sleep(0.05)
                continue
            if t_train is None:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t_train = time.perf_counter()
            updates += update()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the fleet reloads the last checkpoint before the traffic stops
        last_ckpt = latest_checkpoint_step(g_cfg.checkpoint_dir)
        wait_until = time.monotonic() + 10.0
        while fleet._ckpt_step != last_ckpt and time.monotonic() < wait_until:
            time.sleep(0.05)
        # the same updates with the traffic stopped: what serving beside the
        # learner costs it
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
        idle = 0
        t_idle = time.perf_counter()
        while idle < LIVE_IDLE_UPDATES and trainer.can_train():
            idle += update()
        torch.cuda.synchronize()
        idle_ms = 1e3 * (time.perf_counter() - t_idle) / max(idle, 1)
        # the tap's and the ingest's restarts and stalls, read while their
        # workers still run (stop() drops the supervisor)
        loop_counts = plane.check()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
        plane.stop()
        trainer.finish()
        counts = fleet.check()
        st = fleet.stats()
        fleet.stop()
    loop = plane.stats()
    versions1 = [r._published[2] for r in fleet.replicas]
    if t_train is None or updates < LIVE_UPDATES or idle < LIVE_IDLE_UPDATES or bad:
        ready = "never" if t_train is None else f"after {t_train - t_live:.1f}s"
        fail(f"liveloop: {updates} updates of {LIVE_UPDATES} in {LIVE_DEADLINE:.0f}s (replay "
             f"ready {ready}, {trainer.replay.env_steps} transitions), launches off 2 K1-bf16 "
             f"+ 1 K2-bf16 in {len(bad)}: {bad[:3]}")
    if (st["reloads"] < 1 or not all(b > a for a, b in zip(versions0, versions1))
            or st["sessions_lost"] or any(counts.values()) or any(loop_counts.values())
            or loop["tap_captured_steps"] <= 0 or loop["bridge_ingested_blocks"] <= 0
            or loop["tap_dropped_batches"]):
        fail(f"liveloop: reloads {st['reloads']}, versions {versions0} -> {versions1}, lost "
             f"{st['sessions_lost']}, workers {counts} {loop_counts}, loop {loop}")
    # the served stream as the tap recorded it is the clients' own stream
    rows_of = {sid: [] for sid in client_log}
    for sids, obs, actions, q, rewards, resets, eps, version, (h_rows, c_rows) in records:
        for i, sid in enumerate(sids):
            rows_of[sid].append(dict(obs=obs[i], action=int(actions[i]), q=q[i],
                                     reward=float(rewards[i]), reset=bool(resets[i]),
                                     eps=float(eps[i]), version=version, h=h_rows[i],
                                     c=c_rows[i]))
    for sid, log in client_log.items():
        rows = rows_of[sid]
        if len(rows) != len(log) or any(
                not np.array_equal(r["obs"], o) or r["reward"] != float(rw) or r["reset"] != rs
                or r["action"] != a for r, (o, rw, rs, a) in zip(rows, log)):
            fail(f"liveloop: the tap's record of {sid} is not the stream its client served")
    # the tap's blocks against an offline accumulator fed that stream
    per = {sid: [] for sid in client_log}
    for block, prios, ep_reward, audit in emitted:
        per[audit["session"]].append((block, prios, ep_reward, audit))
    n_blocks = 0
    for sid, rows in rows_of.items():
        want = _offline_blocks(g_cfg, rows)
        got = per[sid]
        if len(got) != len(want):
            fail(f"liveloop: {sid} emitted {len(got)} blocks, the offline accumulator "
                 f"{len(want)}")
        for (gb, gp, ge, audit), (wb, wp, we, w_eps, w_ver) in zip(got, want):
            same = all(np.array_equal(np.asarray(getattr(gb, f)), np.asarray(getattr(wb, f)))
                       for f in ("obs", "last_action", "last_reward", "action", "n_step_reward",
                                 "gamma", "hidden", "burn_in_steps", "learning_steps",
                                 "forward_steps"))
            if not (same and gb.num_sequences == wb.num_sequences and np.array_equal(gp, wp)
                    and ge == we and np.array_equal(audit["epsilon"], w_eps)
                    and np.array_equal(audit["params_version"], w_ver)):
                fail(f"liveloop: a block of {sid} differs from the offline accumulator's")
            n_blocks += 1
    wall = t_end - t_train
    spans = trainer.trainer.update_seconds
    alone = statistics.median(spans[-(updates + idle):-idle]) * 1e3
    idle_alone = statistics.median(spans[-idle:]) * 1e3
    served = [d for t, d in lat if t_train <= t <= t_end]
    p99 = float(np.percentile(served, 99) * 1e3)
    vstamps = sorted({int(v) for *_, a in emitted for v in a["params_version"]})
    say("fleet", f"(g) live loop: {LIVE_SESSIONS} catch sessions at {LIVE_RATE:.0f} requests/s "
        f"each through LocalClient, two replicas on {dev}; replay at learning_starts "
        f"{g_cfg.learning_starts} after {t_train - t_live:.1f}s; {updates} updates of "
        f"{{lstm_fwd_bf16: 2, lstm_seq_bwd_bf16: 1}} each, {1e3 * wall / updates:.2f} ms per "
        f"live update over the wall (the update's own span, host clock, median {alone:.2f} "
        f"ms; {updates // LIVE_SAVE_INTERVAL} checkpoints saved on the way); with the traffic "
        f"stopped {idle} more: {idle_ms:.2f} ms each over the wall, span {idle_alone:.2f} ms; "
        f"served {len(served) / wall:.1f} requests/s, p99 "
        f"{p99:.2f} ms during training; peak allocated {peak:.3f} GiB (update and fleet); "
        f"{st['reloads']} reloads, params_version {versions0} -> {versions1}; tap "
        f"{loop['tap_captured_steps']} steps, {loop['tap_emitted_blocks']} blocks, "
        f"{loop['bridge_ingested_blocks']} ingested, stamps carry versions {vstamps}; "
        f"{n_blocks} blocks equal the offline accumulator's fed the recorded served stream, "
        f"stamps included; [{card}]")
    sampled = trainer.replay.sample_batch(np.random.default_rng(0))
    del trainer, fleet, plane
    gc.collect()
    torch.cuda.empty_cache()
    say("fleet", f"[{card}] phase {time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "burn": sampled.burn_in_steps,
            "row": {"ms_per_update_wall": 1e3 * wall / updates, "update_span_ms": alone,
                    "alone_span_ms": idle_alone, "requests_per_s": len(served) / wall,
                    "p99_ms": p99, "peak_gib": peak}}


def pod_phase(tmp, live):
    """Phase 27: the pod loop across processes on the card. `live` is phase
    26's live-loop row (the same widths and offered rate in one process).
    -> the learner process's kernel launches and a batch's seams."""
    import numpy as np

    from r2d2_tpu_torch.transport.podloop import podloop_config

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_podloop import pod_failures, run_pod

    t0 = time.perf_counter()
    card = card_line()
    want = {"lstm_fwd_bf16": 2, "lstm_seq_bwd_bf16": 1}
    res = run_pod(tmp, device="cuda", preset="atari", sets=POD_SETS, hosts=POD_HOSTS,
                  sessions=POD_SESSIONS, rate=POD_RATE, seconds=POD_SECONDS,
                  kill_frac=POD_KILL_AT)
    bad = pod_failures(res, expected_launches=want)
    lr, hosts = res["learner"], res["hosts"]
    updates = int(lr.get("learner_updates", 0))
    lat = res["latency_ms"]

    def fmt(v):
        return "none" if v is None else f"{v:.2f}"

    say("pod", f"[{card}] {POD_HOSTS} serve hosts and a learner as processes on cuda:0, "
        f"atari widths on catch in bf16 ({', '.join(POD_SETS)}); ready in "
        f"{max(res['ready_s'].values()):.1f}s; {POD_SESSIONS} sessions at {POD_RATE:.0f} requests/s each "
        f"({res['offered_per_s']:.0f}/s offered) in {len(res['ready_s']) - 1 - POD_HOSTS} "
        f"client processes for {res['wall_s']:.1f}s")
    say("pod", f"ingest lag p50 {fmt(lr.get('ingest_lag_p50_ms'))} ms, p95 "
        f"{fmt(lr.get('ingest_lag_p95_ms'))} ms, max {fmt(lr.get('ingest_lag_max_ms'))} ms "
        f"(the last 512 blocks); {lr.get('ingest_blocks')} blocks ingested")
    say("pod", f"served {res['requests_per_s']:.1f} requests/s, p50 {fmt(lat[50])} ms, p95 "
        f"{fmt(lat[95])} ms, p99 {fmt(lat[99])} ms, {res['request_errors']} request errors "
        f"(the outage's included), {res['episodes']} episodes")
    wall_ms = 1e3 * lr.get("train_wall_s", 0.0) / max(updates, 1)
    say("pod", f"learner: {updates} updates, {wall_ms:.2f} ms per update over the wall "
        f"({1e3 * lr.get('train_s', 0.0) / max(updates, 1):.2f} inside train(): sampling, "
        f"the update, a checkpoint save every 20; "
        f"{1e3 * lr.get('broadcast_s', 0.0) / max(updates, 1):.2f} flattening and encoding "
        f"broadcasts), the update's span median {fmt(lr.get('update_ms_p50'))} ms; peak allocated "
        f"{fmt(lr.get('peak_allocated_gib'))} GiB; launches {lr.get('lstm_launches')}, per "
        f"update {lr.get('launches_per_update')}")
    say("pod", f"beside phase 26's live loop in one process (the same widths and offered "
        f"rate): {live['ms_per_update_wall']:.2f} ms per update over the wall, span "
        f"{live['update_span_ms']:.2f} ms ({live['alone_span_ms']:.2f} with the traffic "
        f"stopped), served {live['requests_per_s']:.1f} requests/s, p99 "
        f"{live['p99_ms']:.2f} ms, peak {live['peak_gib']:.3f} GiB")
    # what one request costs an interpreter on each side of the JSON-lines
    # frontend at these widths, on this machine's CPU (a host's own serving
    # time is not taken apart)
    obs = np.zeros(podloop_config("atari", overrides=POD_SETS).obs_shape, np.uint8)
    obs[1, 40] = obs[83, 30:33] = 255
    t = time.perf_counter()
    for _ in range(100):
        line = json.dumps({"session": "s", "obs": obs.tolist(), "reward": 0.0, "reset": False})
    enc_ms = 10 * (time.perf_counter() - t)
    t = time.perf_counter()
    for _ in range(100):
        np.asarray(json.loads(line)["obs"], np.uint8)
    dec_ms = 10 * (time.perf_counter() - t)
    say("pod", f"the JSON-lines frontend at {obs.shape}: {len(line)} bytes a request; "
        f"{enc_ms:.2f} ms to encode one (client), {dec_ms:.2f} ms to decode it (host), "
        f"host clock; each host served {[h.get('requests') for h in hosts]} requests "
        f"(h0's since its relaunch)")
    say("pod", f"checkpoints broadcast {lr.get('ingest_ckpts_broadcast')} (last version "
        f"{lr.get('params_version')}); reloads {[h.get('reloads') for h in hosts]}, "
        f"params_version {[h.get('params_version') for h in hosts]} (h0's since its "
        f"relaunch)")
    say("pod", f"wire: {lr.get('ingest_bytes_on_wire')} bytes received, "
        f"{lr.get('ingest_bytes_decoded')} decoded, codec ratio "
        f"{lr.get('ingest_codec_ratio')}; hosts sent "
        f"{[h.get('transport_bytes_on_wire') for h in hosts]} bytes")
    say("pod", f"drill: h0 SIGKILLed at {res['t_kill_s']:.1f}s (seq {res['h0_seq_at_kill']}, "
        f"learner step {res['step_at_kill']}), back on its port at {res['t_back_s']:.1f}s "
        f"(learner step {res['step_at_relaunch']}); h0's mark at the end "
        f"{lr.get('ingest_host_seq', {}).get('h0')}, the relaunched h0 spooled "
        f"{hosts[0].get('transport_spooled_blocks')} up to seq "
        f"{hosts[0].get('transport_next_seq', 0) - 1}, reconnects "
        f"{hosts[0].get('transport_reconnects')}; duplicate blocks "
        f"{lr.get('ingest_duplicate_blocks')}, sessions lost "
        f"{[h.get('sessions_lost') for h in hosts]}; exit codes {res['rcs']}; phase "
        f"{time.perf_counter() - t0:.1f}s")
    if bad:
        for name, log in res.get("logs", {}).items():
            say("pod", f"{name} stderr tail: {log}")
        fail(f"pod: {'; '.join(bad)}")
    return {"launches": lr["lstm_launches"],
            "burn": np.asarray(lr["sampled_burn_in"], np.int32)}


def dp_phase(dev, tmp, device_rows):
    """Phase 28: data parallelism. (a) the atari_v4_8 preset's sharded plane
    in one process, its four shards on cuda:0; (b) the multihost plane, two
    ranks of the train CLI on cuda:0 over gloo. -> the kernel launches of
    (a)'s K=1 run and of a rank, and the seams of (a)'s shard batches.
    `device_rows`: phase 21's rows, printed beside (a)'s."""
    import gc
    import socket

    import numpy as np
    import torch
    from r2d2_tpu_torch.config import PRESETS
    from r2d2_tpu_torch.learner import (
        DeviceBatch,
        TrainState,
        make_optimizer,
        make_sharded_train_step,
        make_train_step,
    )
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
    from r2d2_tpu_torch.replay.snapshot import restore_replay, save_replay
    from r2d2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    base = PRESETS["atari_v4_8"]().replace(**DP_CUT)
    dp = base.dp_size
    devices = ",".join(["cuda:0"] * dp)
    shard_b = base.batch_size // dp
    say("dp", f"atari_v4_8 on catch: obs {base.obs_shape} {base.encoder}, hidden "
        f"{base.hidden_dim}, T={base.seq_len}, batch {base.batch_size} in {dp} shards of "
        f"{shard_b} on {devices}, {base.compute_dtype}; cut: learning_starts 50000 -> "
        f"{base.learning_starts}, num_actors 256 -> {base.num_actors}; replay "
        f"{base.buffer_capacity} transitions (the paper's), {base.buffer_capacity // dp} a shard")

    def want(n, shards):
        return {"lstm_fwd_bf16": 2 * shards * n, "lstm_seq_bwd_bf16": shards * n}

    def sharded_update(net, target, cfg, batches, where, step, replicate=False):
        """One sharded update on `where` from copies of the networks: (loss,
        priorities, gradient norm, each parameter's clipped gradient norm),
        the state after it and the step function."""
        on = copy.deepcopy(net).to(where)
        tg = copy.deepcopy(target).to(where)
        st = TrainState(on, tg, make_optimizer(cfg, on.parameters()), step)
        fn = make_sharded_train_step(cfg, replicate=replicate)
        st, m, p = fn(st, [b.rows(slice(None), where) for b in batches])
        norms = torch.stack([q.grad.float().norm() for q in st.net.parameters()])
        return [x.detach().float().cpu() for x in (m["loss"], p.reshape(-1), m["grad_norm"],
                                                   norms)], st, fn

    def held(label, got, ref, tol):
        bad = []
        for name, a, b in zip(AGREE_NAMES, got, ref):
            diff = float((a - b).abs().max())
            if not torch.allclose(a, b, **tol):
                bad.append(f"{name} {diff:.3e}")
            say("dp", f"{label} {name}: {a.flatten()[0].item():.6f} vs "
                f"{b.flatten()[0].item():.6f} (max |diff| {diff:.3e})")
        if bad:
            fail(f"dp: {label}: " + ", ".join(bad))

    rows, out = {}, {}
    for k in DP_KS:
        warm = max(2, k)
        tr = Trainer(base.replace(updates_per_dispatch=k, training_steps=warm), device=devices)
        if tr.backward_arm != ("default", 0) or tr.mesh.dp != dp:
            fail(f"dp: atari_v4_8 resolved to {tr.backward_arm} over {tr.mesh}")
        tr.run_inline()
        tr.cfg = tr.cfg.replace(training_steps=warm + DP_UPDATES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        n0 = len(tr.update_seconds)
        K.reset_launch_counts()
        t = time.perf_counter()
        tr.run_inline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {key: v for key, v in K.launch_counts.items() if v}
        if launches != want(DP_UPDATES, dp):
            fail(f"dp: sharded K={k}: {DP_UPDATES} updates launched {launches}, expected "
                 f"{want(DP_UPDATES, dp)}")
        m = tr.metrics()
        if not math.isfinite(m["loss"]):
            fail(f"dp: sharded K={k}: loss {m['loss']}")
        row = {"path": "sharded", "K": k, "dp": dp, "updates": DP_UPDATES,
               "ms_per_update_wall": wall * 1e3 / DP_UPDATES,
               "learner_update_ms_per_update": statistics.median(tr.update_seconds[n0:]) * 1e3 / k,
               "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "allocated_gib": before / 2**30,
               "store_gb_per_shard": tr.replay.nbytes() / 1e9,
               "launches_per_update": {key: v // DP_UPDATES for key, v in launches.items()},
               "loss": m["loss"], "env_steps": m["env_steps"]}
        say("dp", f"[{card}] " + json.dumps(row))
        rows[k] = row
        if k == 1:
            out["launches"] = launches
            cfg = tr.cfg
            si = tr.replay.sample_indices(np.random.default_rng(28))
            batches = tr.replay.run_with_stores(
                lambda st: tr.plane.gather_fn(st, si.b, si.s, si.is_weights))
            out["burn"] = [b.burn_in_steps.clone() for b in batches]
            net, target, step = tr.state.net, tr.state.target_net, tr.state.step
            t = time.perf_counter()
            card_res, card_st, _ = sharded_update(net, target, cfg, batches, dev, step)
            cpu_res, _, _ = sharded_update(net, target, cfg, batches, "cpu", step)
            held(f"one sharded update (dp={dp}, {si.b.size} rows) on the card vs the CPU's plain "
                 f"versions", card_res, cpu_res, BF16_AGREE)
            say("dp", f"card vs CPU in {time.perf_counter() - t:.1f}s")
            whole = DeviceBatch(*(torch.cat(x) for x in zip(*batches)))
            on = copy.deepcopy(net)
            st1 = TrainState(on, copy.deepcopy(target), make_optimizer(cfg, on.parameters()), step)
            st1, m1, p1 = make_train_step(cfg.replace(dp_size=1, replay_plane="device"))(st1, whole)
            norms1 = torch.stack([q.grad.float().norm() for q in st1.net.parameters()])
            held(f"the dp={dp} update vs the device plane's dp=1 update on the same "
                 f"{si.b.size} rows, on the card", card_res,
                 [x.detach().float().cpu() for x in (m1["loss"], p1, m1["grad_norm"], norms1)],
                 BF16_AGREE)
            rep_res, rep_st, rep_fn = sharded_update(net, target, cfg, batches, dev, step,
                                                     replicate=True)
            held(f"the dp={dp} update with a replica per shard vs one shared module",
                 rep_res, card_res, BF16_AGREE)
            same = all(torch.equal(a, b) for a, b in zip(rep_res, card_res))
            for rnet, rtarget in rep_fn.replicas.values():
                for a, b in ((rnet, rep_st.net), (rtarget, rep_st.target_net)):
                    if not all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters())):
                        fail("dp: a replica differs from the stepped state after the update")
            say("dp", f"{len(rep_fn.replicas)} replicas on {dev} besides the state: each "
                f"bit-identical to the stepped state; the replicated update "
                f"{'equals' if same else 'differs in low bits from'} the shared one bit for bit; "
                f"the trainer's shards share its one module on one card "
                f"({len(tr.plane.step_fn.replicas)} replicas)")
            del card_st, rep_st, rep_fn, st1, batches, whole
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    for k, row in rows.items():
        one = device_rows.get("bf16", {}).get(f"device K={k}")
        beside = (f"phase 21's bf16 device plane dp=1 at K={k}: {one['ms_per_update']:.2f} ms "
                  "per update over the wall" if one else "phase 21 has no bf16 row at this K")
        say("dp", f"[{card}] sharded dp={dp} K={k}: {row['ms_per_update_wall']:.2f} ms per update "
            f"over the wall, learner_update {row['learner_update_ms_per_update']:.2f} ms per "
            f"update; {beside}; update peak {row['peak_gib']:.3f} GiB, store "
            f"{row['store_gb_per_shard']:.2f} GB a shard")

    # a sharded snapshot at SNAPSHOT_CAPACITY transitions
    s_cfg = base.replace(buffer_capacity=SNAPSHOT_CAPACITY)
    tr = Trainer(s_cfg, device=devices)
    tr.warmup()
    path = os.path.join(tmp, "sharded_snapshot.npz")
    save_replay(tr.replay, path)
    fresh = ShardedDeviceReplay(s_cfg, tr.mesh)
    restore_replay(fresh, path)
    for a, b in zip(tr.replay.stores, fresh.stores):
        for key, x in a.items():
            if not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               b[key].view(torch.int16) if x.dtype == torch.bfloat16 else b[key]):
                fail(f"dp: the sharded snapshot round trip changed store {key}")
    for a, b in zip(tr.replay.shards, fresh.shards):
        if not (np.array_equal(a.tree.leaves(), b.tree.leaves())
                and (a.block_ptr, a.size, a.ptr_advances) == (b.block_ptr, b.size, b.ptr_advances)):
            fail("dp: the sharded snapshot round trip changed a shard's tree or counters")
    if fresh._rr != tr.replay._rr:
        fail("dp: the sharded snapshot round trip moved the round-robin cursor")
    say("dp", f"sharded snapshot at {SNAPSHOT_CAPACITY} transitions in {dp} shards: "
        f"{os.path.getsize(path) / 1e6:.1f} MB, restored bit for bit (stores, trees, counters)")
    del tr, fresh
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two ranks of the train CLI, one shard each, gloo on one card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        argv = [sys.executable, "-m", "r2d2_tpu_torch.train", "--distributed", "--replay",
                "multihost", "--dp", "2", "--preset", "atari_v4_8", "--env", "catch",
                "--device", "cuda:0", "--steps", str(MULTIHOST_UPDATES)]
        for kv in MULTIHOST_SETS:
            argv += ["--set", kv]
        procs.append(subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    t = time.perf_counter()
    ranks, errs = [], []
    try:
        for pr in procs:
            o, e = pr.communicate(timeout=300)
            errs.append(e)
            if pr.returncode != 0:
                fail(f"dp: a multihost rank exited {pr.returncode}: {e[-2000:]}")
            ranks.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    n = MULTIHOST_UPDATES
    for r in ranks:
        if r["kernel_launches"] != want(n, 1) or r["process_count"] != 2 or r["dp"] != 2:
            fail(f"dp: multihost rank {r['process_index']}: launches {r['kernel_launches']} "
                 f"(expected {want(n, 1)}), {r['process_count']} processes, dp {r['dp']}")
        g, mn = r["gradient_allreduce_s"], r["min_priority_allreduce_s"]
        say("dp", f"[{card}] multihost rank {r['process_index']} of 2 on {r['local_devices']}: "
            f"{r['step']} updates, loss {r['loss']:.6f}, {r['ms_per_update_wall']:.2f} ms per "
            f"update over the wall, learner_update {r['update_span_ms_p50']:.2f} ms; gradient "
            f"all-reduce {g * 1e3 / r['gradient_allreduce_calls']:.2f} ms a call, MIN all-reduce "
            f"{mn * 1e3 / r['min_priority_allreduce_calls']:.2f} ms a call, denominator "
            f"{r['denominator_allreduce_s'] * 1e3 / r['denominator_allreduce_calls']:.2f} ms "
            f"(host clock, waits for the other rank included); the tensors gloo reduced by "
            f"collective {r['collective_paths']}; launches {r['kernel_launches']}")
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        fail("dp: the two ranks' parameters differ after the last update")
    say("dp", f"multihost: both ranks' parameters bit-identical after {n} updates (sha256 "
        f"{ranks[0]['params_sha256'][:16]}...); {time.perf_counter() - t:.1f}s for the two "
        f"processes; NCCL not used (two ranks on one card); phase "
        f"{time.perf_counter() - t0:.1f}s")
    out["rank_launches"] = ranks[0]["kernel_launches"]
    return out


def elastic_phase(dev, tmp):
    """Phase 29: M13b on the card (see the module docstring). -> {path:
    (burn seams of one batch shard, launches, hidden, LSTM input width)}
    for the kernels line."""
    import gc
    import shutil
    import socket

    import numpy as np
    import torch
    from r2d2_tpu_torch.collect import CollectDraws, make_collect_fn
    from r2d2_tpu_torch.config import PRESETS, apply_model_preset, parse_overrides
    from r2d2_tpu_torch.learner import (
        DeviceBatch,
        ShardedAdam,
        TrainState,
        init_train_state,
        make_multi_update_core,
        make_optimizer,
        make_sharded_gather_step,
        make_sharded_train_step,
        make_train_step,
        shard_optimizer,
    )
    from r2d2_tpu_torch.megastep import (
        env_rows,
        make_sharded_megastep,
        make_sharded_priority_superstep,
        superstep_generators,
        superstep_uniforms,
    )
    from r2d2_tpu_torch.ops import lstm_kernel as K
    from r2d2_tpu_torch.parallel.mesh import data_shard_devices, make_mesh, shard_slices
    from r2d2_tpu_torch.replay import device_sum_tree as dst
    from r2d2_tpu_torch.replay.control_plane import shard_config
    from r2d2_tpu_torch.replay.reshard import reshard_replay, snapshot_paths
    from r2d2_tpu_torch.replay.sharded_store import ShardedDeviceReplay
    from r2d2_tpu_torch.replay.snapshot import STORE_FIELDS, restore_replay
    from r2d2_tpu_torch.serve import PolicyServer, ServeConfig
    from r2d2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    card = card_line()
    out = {}
    base = PRESETS["atari_v4_8"]().replace(**DP_CUT)
    dp = base.dp_size
    d0 = "cuda:0" if torch.device(dev).type == "cuda" else "cpu"
    dp4 = ",".join([d0] * dp)
    COUNTERS = ("block_ptr", "size", "env_steps", "num_episodes", "episode_reward_sum",
                "total_episodes", "total_reward_sum", "ptr_advances")
    H, D = base.hidden_dim, base.hidden_dim + 3 + 1

    def want(updates, shards, bwd="lstm_seq_bwd_bf16"):
        return {"lstm_fwd_bf16": 2 * shards * updates, bwd: shards * updates}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def same_replay(a, b, what):
        for sa, sb in zip(a.stores, b.stores):
            for key in STORE_FIELDS:
                if not torch.equal(bits(sa[key]), bits(sb[key])):
                    fail(f"elastic: {what}: store {key} differs")
        for x, y in zip(a.shards, b.shards):
            if not (np.array_equal(x.tree.leaves(), y.tree.leaves())
                    and all(getattr(x, c) == getattr(y, c) for c in COUNTERS)):
                fail(f"elastic: {what}: a shard's tree or counters differ")

    def same_state(a, b, what):
        for x, y in zip(list(a.net.parameters()) + list(a.target_net.parameters()),
                        list(b.net.parameters()) + list(b.target_net.parameters())):
            if not torch.equal(x, y):
                fail(f"elastic: {what}: the networks differ")
        sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
        for i in sa:
            if not all(torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
                       for k in sa[i]):
                fail(f"elastic: {what}: the Adam state differs")

    # (a) the reshard drill ------------------------------------------------
    n, k = RESHARD_UPDATES, RESHARD_AT
    common = ["--preset", "atari_v4_8", "--env", "catch", "--snapshot-replay", "--steps", str(n),
              "--set", f"save_interval={n}", "--set", "log_interval=0"]
    for kv in MULTIHOST_SETS:
        common += ["--set", kv]
    dirs = {name: os.path.join(tmp, name) for name in "abcdef"}

    def ckpt(name):
        return ["--set", f"checkpoint_dir={dirs[name]}"]

    t = time.perf_counter()
    code_a, res_a = train_main(common + ["--device", dp4] + ckpt("a"))
    code_b, res_b = train_main(common + ["--device", dp4] + ckpt("b"), fault=f"trainer.update@{k}=sigterm")
    if code_a != 0 or code_b != 85 or not res_b.get("preempted"):
        fail(f"elastic: the dp=4 runs exited {code_a} and {code_b} (want 0 and 85)")
    say("elastic", f"atari_v4_8 dp={dp} on {dp4}: uninterrupted {n} updates (exit 0) and cut at "
        f"{k} (exit 85) in {time.perf_counter() - t:.1f}s")
    s_cfg = base.replace(**parse_overrides(MULTIHOST_SETS))
    paths = snapshot_paths(dirs["b"])
    nbytes = sum(os.path.getsize(q) for q in paths)
    mesh4 = make_mesh(dp, [d0] * dp)
    exact, plain = ShardedDeviceReplay(s_cfg, mesh4), ShardedDeviceReplay(s_cfg, mesh4)
    t = time.perf_counter()
    reshard_replay(exact, paths)
    exact_s = time.perf_counter() - t
    restore_replay(plain, paths[0])
    same_replay(exact, plain, "the exact reshard vs a plain restore")
    redeal = ShardedDeviceReplay(s_cfg.replace(dp_size=2), make_mesh(2, [d0] * 2))
    t = time.perf_counter()
    reshard_replay(redeal, paths)
    redeal_s = time.perf_counter() - t
    for c in ("env_steps", "size", "num_episodes", "total_episodes", "episode_reward_sum",
              "total_reward_sum"):
        if sum(getattr(x, c) for x in redeal.shards) != sum(getattr(x, c) for x in plain.shards):
            fail(f"elastic: the re-deal to dp=2 changed the global {c}")
    say("elastic", f"[{card}] the snapshot ({nbytes / 1e6:.1f} MB): exact reshard dp=4 -> 4 in "
        f"{exact_s * 1e3:.1f} ms, bit for bit a plain restore (stores, trees, counters); re-deal "
        f"dp=4 -> 2 in {redeal_s * 1e3:.1f} ms, {len(redeal)} transitions, the global counters "
        f"kept")
    for name in "cdef":
        shutil.copytree(dirs["b"], dirs[name])
    code_c, res_c = train_main(common + ["--device", dp4, "--resume", "--reshard"] + ckpt("c"))
    ta, tc = load_checkpoint_tensors(dirs["a"], n), load_checkpoint_tensors(dirs["c"], n)
    if code_c != 0 or res_c.get("resumed_from") != k or ta.keys() != tc.keys():
        fail(f"elastic: the dp=4 resume exited {code_c}: {res_c}")
    diff = [key for key in ta if not torch.equal(bits(ta[key]), bits(tc[key]))]
    if diff:
        fail(f"elastic: the resumed dp=4 run ends off the uninterrupted one: {diff[:5]}")
    code_d, res_d = train_main(common + ["--device", f"{d0},{d0}", "--dp", "2", "--resume",
                                  "--reshard"] + ckpt("d"))
    code_e, res_e = train_main(common + ["--device", d0, "--replay", "device", "--dp", "1",
                                  "--resume", "--reshard", "--set", "priority_plane=device"]
                        + ckpt("e"))
    for tag, code, res in (("dp=2", code_d, res_d), ("dp=1 device priority plane", code_e, res_e)):
        if code != 0 or res.get("step") != n or res.get("resumed_from") != k or "reshard_s" not in res:
            fail(f"elastic: the {tag} --reshard resume exited {code}: {res}")
        say("elastic", f"[{card}] --resume --reshard at {tag}: exit 0 at step {res['step']}, "
            f"loss {res['loss']:.6f}, reshard {res['reshard_s'] * 1e3:.1f} ms over "
            f"{res['reshard_bytes'] / 1e6:.1f} MB, launches {res.get('kernel_launches')}")
    if res_d.get("kernel_launches") != want(n - k, 2):
        fail(f"elastic: the dp=2 resume launched {res_d.get('kernel_launches')}")
    say("elastic", f"--resume --reshard at dp=4 (the exact path): networks and Adam state after "
        f"update {n} equal the uninterrupted run's bit for bit ({len(ta)} tensors)")
    live_cfg = s_cfg.replace(checkpoint_dir=dirs["f"], snapshot_replay=True)
    live = Trainer(live_cfg, device=dp4, resume=True)
    info = live.reshard_live(dp_size=1, replay_plane="device", devices=[d0])
    fresh = Trainer(live_cfg.replace(dp_size=1, replay_plane="device", reshard_on_resume=True),
                    device=d0, resume=True)
    for key in STORE_FIELDS:
        if not torch.equal(bits(live.replay.stores[key]), bits(fresh.replay.stores[key])):
            fail(f"elastic: reshard_live's store {key} differs from the resumed one")
    if not (np.array_equal(live.replay.tree.leaves(), fresh.replay.tree.leaves())
            and all(getattr(live.replay, c) == getattr(fresh.replay, c) for c in COUNTERS)):
        fail("elastic: reshard_live's tree or counters differ from the resumed one")
    same_state(live.state, fresh.state, "reshard_live vs snapshot + resume")
    say("elastic", f"[{card}] reshard_live(dp_size=1) from dp=4: {info['seconds'] * 1e3:.1f} ms "
        f"(snapshot, rebuild, re-deal; {info['bytes'] / 1e6:.1f} MB), {info['replay_size']} "
        f"transitions, env steps {info['env_steps']} kept; replay and learner state equal a fresh "
        f"--reshard resume of the same snapshot bit for bit")
    si = redeal.sample_indices(np.random.default_rng(29))
    out["reshard"] = (redeal.run_with_stores(lambda st: make_sharded_gather_step(s_cfg)(
        st, si.b, si.s, si.is_weights))[0].burn_in_steps, res_d.get("kernel_launches"), H, D)
    del live, fresh, exact, plain, redeal
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the sharded device planes at 2,000,000 ---------------------------
    N, kk = SUPERSTEP_NK
    ss_cfg = base.replace(priority_plane="device", updates_per_dispatch=kk,
                          superstep_dispatches=N, training_steps=N * kk)
    tr = Trainer(ss_cfg, device=dp4)
    tr.run_inline()
    tr.cfg = tr.cfg.replace(training_steps=N * kk * (1 + SUPERSTEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    t = time.perf_counter()
    tr.run_inline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != want(N * kk * SUPERSTEPS, dp):
        fail(f"elastic: {SUPERSTEPS} sharded supersteps launched {launches}")
    updates = N * kk * SUPERSTEPS
    row = {"path": "sharded superstep", "dp": dp, "N": N, "K": kk, "updates": updates,
           "ms_per_update_wall": wall * 1e3 / updates, "ms_per_dispatch": wall * 1e3 / (N * SUPERSTEPS),
           "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
           "store_gb_per_shard": tr.replay.nbytes() / 1e9,
           "launches_per_superstep": {key: v // SUPERSTEPS for key, v in launches.items()},
           "loss": tr.metrics()["loss"]}
    say("elastic", f"[{card}] " + json.dumps(row))
    # one sharded superstep update against the unsharded update of its rows
    rp, mesh = tr.replay, tr.mesh
    scfg = shard_config(ss_cfg, dp)
    L, S, Bs = dst.tree_layers(scfg.num_sequences), scfg.seqs_per_block, scfg.batch_size
    u = [superstep_uniforms(superstep_generators(29, 0, 1, dev, shard=i), 1, Bs, dev)
         for i in range(dp)]

    def fresh_state():
        on = copy.deepcopy(tr.state.net)
        return TrainState(on, copy.deepcopy(tr.state.target_net),
                          make_optimizer(ss_cfg, on.parameters()), tr.state.step)

    one_cfg = ss_cfg.replace(updates_per_dispatch=1, superstep_dispatches=1)
    with rp.lock:
        trees = [sh.dtree.tree for sh in rp.shards]
        nss = [torch.from_numpy(sh.num_seq_store.copy()).to(dev) for sh in rp.shards]
        st_a, _, m_a = make_sharded_priority_superstep(one_cfg, mesh, 1, 1)(
            fresh_state(), rp.stores, trees, nss, u)
        bs, ss, ps = [], [], []
        for i in range(dp):
            leaf = dst.tree_descend(trees[i], L, u[i][0, 0])
            ps.append(dst.priorities_of(trees[i], L, leaf))
            bs.append(leaf // S)
            ss.append(torch.minimum(leaf % S, torch.clamp(nss[i][bs[-1]] - 1, min=0)))
        batches = make_sharded_gather_step(ss_cfg)(rp.stores, bs, ss, ps)
    p = torch.cat(ps)
    min_p = p[p > 0].min()
    w = torch.pow(torch.maximum(p, min_p) / min_p, -ss_cfg.is_exponent)
    whole = DeviceBatch(*(torch.cat(x) for x in zip(*batches)))._replace(is_weights=w)
    st_b, m_b, _ = make_train_step(ss_cfg.replace(dp_size=1, replay_plane="device"))(
        fresh_state(), whole)
    for name in ("loss", "grad_norm"):
        a_, b_ = m_a[name].float().cpu(), m_b[name].float().cpu()
        if not torch.allclose(a_, b_, **BF16_AGREE):
            fail(f"elastic: sharded superstep {name} {float(a_)} vs unsharded {float(b_)}")
    for x, y in zip(st_a.net.parameters(), st_b.net.parameters()):
        if not torch.allclose(x.float(), y.float(), **BF16_AGREE):
            fail("elastic: the sharded superstep's parameters differ from the unsharded update's")
    say("elastic", f"one sharded superstep update (4 trees, {len(whole.obs)} rows) vs the dp=1 "
        f"update of the same rows on the card: loss {float(m_a['loss']):.6f} vs "
        f"{float(m_b['loss']):.6f}, gradient norm {float(m_a['grad_norm']):.6f} vs "
        f"{float(m_b['grad_norm']):.6f}, parameters within 1e-2 / 1e-3")
    out["sharded_superstep"] = (batches[0].burn_in_steps, launches, H, D)
    del tr, st_a, st_b, batches, whole, rp
    gc.collect()
    torch.cuda.empty_cache()

    # --mode fused on the sharded plane at 2,000,000
    kf = FUSED_SHARDED_K
    f_cfg = base.replace(collector="device", max_episode_steps=base.block_length, updates_per_dispatch=kf,
                         training_steps=kf * FUSED_SHARDED_WARM)
    tr = Trainer(f_cfg, device=dp4)
    tr.run_fused()
    tr.cfg = tr.cfg.replace(training_steps=kf * (FUSED_SHARDED_WARM + FUSED_SHARDED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    tr.run_fused()
    torch.cuda.synchronize()
    launches = {key: v for key, v in K.launch_counts.items() if v}
    if launches != want(kf * FUSED_SHARDED, dp):
        fail(f"elastic: {FUSED_SHARDED} sharded fused dispatches launched {launches}")
    ends = tr.update_ends[-FUSED_SHARDED:]
    ms = (ends[-1] - ends[0]) * 1e3 / (FUSED_SHARDED - 1)
    row = {"path": "sharded fused", "dp": dp, "K": kf, "envs": f_cfg.num_actors,
           "ms_per_dispatch": ms, "ms_per_update": ms / kf,
           "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
           "launches_per_dispatch": {key: v // FUSED_SHARDED for key, v in launches.items()},
           "loss": tr.metrics()["loss"], "env_steps": tr.metrics()["env_steps"]}
    say("elastic", f"[{card}] " + json.dumps(row))
    out["sharded_fused"] = (out["sharded_superstep"][0], launches, H, D)
    fn_env, E = tr.fn_env, f_cfg.num_actors
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # a sharded megastep at 16,000 against its parts
    m_cfg = f_cfg.replace(buffer_capacity=16_000, action_dim=3, learning_starts=FUSED_RANK_STARTS)
    El, chunk = E // dp, min(m_cfg.block_length, m_cfg.max_episode_steps)
    _, st0 = init_train_state(m_cfg, dev)
    rp = ShardedDeviceReplay(m_cfg, mesh4)
    from r2d2_tpu_torch.actor import ParamStore
    from r2d2_tpu_torch.collect import DeviceCollector

    col = DeviceCollector(m_cfg, copy.deepcopy(st0.net), ParamStore(st0.net), fn_env, rp,
                          seed=3, device=dev)
    while not rp.can_sample():
        col.step()
    before_stores = [{key: x.clone() for key, x in st.items()} for st in rp.stores]
    rng = np.random.default_rng(29)
    draws = [rp.sample_indices(rng) for _ in range(kf)]
    b, s, w = (np.stack([getattr(d_, f) for d_ in draws]) for f in ("b", "s", "is_weights"))
    env0 = fn_env.reset(E, torch.Generator(device=dev).manual_seed(5), dev)
    eps = col.epsilons
    st_a = copy.deepcopy(st0)
    starts = [1] * dp
    gens = [torch.Generator(device=dev).manual_seed(40 + i) for i in range(dp)]
    st_a, m_a, p_a, chunk_a, env_a = make_sharded_megastep(m_cfg, fn_env, [d0] * dp, E, chunk,
                                                           kf)(
        st_a, rp.stores, [env_rows(env0, slice(i * El, (i + 1) * El), dev) for i in range(dp)],
        [eps[i * El:(i + 1) * El] for i in range(dp)], [CollectDraws(g) for g in gens],
        [st_a.net] * dp, b, s, w, starts)
    bps = m_cfg.num_blocks // dp
    glob = {key: torch.cat([st[key] for st in before_stores]) for key in before_stores[0]}
    flat = [torch.from_numpy(np.ascontiguousarray(x.reshape(kf, -1))).to(dev)
            for x in (b + (np.arange(dp) * bps)[None, :, None], s, w)]
    st_b, m_b, p_b = make_multi_update_core(m_cfg.replace(replay_plane="device", dp_size=1), kf)(
        copy.deepcopy(st0), glob, *flat)
    if not (torch.allclose(p_a.reshape(kf, -1).float(), p_b.float(), **BF16_AGREE)
            and torch.allclose(m_a["loss"].float(), m_b["loss"].float(), **BF16_AGREE)
            and all(torch.allclose(x.float(), y.float(), **BF16_AGREE)
                    for x, y in zip(st_a.net.parameters(), st_b.net.parameters()))):
        fail("elastic: the sharded megastep's updates differ from the unsharded ones")
    collect = make_collect_fn(m_cfg, fn_env, El, chunk)
    for i in range(dp):
        sl = slice(i * El, (i + 1) * El)
        g = torch.Generator(device=dev).manual_seed(40 + i)
        fields, *book, env_f = collect(copy.deepcopy(st0.net), env_rows(env0, sl, dev), eps[sl],
                                       CollectDraws(g))
        if not (all(torch.equal(x[sl], y) for x, y in zip(chunk_a, book))
                and all(torch.equal(x, y) for x, y in zip(env_a[i], env_f))
                and all(torch.equal(bits(rp.stores[i][key][1:1 + El]), bits(v))
                        for key, v in fields.items())):
            fail(f"elastic: the sharded megastep's chunk of shard {i} differs from its own")
    say("elastic", f"a sharded megastep (dp={dp}, {E} envs, K={kf}) at 16,000 against its parts "
        f"on the card: each shard's chunk, slab and next env state bit for bit, the K updates "
        f"against the dp=1 updates on the concatenated store within 1e-2 / 1e-3 (loss "
        f"{float(m_a['loss']):.6f} vs {float(m_b['loss']):.6f})")
    del rp, col, st_a, st_b, glob, before_stores
    gc.collect()
    torch.cuda.empty_cache()

    # two gloo ranks of the CLI's --mode fused on the multihost plane
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        env.pop("R2D2_FAULTS", None)
        argv = [sys.executable, "-m", "r2d2_tpu_torch.train", "--distributed", "--replay",
                "multihost", "--mode", "fused", "--dp", "2", "--preset", "atari_v4_8", "--env",
                "catch", "--device", d0, "--steps", str(MULTIHOST_FUSED),
                "--updates-per-dispatch", "2", "--set", f"max_episode_steps={base.block_length}"]
        for kv in MULTIHOST_SETS:
            argv += ["--set", kv]
        # one collection chunk of 8 envs (656 transitions) opens sampling
        argv += ["--set", f"learning_starts={FUSED_RANK_STARTS}"]
        procs.append(subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    ranks = []
    t = time.perf_counter()
    try:
        for pr in procs:
            o, e = pr.communicate(timeout=300)
            if pr.returncode != 0:
                fail(f"elastic: a multihost fused rank exited {pr.returncode}: {e[-2000:]}")
            ranks.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r in ranks:
        if (r["mode"] != "fused" or r.get("kernel_launches") != want(MULTIHOST_FUSED, 1)
                or r["process_count"] != 2):
            fail(f"elastic: multihost fused rank {r.get('process_index')}: {r}")
        say("elastic", f"[{card}] multihost fused rank {r['process_index']} of 2: {r['step']} "
            f"updates, loss {r['loss']:.6f}, {r['ms_per_update_wall']:.2f} ms per update over "
            f"the wall, gradient all-reduce {r['gradient_allreduce_s'] * 1e3 / r['gradient_allreduce_calls']:.2f} "
            f"ms a call, launches {r.get('kernel_launches')}")
    if ranks[0]["params_sha256"] != ranks[1]["params_sha256"]:
        fail("elastic: the multihost fused ranks' parameters differ")
    say("elastic", f"MultiHostFusedRunner: both ranks' parameters bit-identical after "
        f"{MULTIHOST_FUSED} updates ({time.perf_counter() - t:.1f}s for the two processes)")
    # a rank's batch shard is 32 rows of this preset, as the dp=2 reshard's
    out["multihost_fused"] = (out["reshard"][0], ranks[0].get("kernel_launches"), H, D)

    # (c) tp and fsdp on the wide model at the atari widths ------------------
    w_cfg = apply_model_preset(PRESETS["atari"]().replace(env_name="catch", action_dim=3), "wide")
    Hw, Bw, T = w_cfg.hidden_dim, w_cfg.batch_size, w_cfg.seq_len
    rng = np.random.default_rng(9)
    arrs = dict(
        obs=torch.from_numpy(rng.integers(0, 255, (Bw, T, *w_cfg.obs_shape), dtype=np.uint8)),
        last_action=torch.from_numpy(rng.integers(0, 3, (Bw, T))),
        last_reward=torch.from_numpy(rng.normal(size=(Bw, T)).astype(np.float32)),
        hidden=torch.from_numpy((rng.normal(size=(Bw, 2, Hw)) * 0.3).astype(np.float32)),
        action=torch.from_numpy(rng.integers(0, 3, (Bw, w_cfg.learning_steps))),
        n_step_reward=torch.from_numpy(rng.normal(size=(Bw, w_cfg.learning_steps)).astype(np.float32)),
        gamma=torch.full((Bw, w_cfg.learning_steps), w_cfg.gamma ** w_cfg.forward_steps),
        burn_in_steps=torch.full((Bw,), w_cfg.burn_in_steps, dtype=torch.int32),
        learning_steps=torch.full((Bw,), w_cfg.learning_steps, dtype=torch.int32),
        forward_steps=torch.full((Bw,), w_cfg.forward_steps, dtype=torch.int32),
        is_weights=torch.from_numpy(rng.uniform(0.3, 1.0, Bw).astype(np.float32)))
    batch = DeviceBatch(**{key: v.to(dev) for key, v in arrs.items()})
    _, w_state = init_train_state(w_cfg, dev)
    ref = copy.deepcopy(w_state)
    ref_step = make_train_step(w_cfg)
    ref_step(copy.deepcopy(w_state), batch)  # warms the wide path
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TP_UPDATES):
        ref, m_ref, p_ref = ref_step(ref, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t) * 1e3 / TP_UPDATES
    arm_kernel = {"default": "lstm_seq_bwd_bf16", "fused_dwh": "lstm_seq_bwd_fused_bf16",
                  "ckpt": "lstm_seq_bwd_ckpt_bf16"}
    for label, tp, fsdp in TP_LAYOUTS:
        c = w_cfg.replace(tp_size=tp, fsdp_size=fsdp)
        manual = c.resolved_partitioning == "manual"
        mesh = make_mesh(1, [d0] * (tp * fsdp), tp=tp, fsdp=fsdp)
        axes = ("dp", "fsdp") if manual else ("dp",)
        shards = len(data_shard_devices(mesh, axes))
        arm = c.resolve_backward_arm(device="cuda")
        st = copy.deepcopy(w_state)
        shard_optimizer(c, st, mesh)
        step = make_sharded_train_step(c, mesh=mesh, data_axes=axes)
        parts = [batch.rows(sl, dev) for sl in shard_slices(Bw, shards)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        t = time.perf_counter()
        for _ in range(TP_UPDATES):
            st, m, p = step(st, parts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {key: v for key, v in K.launch_counts.items() if v}
        if launches != want(TP_UPDATES, shards, arm_kernel[arm[0]]):
            fail(f"elastic: {label} launched {launches} over {TP_UPDATES} updates "
                 f"(arm {arm}, {shards} batch shards)")
        got = [m["loss"], p.reshape(-1), m["grad_norm"]]
        for name, a_, b_ in zip(("loss", "priorities", "grad_norm"), got,
                                (m_ref["loss"], p_ref, m_ref["grad_norm"])):
            if not torch.allclose(a_.float(), b_.float(), **BF16_AGREE):
                fail(f"elastic: {label} {name} differs from the tp=1 update's "
                     f"(max |diff| {float((a_.float() - b_.float()).abs().max()):.3e})")
        worst = max(float((x.detach().float() - y.detach().float()).abs().max())
                    for x, y in zip(st.net.parameters(), ref.net.parameters()))
        if not all(torch.allclose(x.float(), y.float(), **BF16_AGREE)
                   for x, y in zip(st.net.parameters(), ref.net.parameters())):
            fail(f"elastic: {label}: parameters after {TP_UPDATES} updates differ from tp=1's "
                 f"(max |diff| {worst:.3e})")
        shard_shapes = (st.optimizer.moment_shards() if isinstance(st.optimizer, ShardedAdam)
                        else None)
        row = {"path": label, "tp": tp, "fsdp": fsdp, "partitioning": c.resolved_partitioning,
               "batch_shards": shards, "arm": list(arm), "updates": TP_UPDATES,
               "ms_per_update": wall * 1e3 / TP_UPDATES, "ms_per_update_tp1": ref_ms,
               "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "launches_per_update": {key: v // TP_UPDATES for key, v in launches.items()},
               "loss": float(m["loss"]), "loss_tp1": float(m_ref["loss"]),
               "max_param_diff_vs_tp1": worst}
        say("elastic", f"[{card}] " + json.dumps(row))
        if shard_shapes:
            say("elastic", f"{label}: Adam moment shards (mu; nu alike) of core.wh "
                f"{shard_shapes['core.wh']}, core.wi {shard_shapes['core.wi']}, Dense_0 "
                f"{shard_shapes['enc.tail.dense.0.weight']}, adv_out "
                f"{shard_shapes['adv_out.weight']}, one on each fsdp member's device")
        out[f"tp_{label.split()[0]}_{tp}x{fsdp}"] = (parts[0].burn_in_steps, launches, Hw,
                                                     Hw + 3 + 1)
        del st, step, parts
    say("elastic", f"tp / fsdp: every layout within 1e-2 / 1e-3 of the tp=1 update's loss, "
        f"priorities and parameters after {TP_UPDATES} updates")

    # one bucket through PolicyServer(mesh=) and mesh=None
    scfg_s = ServeConfig(buckets=(SERVE_MESH_REQUESTS,), max_wait_ms=0.0,
                         cache_capacity=SERVE_MESH_REQUESTS)
    obs = rng.integers(0, 255, (SERVE_MESH_REQUESTS, *w_cfg.obs_shape), dtype=np.uint8)
    answers = {}
    for label, kw in (("mesh", dict(mesh=make_mesh(1, [d0, d0], tp=2))), ("plain", dict(device=dev))):
        srv = PolicyServer(w_cfg, scfg_s, **kw)
        srv.warmup()
        res, _ = _serve_through_loop(srv, [[[(f"s{i}", obs[i], 0.0, True)
                                              for i in range(SERVE_MESH_REQUESTS)]]])
        answers[label] = res[0][0]
        if label == "mesh":
            pieces = srv._published[0]["core.wh"].pieces
            say("elastic", f"PolicyServer(mesh=tp 2): core.wh held as {len(pieces)} slices "
                f"{[tuple(x.shape) for x in pieces]} on {[str(x.device) for x in pieces]}")
        del srv
    for a_, b_ in zip(answers["mesh"], answers["plain"]):
        if not (a_.action == b_.action and np.array_equal(a_.q, b_.q)):
            fail("elastic: PolicyServer(mesh=) answered otherwise than mesh=None")
    say("elastic", f"PolicyServer(mesh=) answered {SERVE_MESH_REQUESTS} requests (bf16 wide) as "
        f"mesh=None does, q and actions bit for bit; phase {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_phase():
    """30. The graph checks on the card; fails on any finding."""
    from r2d2_tpu_torch.analysis import graph_rules as g
    from r2d2_tpu_torch.analysis.findings import render_text
    from r2d2_tpu_torch.config import PRESETS

    t0 = time.perf_counter()
    findings = g.scan_entry_points(device="cuda")
    say("graph", f"scan_entry_points(device='cuda'), tiny_test shapes, fp32 and bf16: "
        f"{len(findings)} findings in {time.perf_counter() - t0:.1f}s")

    def per_update(label, trace):
        n = max(trace.updates, 1)
        d = {k: v / n for k, v in sorted(trace.dispatches.items())}
        la = {k: v / n for k, v in sorted(trace.launches.items())}
        say("graph", f"{label}: per update dispatches {d}, launches {la}")
        if trace.dispatches != trace.launches:
            fail(f"graph: {label} dispatched {trace.dispatches} but launched {trace.launches}")

    for p in ("fp32", "bf16"):
        per_update(f"train_step[{p}]", g.train_step_trace(p, "cuda"))
        for arm in ("fused_dwh", "ckpt"):
            per_update(f"backward_arm[{arm}][{p}]", g.backward_arm_train_step_trace(p, arm, "cuda"))
        per_update(f"manual_train_step[dp=2,tp=2,fsdp=2,{p}]",
                   g.manual_train_step_trace(p, 2, 2, 2, "cuda"))
        per_update(f"priority_superstep[{p}]", g.priority_superstep_trace(p, "cuda"))
    t1 = time.perf_counter()
    for label, extra in (("fp32", ON_CATCH), ("bf16", ON_CATCH_BF16)):
        cfg = PRESETS["atari"]().replace(**extra)
        f, trace = g.scan_train_config(cfg, "cuda", f"atari_train_step[{label}]")
        findings += f
        per_update(f"atari_train_step[{label}] (T={cfg.seq_len}, B={cfg.batch_size}, "
                   f"H={cfg.hidden_dim})", trace)
        if {k: v for k, v in trace.launches.items() if v} != g.update_forms(cfg, "cuda"):
            fail(f"graph: atari {label} update launched {trace.launches}")
        for q in ("none", "int8"):
            f, _ = g.scan_serve_config(cfg.replace(serve_quantization=q), "cuda",
                                       f"atari_serve_step[{q},{label}]")
            findings += f
    say("graph", f"atari widths, fp32 and bf16: the train step and the serve step (none, "
        f"int8) under set_sync_debug_mode('error') in {time.perf_counter() - t1:.1f}s")
    if findings:
        print(render_text(findings), flush=True)
        fail(f"graph: {len(findings)} findings on the card")
    say("graph", f"0 findings; phase {time.perf_counter() - t0:.1f}s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="profile N more updates of the main path after the checks")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        from r2d2_tpu_torch.config import PRESETS, apply_model_preset, set_fp32_numerics
        from r2d2_tpu_torch.models.r2d2 import R2D2Network
        from r2d2_tpu_torch.ops import _build, lstm_kernel as K
    except ImportError as e:
        fail(f"the r2d2_tpu_torch package must sit beside this script ({e})")
    dev = torch.device("cuda")
    set_fp32_numerics()

    # 1. card ---------------------------------------------------------------
    card = card_line()
    say("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    say("card", f"SM clock now, max: {smi('clocks.sm,clocks.max.sm')}")

    # 2. build --------------------------------------------------------------
    t = time.perf_counter()
    names = _build.sources()
    libraries = _build.build(names)
    say("build", f"nvcc built {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t:.1f}s (each: " + ", ".join(
            f"{n} {s_:.1f}s" for n, s_ in sorted(_build.build_seconds.items())) + ")")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("build", f"{name}: {line.strip()[:160]}")
    hmma = hmma_counts(libraries)
    say("build", "HMMA instructions per instantiation (one chunk, row chunks): " + ", ".join(
        f"{k} {v}" for k, v in sorted(hmma.items())))
    for src in K.TENSOR_CORE:
        if not hmma.get(f"{src}_bf16") or min(hmma[f"{src}_bf16"]) == 0:
            fail(f"{src}_bf16 runs no tensor-core instruction: {hmma.get(f'{src}_bf16')}")

    def unit(name):
        """The unit a kernel form's products run on."""
        return ("tensor_cores" if K.tensor_cores(K._SOURCE[name], 2 if name in K.BF16_FORMS else 4)
                else "fma")

    # 3. kernels against plain versions ------------------------------------
    errs = dict.fromkeys(K.KERNELS, 0.0)

    def hold(name, got, want, where):
        e, ok = max_err(got, want)
        errs[name] = max(errs[name], e)
        if not ok:
            fail(f"{name} disagrees with its plain version {where}: {e:.3e}")

    def hold_dwh(name, got, want, where):
        e, ok = dwh_err(got, want)
        errs[name] = max(errs[name], e)
        if not ok:
            fail(f"{name}: dWh off by {e:.3e} {where}, over {DWH_TOL} x max|dWh| "
                 f"{float(want.abs().max()):.3e}")

    def zero_below(name, dz, burn, where):
        below = torch.arange(dz.shape[0], device=dev)[:, None] < burn[None, :].long()
        if dz[below].any():
            fail(f"{name}: nonzero dz below the seam {where}")

    def check(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        s = H ** -0.5
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g)
        wh = (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * s
        h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        at = f"at T={T} B={B} H={H}"
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        for got, want in zip((outs, cs), K.lstm_fwd_plain(proj, wh, h0, c0)):
            hold("lstm_fwd", got, want, at)
        hprev = torch.cat([h0[None], outs[:-1]])
        cprev = torch.cat([c0[None], cs[:-1]])
        dout = torch.randn(T, B, H, device=dev, generator=g)
        dcT = torch.randn(B, H, device=dev, generator=g)
        walk = (dout, proj, hprev, cprev, cs, wh, dcT)
        # the seamless backward: dz and the initial state's cotangents
        for got, want in zip(K.lstm_bwd(*walk), K.lstm_bwd_plain(*walk)):
            hold("lstm_bwd", got, want, at)
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        seams = (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                 ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed))
        for label, burn in seams:
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold("lstm_seq_bwd", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold("lstm_seq_bwd_fused", f_dz, p_dz, where)
            hold_dwh("lstm_seq_bwd_fused", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused", f_dz, burn, where)
        strides = [S for S in range(1, T + 1) if T % S == 0]
        for S in strides:
            # one more seam kind: every row's seam on a segment boundary
            boundary = torch.randint(0, T // S, (B,), device=dev, generator=g,
                                     dtype=torch.int32) * S
            h_ckpt = torch.cat([h0[None], outs[S - 1 : T - 1 : S]])
            c_ckpt = torch.cat([c0[None], cs[S - 1 : T - 1 : S]])
            for label, burn in (*seams, ("boundary", boundary)):
                args = (dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, S)
                k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*args)
                p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*args)
                where = f"{at} S={S} seam {label}"
                hold("lstm_seq_bwd_ckpt", k_dz, p_dz, where)
                hold_dwh("lstm_seq_bwd_ckpt", k_dwh, p_dwh, where)
                zero_below("lstm_seq_bwd_ckpt", k_dz, burn, where)
        if (T, B, H) == (85, 64, 512):
            # no float atomics: two launches give the same bits
            again = K.lstm_fwd(proj, wh, h0, c0)
            if not (torch.equal(outs, again[0]) and torch.equal(cs, again[1])):
                fail(f"lstm_fwd: two launches differ {at}")
            seam_dz = K.lstm_seq_bwd(*walk, mixed)
            if not torch.equal(seam_dz, K.lstm_seq_bwd(*walk, mixed)):
                fail(f"lstm_seq_bwd: two launches differ {at}")
            if not all(map(torch.equal, K.lstm_bwd(*walk), K.lstm_bwd(*walk))):
                fail(f"lstm_bwd: two launches differ (dz, dh0 or dc0) {at}")
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, mixed)
            again = K.lstm_seq_bwd_fused(*walk, mixed)
            if not (torch.equal(f_dz, again[0]) and torch.equal(f_dwh, again[1])):
                fail(f"lstm_seq_bwd_fused: two launches differ (dz or dWh) {at}")
            # the same walk in the same geometry: the same dz
            if not torch.equal(f_dz, seam_dz):
                fail(f"lstm_seq_bwd_fused: dz differs from lstm_seq_bwd's {at} seam mixed "
                     f"(max |diff| {float((f_dz - seam_dz).abs().max()):.3e})")
            S = 5
            args = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, dcT, mixed, S)
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*args)
            again = K.lstm_seq_bwd_ckpt(*args)
            if not (torch.equal(k_dz, again[0]) and torch.equal(k_dwh, again[1])):
                fail(f"lstm_seq_bwd_ckpt: two launches differ (dz or dWh) {at} S={S}")
            say("check", f"{at}: two launches each of lstm_fwd, lstm_seq_bwd, lstm_bwd, "
                f"lstm_seq_bwd_fused and lstm_seq_bwd_ckpt (S={S}) give identical bits; "
                f"lstm_seq_bwd_fused's dz equals lstm_seq_bwd's bit for bit, seam mixed")
            same = torch.equal(k_dz, seam_dz)
            say("check", f"{at}: lstm_seq_bwd_ckpt's dz (S={S}) {'equals' if same else 'differs from'}"
                f" lstm_seq_bwd's bit for bit at the same inputs, seam mixed (max |diff| "
                f"{float((k_dz - seam_dz).abs().max()):.3e}; not required)")
        torch.cuda.synchronize()
        say("check", f"T={T} B={B} H={H}: all five kernels (seams 0, mid, T-1, mixed; ckpt "
            f"at S in {strides}, plus seams on segment boundaries) within atol {ATOL} + rtol "
            f"{RTOL}, dWh within {DWH_TOL} x max|dWh|")

    for i, shape in enumerate(((7, 5, 32), (13, 67, 96), (3, 2, 640), (85, 64, 512),
                               (85, 64, 2048))):
        for kernel in K.COLUMN_SPLIT:
            say("check", f"T={shape[0]} B={shape[1]} H={shape[2]}: {kernel} column split "
                f"{K._geometry(shape[1], shape[2], kernel, dev)}")
        check(*shape, seed=i)
    say("check", "max |kernel - plain| (dz, dh0/dc0 and dWh alike): " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))

    def hold_bf16(name, got, want, where):
        diff = (got.float() - want.float()).abs()
        e = float(diff.max())
        errs[name] = max(errs[name], e)
        if not bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()):
            fail(f"{name} disagrees with its plain version {where}: {e:.3e}")

    def hold_dwh_bf16(name, got, want, where):
        e, _ = dwh_err(got, want)
        errs[name] = max(errs[name], e)
        if e > BF16_DWH_TOL * float(want.abs().max()):
            fail(f"{name}: dWh off by {e:.3e} {where}, over {BF16_DWH_TOL} x max|dWh|")

    def one_split(B, H, at):
        """K2-bf16 and K4-bf16 take one column split at (B, H)."""
        geos = [K._geometry(B, H, n, dev, torch.bfloat16)
                for n in ("lstm_seq_bwd", "lstm_seq_bwd_fused")]
        if geos[0] != geos[1]:
            fail(f"lstm_seq_bwd_bf16 and lstm_seq_bwd_fused_bf16 split {at} differently: {geos}")

    def hold_fused_dz(f_dz, seam_dz, where):
        """K4-bf16's dz against K2-bf16's f32 dz at the same inputs: rounded
        to bf16, bit for bit (the two walk in one split)."""
        if not torch.equal(f_dz, seam_dz.to(torch.bfloat16)):
            fail(f"lstm_seq_bwd_fused_bf16: dz differs from lstm_seq_bwd_bf16's rounded to bf16 "
                 f"{where} (max |diff| {float((f_dz.float() - seam_dz).abs().max()):.3e})")

    def check_chunks(T, B, H, seed):
        """All five kernels with the batch in row chunks (float32): against
        the plain versions, seams 0 and mixed, K5 at S=5; two launches each
        give the same bits, K4's dz is K2's; then each one's time."""
        at = f"at T={T} B={B} H={H}"
        for kernel in K.COLUMN_SPLIT:
            geo = K._geometry(B, H, kernel, dev)
            if geo.chunks(B) < 2:
                fail(f"{kernel} {at}: {geo} takes the batch in one chunk")
            say("chunks", f"{at}: {kernel} column split {geo}, {geo.chunks(B)} row chunks")
        g = torch.Generator(device=dev).manual_seed(seed)
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g)
        wh = (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * H ** -0.5
        h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        for got, want in zip((outs, cs), K.lstm_fwd_plain(proj, wh, h0, c0)):
            hold("lstm_fwd", got, want, at)
        if not all(map(torch.equal, (outs, cs), K.lstm_fwd(proj, wh, h0, c0))):
            fail(f"lstm_fwd: two launches differ {at}")
        walk = (torch.randn(T, B, H, device=dev, generator=g), proj,
                torch.cat([h0[None], outs[:-1]]), torch.cat([c0[None], cs[:-1]]), cs, wh,
                torch.randn(B, H, device=dev, generator=g))
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold("lstm_bwd", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd: two launches differ {at}")
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        S = 5
        ckpt = (walk[0], proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, walk[6])
        for label, burn in (("0", torch.zeros_like(mixed)), ("mixed", mixed)):
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold("lstm_seq_bwd", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            hold_dwh("lstm_seq_bwd_fused", f_dwh, K.lstm_seq_bwd_fused_plain(*walk, burn)[1],
                     where)
            if not torch.equal(f_dz, dz):
                fail(f"lstm_seq_bwd_fused: dz differs from lstm_seq_bwd's {where}")
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt, burn, S)
            p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt, burn, S)
            hold("lstm_seq_bwd_ckpt", k_dz, p_dz, f"{where} S={S}")
            hold_dwh("lstm_seq_bwd_ckpt", k_dwh, p_dwh, f"{where} S={S}")
            zero_below("lstm_seq_bwd_ckpt", k_dz, burn, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused: two launches differ {at}")
        if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt, mixed, S))):
            fail(f"lstm_seq_bwd_ckpt: two launches differ {at}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
        t_ms = {
            "lstm_fwd": median_ms(lambda: K.lstm_fwd(proj, wh, h0, c0), 5, flush),
            "lstm_seq_bwd": median_ms(lambda: K.lstm_seq_bwd(*walk, mixed), 5, flush),
            "lstm_bwd": median_ms(lambda: K.lstm_bwd(*walk), 5, flush),
            "lstm_seq_bwd_fused": median_ms(lambda: K.lstm_seq_bwd_fused(*walk, mixed), 5, flush),
            "lstm_seq_bwd_ckpt": median_ms(lambda: K.lstm_seq_bwd_ckpt(*ckpt, mixed, S), 5,
                                           flush),
        }
        say("chunks", f"{at}: all five kernels within atol {ATOL} + rtol {RTOL} (dWh within "
            f"{DWH_TOL} x max|dWh|), seams 0 and mixed, K5 at S={S}; two launches of each give "
            f"identical bits; lstm_seq_bwd_fused's dz equals lstm_seq_bwd's")
        say("chunks", f"{at}, seam mixed, on {card}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in t_ms.items()) + " (median of 5)")

    def bf16_operands(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        bf = torch.bfloat16
        proj = torch.randn(T, B, 4 * H, device=dev, generator=g).to(bf)
        wh = ((torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1) * H ** -0.5).to(bf)
        h0 = (torch.randn(B, H, device=dev, generator=g) * 0.3).to(bf)
        c0 = (torch.randn(B, H, device=dev, generator=g) * 0.3).to(bf)
        dout = torch.randn(T, B, H, device=dev, generator=g)
        dcT = torch.randn(B, H, device=dev, generator=g)
        mixed = torch.randint(0, T, (B,), device=dev, generator=g, dtype=torch.int32)
        outs, cs = K.lstm_fwd_plain(proj, wh, h0, c0)
        walk = (dout, proj, torch.cat([h0[None], outs[:-1]]),
                torch.cat([c0.float()[None], cs[:-1]]), cs, wh, dcT)

        def ckpt(S):
            return (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                    torch.cat([c0.float()[None], cs[S - 1 : T - 1 : S]]), wh, dcT)

        return proj, wh, h0, c0, (outs, cs), walk, ckpt, mixed

    def check_chunks_bf16(T, B, H, seed):
        """The bf16 forms of K2, K3, K4 and K5 with the batch in row chunks:
        against their plain versions, seams 0 and mixed for K2, K4 and K5
        (S=5); two launches each give the same bits, K4-bf16's dz is
        K2-bf16's rounded; their times."""
        at = f"at T={T} B={B} H={H} bf16"
        for kernel in ("lstm_seq_bwd", "lstm_bwd", "lstm_seq_bwd_fused", "lstm_seq_bwd_ckpt"):
            geo = K._geometry(B, H, kernel, dev, torch.bfloat16)
            if geo.chunks(B) < 2:
                fail(f"{kernel}_bf16 {at}: {geo} takes the batch in one chunk")
            say("chunks", f"{at}: {kernel}_bf16 column split {geo}, {geo.chunks(B)} row chunks")
        *_, walk, ckpt, mixed = bf16_operands(T, B, H, seed)
        S = 5
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold_bf16("lstm_bwd_bf16", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd_bf16: two launches differ {at}")
        one_split(B, H, at)
        for label, burn in (("0", torch.zeros_like(mixed)), ("mixed", mixed)):
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold_bf16("lstm_seq_bwd_bf16", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd_bf16", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold_bf16("lstm_seq_bwd_fused_bf16", f_dz, p_dz, where)
            hold_dwh_bf16("lstm_seq_bwd_fused_bf16", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused_bf16", f_dz, burn, where)
            hold_fused_dz(f_dz, dz, where)
            k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S)
            p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)
            hold_bf16("lstm_seq_bwd_ckpt_bf16", k_dz, p_dz, f"{where} S={S}")
            hold_dwh_bf16("lstm_seq_bwd_ckpt_bf16", k_dwh, p_dwh, f"{where} S={S}")
            zero_below("lstm_seq_bwd_ckpt_bf16", k_dz, burn, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd_bf16: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused_bf16: two launches differ {at}")
        if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S))):
            fail(f"lstm_seq_bwd_ckpt_bf16: two launches differ {at}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
        t_ms = {
            "lstm_seq_bwd_bf16": median_ms(lambda: K.lstm_seq_bwd(*walk, mixed), 5, flush),
            "lstm_bwd_bf16": median_ms(lambda: K.lstm_bwd(*walk), 5, flush),
            "lstm_seq_bwd_fused_bf16": median_ms(lambda: K.lstm_seq_bwd_fused(*walk, mixed), 5,
                                                 flush),
            "lstm_seq_bwd_ckpt_bf16": median_ms(lambda: K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S),
                                                5, flush),
        }
        say("chunks", f"{at}: lstm_seq_bwd_bf16, lstm_bwd_bf16, lstm_seq_bwd_fused_bf16 and "
            f"lstm_seq_bwd_ckpt_bf16 (S={S}) within atol {BF16_ATOL} + rtol {BF16_RTOL} (dWh "
            f"within {BF16_DWH_TOL} x max|dWh|), seams 0 and mixed; two launches of each give "
            f"identical bits; lstm_seq_bwd_fused_bf16's dz equals lstm_seq_bwd_bf16's rounded to "
            f"bf16; on {card}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t_ms.items())
            + " (median of 5, seam mixed)")

    def check_bf16(T, B, H, seed):
        """The bf16 forms of all five kernels against their plain versions,
        the walks on the plain forward's residuals; two launches, one
        result; K4-bf16's dz against K2-bf16's."""
        at = f"at T={T} B={B} H={H} bf16"
        for kernel in K.SOURCES:
            say("check", f"{at}: {kernel}_bf16 column split "
                f"{K._geometry(B, H, kernel, dev, torch.bfloat16)}")
        proj, wh, h0, c0, (p_outs, p_cs), walk, ckpt, mixed = bf16_operands(T, B, H, seed)
        outs, cs = K.lstm_fwd(proj, wh, h0, c0)
        if outs.dtype != torch.bfloat16 or cs.dtype != torch.float32:
            fail(f"lstm_fwd_bf16 {at}: outs {outs.dtype}, cs {cs.dtype}")
        hold_bf16("lstm_fwd_bf16", outs, p_outs, at)
        hold_bf16("lstm_fwd_bf16", cs, p_cs, at)
        if not all(map(torch.equal, (outs, cs), K.lstm_fwd(proj, wh, h0, c0))):
            fail(f"lstm_fwd_bf16: two launches differ {at}")
        # the seamless backward: dz, dh0 and dc0, all f32
        got = K.lstm_bwd(*walk)
        for a, b in zip(got, K.lstm_bwd_plain(*walk)):
            hold_bf16("lstm_bwd_bf16", a, b, at)
        if not all(map(torch.equal, got, K.lstm_bwd(*walk))):
            fail(f"lstm_bwd_bf16: two launches differ {at}")
        one_split(B, H, at)
        seams = (("0", torch.zeros_like(mixed)), ("mid", torch.full_like(mixed, T // 2)),
                 ("T-1", torch.full_like(mixed, T - 1)), ("mixed", mixed))
        for label, burn in seams:
            where = f"{at} seam {label}"
            dz = K.lstm_seq_bwd(*walk, burn)
            hold_bf16("lstm_seq_bwd_bf16", dz, K.lstm_seq_bwd_plain(*walk, burn), where)
            zero_below("lstm_seq_bwd_bf16", dz, burn, where)
            f_dz, f_dwh = K.lstm_seq_bwd_fused(*walk, burn)
            p_dz, p_dwh = K.lstm_seq_bwd_fused_plain(*walk, burn)
            hold_bf16("lstm_seq_bwd_fused_bf16", f_dz, p_dz, where)
            hold_dwh_bf16("lstm_seq_bwd_fused_bf16", f_dwh, p_dwh, where)
            zero_below("lstm_seq_bwd_fused_bf16", f_dz, burn, where)
            hold_fused_dz(f_dz, dz, where)
        if not torch.equal(dz, K.lstm_seq_bwd(*walk, mixed)):
            fail(f"lstm_seq_bwd_bf16: two launches differ {at}")
        if not all(map(torch.equal, (f_dz, f_dwh), K.lstm_seq_bwd_fused(*walk, mixed))):
            fail(f"lstm_seq_bwd_fused_bf16: two launches differ {at}")
        for S in (5, T):
            for label, burn in seams:
                where = f"{at} S={S} seam {label}"
                k_dz, k_dwh = K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S)
                p_dz, p_dwh = K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)
                hold_bf16("lstm_seq_bwd_ckpt_bf16", k_dz, p_dz, where)
                hold_dwh_bf16("lstm_seq_bwd_ckpt_bf16", k_dwh, p_dwh, where)
                zero_below("lstm_seq_bwd_ckpt_bf16", k_dz, burn, where)
            if not all(map(torch.equal, (k_dz, k_dwh), K.lstm_seq_bwd_ckpt(*ckpt(S), mixed, S))):
                fail(f"lstm_seq_bwd_ckpt_bf16: two launches differ {at} S={S}")
        torch.cuda.synchronize()
        say("check", f"{at}: lstm_fwd_bf16, lstm_bwd_bf16, lstm_seq_bwd_bf16 and "
            f"lstm_seq_bwd_fused_bf16 (seams 0, mid, T-1, mixed) and lstm_seq_bwd_ckpt_bf16 (S=5 "
            f"and {T}) within atol {BF16_ATOL} + rtol {BF16_RTOL}, dWh within {BF16_DWH_TOL} x "
            f"max|dWh|; two launches of each give identical bits; lstm_seq_bwd_fused_bf16's dz "
            f"equals lstm_seq_bwd_bf16's rounded to bf16, every seam")

    def time_bf16(T, B, H, D, burn, kept, carried, flush, label, forms=None):
        """The bf16 forms at (T, B, H) with the main path's seams (only
        `forms` where given: a path's launched forms), each held against its
        plain version on the operands it is timed on, and one bf16 LSTM
        layer of input width D through the port and through cuDNN: {name:
        (ms, plain ms, bound ms, bound by, library ms or None, max |kernel -
        plain|)}."""
        proj, wh, h0, c0, _, walk, ckpt, _ = bf16_operands(T, B, H, 40)
        S = 5
        reps = 15 if H <= 512 else 5
        runs = {
            "lstm_fwd_bf16": (lambda: K.lstm_fwd(proj, wh, h0, c0),
                              lambda: K.lstm_fwd_plain(proj, wh, h0, c0)),
            "lstm_seq_bwd_bf16": (lambda: K.lstm_seq_bwd(*walk, burn),
                                  lambda: K.lstm_seq_bwd_plain(*walk, burn)),
            "lstm_bwd_bf16": (lambda: K.lstm_bwd(*walk), lambda: K.lstm_bwd_plain(*walk)),
            "lstm_seq_bwd_fused_bf16": (lambda: K.lstm_seq_bwd_fused(*walk, burn),
                                        lambda: K.lstm_seq_bwd_fused_plain(*walk, burn)),
            "lstm_seq_bwd_ckpt_bf16": (lambda: K.lstm_seq_bwd_ckpt(*ckpt(S), burn, S),
                                       lambda: K.lstm_seq_bwd_ckpt_plain(*ckpt(S), burn, S)),
        }
        if forms is not None:
            runs = {name: run for name, run in runs.items() if name in forms}
        mm = 2 * H * 4 * H
        bh, bh4, f4, b2 = B * H, B * 4 * H, 4, 2
        # the matmul FLOPs and the bytes each function must move: bf16
        # proj, wh and h rows (and K4's and K5's dz), f32 c rows,
        # cotangents, K2's and K3's dz and dWh
        walk_in = b2 * (T * bh4 + T * bh + H * 4 * H) + f4 * (3 * T * bh + bh)
        work = {
            "lstm_fwd_bf16": (mm * T * B, b2 * (T * bh4 + H * 4 * H + 2 * bh + T * bh)
                              + f4 * T * bh),
            "lstm_seq_bwd_bf16": (mm * (kept + carried), walk_in + f4 * (B + T * bh4)),
            # no seam: both products on every (row, step); dz, dh0, dc0 out
            "lstm_bwd_bf16": (mm * 2 * T * B, walk_in + f4 * (T * bh4 + 2 * bh)),
            # plus dWh on every kept (row, step); bf16 dz and f32 dWh out
            "lstm_seq_bwd_fused_bf16": (mm * (2 * kept + carried),
                                        walk_in + f4 * (B + H * 4 * H) + b2 * T * bh4),
            "lstm_seq_bwd_ckpt_bf16": (mm * (T * B + 2 * kept + carried),
                                       b2 * (T * bh4 + (T // S) * bh + H * 4 * H + T * bh4)
                                       + f4 * (T * bh + (T // S) * bh + bh + B + H * 4 * H)),
        }
        # one LSTM layer, input projection included, as in phase 8: the
        # port's forward (a bf16 matmul, then lstm_fwd_bf16), and cuDNN's
        # LSTM forward and backward in bf16 where torch takes them, the
        # yardsticks of K1's and K3's bf16 forms
        lib = {}
        x16 = torch.randn(T, B, D, device=dev).to(torch.bfloat16)
        wi16 = (torch.randn(D, 4 * H, device=dev) * D ** -0.5).to(torch.bfloat16)
        layer_ms = median_ms(
            lambda: K.lstm_fwd((x16.reshape(T * B, D) @ wi16).reshape(T, B, 4 * H), wh, h0, c0),
            reps, flush)
        try:
            lstm16 = torch.nn.LSTM(D, H).to(dev, torch.bfloat16)
            with torch.no_grad():
                lib["lstm_fwd_bf16"] = median_ms(lambda: lstm16(x16, (h0[None], c0[None])),
                                                 reps, flush)
            if "lstm_bwd_bf16" in runs:
                xg = x16.clone().requires_grad_(True)
                h0g, c0g = (v[None].clone().requires_grad_(True) for v in (h0, c0))
                y, (hT, cT) = lstm16(xg, (h0g, c0g))
                leaves = [xg, h0g, c0g, *lstm16.parameters()]
                grads = tuple(v.to(torch.bfloat16)
                              for v in (walk[0], walk[6][None], walk[6][None]))
                lib["lstm_bwd_bf16"] = median_ms(
                    lambda: torch.autograd.grad((y, hT, cT), leaves, grads, retain_graph=True),
                    reps, flush)
        except Exception as e:  # a yardstick only: the port never calls it
            say("time", f"{label}: cuDNN LSTM in bf16 not taken by torch: {e!r}"[:300])
        say("time", f"one bf16 LSTM layer at {label}, input projection included, T={T} B={B} "
            f"D={D} H={H}: forward through the port (matmul + lstm_fwd_bf16) {layer_ms:.3f} ms; "
            f"torch.nn.LSTM (cuDNN, bf16) " + (
                f"forward {lib['lstm_fwd_bf16']:.3f} ms" if "lstm_fwd_bf16" in lib
                else "not taken") + (
                f", backward (dx, dWi, dWh, db, dh0, dc0) {lib['lstm_bwd_bf16']:.3f} ms"
                if "lstm_bwd_bf16" in lib else ""))

        def held(name, got, want):
            """max |got - want| over a form's outputs; fails past the bf16
            tolerances (dWh, K4's and K5's second output: BF16_DWH_TOL x
            max |dWh|)."""
            got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
            worst = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                diff = (a.float() - b.float()).abs()
                e = float(diff.max())
                worst = max(worst, e)
                if i == 1 and name in ("lstm_seq_bwd_fused_bf16", "lstm_seq_bwd_ckpt_bf16"):
                    ok = e <= BF16_DWH_TOL * float(b.float().abs().max())
                else:
                    ok = bool((diff <= BF16_ATOL + BF16_RTOL * b.float().abs()).all())
                if not ok:
                    fail(f"{name} disagrees with its plain version at {label} (T={T} B={B} "
                         f"H={H}), output {i}: {e:.3e}")
            return worst

        out = {}
        for name, (fn, plain) in runs.items():
            err = held(name, fn(), plain())
            t_ms = median_ms(fn, reps, flush)
            p_ms = median_ms(plain, 3, flush)
            flops, nbytes = work[name]
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_tc, t_fma = flops / PEAK_BF16_FLOPS * 1e3, flops / PEAK_FP32_FLOPS * 1e3
            b_ms, b_by = (t_tc, "operations") if t_tc >= t_bytes else (t_bytes, "bytes")
            fma_ms = max(t_fma, t_bytes)
            out[name] = (t_ms, p_ms, b_ms, b_by, lib.get(name), err)
            lib_s = f"{lib[name]:.3f} ms" if name in lib else "none"
            say("time", f"{name} at {label} (T={T} B={B} H={H}, "
                f"{K._geometry(B, H, K._SOURCE[name], dev, torch.bfloat16)}): {t_ms:.3f} ms "
                f"(plain {p_ms:.3f} ms); bound {b_ms:.4f} ms by {b_by} at the bf16 tensor "
                f"cores' {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s ({b_ms / t_ms:.1%}), {fma_ms:.4f} ms "
                f"at the fp32 FMA peak ({fma_ms / t_ms:.1%}); {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; cuDNN LSTM bf16 {lib_s}; max |kernel - plain| "
                f"{err:.3e}; on {card}")
        if "lstm_seq_bwd_fused_bf16" in out:
            # the bf16 default arm's backward, two calls: a yardstick for
            # K4's bf16 form, not one call for its function
            pair_ms = median_ms(lambda: K._outer_dwh(walk[2], K.lstm_seq_bwd(*walk, burn), wh),
                                reps, flush)
            say("time", f"bf16 default arm's pair at {label} (lstm_seq_bwd_bf16 + hprev^T @ dz "
                f"matmul) {pair_ms:.3f} ms beside lstm_seq_bwd_fused_bf16 "
                f"{out['lstm_seq_bwd_fused_bf16'][0]:.3f} ms")
        return out

    # 4. the main path -------------------------------------------------------
    cfg = PRESETS["atari"]().replace(**ON_CATCH)
    t = time.perf_counter()
    tr, launches, m, ms, peak = drive(cfg, UPDATES, dev)
    cfg = tr.cfg
    say("train", f"atari preset on catch: obs {cfg.obs_shape} {cfg.encoder}, hidden "
        f"{cfg.hidden_dim}, T={cfg.seq_len} ({cfg.burn_in_steps}/{cfg.learning_steps}/"
        f"{cfg.forward_steps}), batch {cfg.batch_size}, {cfg.num_actors} envs, "
        f"{cfg.resolved_compute_dtype}, arm {tr.backward_arm[0]}; cut: buffer_capacity "
        f"{cfg.buffer_capacity} (atari 2000000), learning_starts {cfg.learning_starts} "
        f"(atari 50000); warmup and {UPDATES} updates in {time.perf_counter() - t:.1f}s")
    say("train", f"{m['step']} updates: loss {m['loss']:.6f}, grad_norm "
        f"{m['grad_norm']:.4f}, q_mean {m['q_mean']:.4f}; ms/update first {ms[0]:.1f}, "
        f"median of the rest {statistics.median(ms[1:]):.2f} (host clock, ends in the "
        f"priorities' device->host copy); update peak device memory {peak:.3f} GiB")
    say("train", f"launches during the main path: {launches}")
    if launches != {"lstm_fwd": 2 * UPDATES, "lstm_seq_bwd": UPDATES}:
        fail(f"expected {2 * UPDATES} forward and {UPDATES} backward launches, got {launches}")
    path_launches = {"lstm_fwd": launches["lstm_fwd"], "lstm_seq_bwd": launches["lstm_seq_bwd"]}

    # 5. one update on the card against the plain versions on the CPU -------
    sampled = agree(tr, "default arm")

    # 6. the other backward arms ------------------------------------------
    for label, knobs, arm, kernel in (
        ("fused_dwh", {"backward_arm": "fused_dwh"}, ("fused_dwh", 0), "lstm_seq_bwd_fused"),
        ("ckpt", {"backward_arm": "ckpt"}, ("ckpt", 5), "lstm_seq_bwd_ckpt"),
        ("fused_sequence=False", {"fused_sequence": False}, ("default", 0), "lstm_bwd"),
    ):
        t = time.perf_counter()
        a_tr, a_launches, a_m, a_ms, a_peak = drive(cfg.replace(**knobs), ARM_UPDATES, dev)
        if a_tr.backward_arm != arm:
            fail(f"{label}: resolved to {a_tr.backward_arm}, expected {arm}")
        say("arms", f"{label}: arm {a_tr.backward_arm}, {ARM_UPDATES} updates, loss "
            f"{a_m['loss']:.6f}; ms/update first {a_ms[0]:.1f}, median of the rest "
            f"{statistics.median(a_ms[1:]):.2f}; update peak device memory {a_peak:.3f} GiB; "
            f"launches {a_launches} "
            f"({time.perf_counter() - t:.1f}s with warmup)")
        if a_launches != {"lstm_fwd": 2 * ARM_UPDATES, kernel: ARM_UPDATES}:
            fail(f"{label}: expected {2 * ARM_UPDATES} lstm_fwd and {ARM_UPDATES} {kernel} "
                 f"launches, got {a_launches}")
        path_launches[kernel] = a_launches[kernel]
        agree(a_tr, label)
        del a_tr

    # 7. the xl model preset, backward arm resolved by the budget ----------
    xl_cfg = apply_model_preset(PRESETS["atari"](), "xl").replace(**ON_CATCH)
    t = time.perf_counter()
    x_tr, x_launches, x_m, x_ms, x_peak = drive(xl_cfg, XL_UPDATES, dev)
    say("xl", f"model preset xl: hidden {x_tr.cfg.hidden_dim}, backward_arm "
        f"{x_tr.cfg.backward_arm!r} budget {x_tr.cfg.backward_residual_budget_mb} MiB -> "
        f"{x_tr.backward_arm}; {XL_UPDATES} updates, loss {x_m['loss']:.6f}; ms/update "
        f"{', '.join(f'{v:.1f}' for v in x_ms)} (host clock) on {card}; update peak "
        f"device memory {x_peak:.3f} GiB; launches "
        f"{x_launches} ({time.perf_counter() - t:.1f}s with warmup)")
    if x_tr.backward_arm != ("ckpt", 85):
        fail(f"xl resolved to {x_tr.backward_arm}, expected ('ckpt', 85)")
    if x_launches != {"lstm_fwd": 2 * XL_UPDATES, "lstm_seq_bwd_ckpt": XL_UPDATES}:
        fail(f"xl: expected {2 * XL_UPDATES} lstm_fwd and {XL_UPDATES} lstm_seq_bwd_ckpt "
             f"launches, got {x_launches}")
    agree(x_tr, "xl")
    del x_tr

    # 8. timings at the main path's shapes ----------------------------------
    T, B, H = cfg.seq_len, cfg.batch_size, cfg.hidden_dim
    D = tr.state.net.core.wi.shape[0]
    burn = torch.from_numpy(sampled.burn_in_steps).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(T, B, D, device=dev, generator=g)
    wi = tr.state.net.core.wi.detach()
    bias = tr.state.net.core.b.detach()
    wh = tr.state.net.core.wh.detach()
    proj = (x.reshape(T * B, D) @ wi + bias).reshape(T, B, 4 * H)
    h0 = torch.randn(B, H, device=dev, generator=g) * 0.3
    c0 = torch.randn(B, H, device=dev, generator=g) * 0.3
    outs, cs = K.lstm_fwd(proj, wh, h0, c0)
    hprev = torch.cat([h0[None], outs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dout = torch.randn(T, B, H, device=dev, generator=g)
    dcT = torch.randn(B, H, device=dev, generator=g)
    walk = (dout, proj, hprev, cprev, cs, wh, dcT)
    S = 5
    ckpt_args = (dout, proj, torch.cat([h0[None], outs[S - 1 : T - 1 : S]]),
                 torch.cat([c0[None], cs[S - 1 : T - 1 : S]]), wh, dcT, burn, S)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    flush = scratch.zero_

    times = {}
    for name, fn, plain in (
        ("lstm_fwd", lambda: K.lstm_fwd(proj, wh, h0, c0),
         lambda: K.lstm_fwd_plain(proj, wh, h0, c0)),
        ("lstm_seq_bwd", lambda: K.lstm_seq_bwd(*walk, burn),
         lambda: K.lstm_seq_bwd_plain(*walk, burn)),
        ("lstm_bwd", lambda: K.lstm_bwd(*walk), lambda: K.lstm_bwd_plain(*walk)),
        ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walk, burn),
         lambda: K.lstm_seq_bwd_fused_plain(*walk, burn)),
        ("lstm_seq_bwd_ckpt", lambda: K.lstm_seq_bwd_ckpt(*ckpt_args),
         lambda: K.lstm_seq_bwd_ckpt_plain(*ckpt_args)),
    ):
        times[name] = (median_ms(fn, flush=flush), median_ms(plain, flush=flush))

    # library calls: cuDNN's LSTM forward on the same layer, and its backward
    # (which also computes dx, dWi and the bias gradient)
    cudnn = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        cudnn_ms = median_ms(lambda: cudnn(x, (h0[None], c0[None])), flush=flush)
        layer_ms = median_ms(
            lambda: K.lstm_fwd((x.reshape(T * B, D) @ wi + bias).reshape(T, B, 4 * H), wh, h0, c0),
            flush=flush)
    xg = x.clone().requires_grad_(True)
    h0g, c0g = h0[None].clone().requires_grad_(True), c0[None].clone().requires_grad_(True)
    y, (hT, cT) = cudnn(xg, (h0g, c0g))
    leaves = [xg, h0g, c0g, *cudnn.parameters()]
    cudnn_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y, hT, cT), leaves, (dout, dcT[None], dcT[None]),
                                    retain_graph=True),
        flush=flush)
    say("time", f"one LSTM layer forward, input projection included, T={T} B={B} D={D} H={H}: "
        f"port (matmul + lstm_fwd) {layer_ms:.3f} ms, torch.nn.LSTM (cuDNN) {cudnn_ms:.3f} ms; "
        f"cuDNN's backward of the same layer (dx, dWi, dWh, db, dh0, dc0) {cudnn_bwd_ms:.3f} ms")

    # bounds: the bytes each function must move (inputs read once, outputs
    # written once) and its matmul FLOPs; the gate math adds under 1%
    f32 = 4
    # the seam backward needs the gate recompute for steps t >= burn[b] and
    # the carry product for steps t > burn[b]; below the seam dz is zero
    kept = int((T - burn.long()).sum())
    carried = int((T - 1 - burn.long()).clamp(min=0).sum())

    def works(h, s):
        """{kernel: (FLOPs, bytes)} at hidden size h, K5 at stride s."""
        mm = 2 * h * 4 * h  # one (row, step) through an h x 4h product
        walk_bytes = f32 * (4 * T * B * h + T * B * 4 * h + h * 4 * h + B * h)
        return {
            "lstm_fwd": (mm * T * B,
                         f32 * (T * B * 4 * h + h * 4 * h + 2 * B * h + 2 * T * B * h)),
            "lstm_seq_bwd": (mm * (kept + carried), walk_bytes + f32 * (B + T * B * 4 * h)),
            # no seam: the recompute and the carry on every (row, step), and
            # the outputs dz, dh0, dc0
            "lstm_bwd": (mm * 2 * T * B, walk_bytes + f32 * (T * B * 4 * h + 2 * B * h)),
            # plus dWh on every kept (row, step), and dWh written once
            "lstm_seq_bwd_fused": (mm * (2 * kept + carried),
                                   walk_bytes + f32 * (B + T * B * 4 * h + h * 4 * h)),
            # plus the forward recompute of every (row, step); reads T/s
            # checkpoints instead of the h, c sequences
            "lstm_seq_bwd_ckpt": (mm * (T * B + 2 * kept + carried),
                                  f32 * (T * B * h + T * B * 4 * h + 2 * (T // s) * B * h
                                         + h * 4 * h + B * h + B + T * B * 4 * h + h * 4 * h)),
        }

    work = works(H, S)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    sources = {"lstm_fwd": 68, "lstm_seq_bwd": 287, "lstm_bwd": 125,
               "lstm_seq_bwd_fused": 451, "lstm_seq_bwd_ckpt": 615}
    library = {"lstm_fwd": cudnn_ms, "lstm_bwd": cudnn_bwd_ms}
    kernels = []
    for name in K.SOURCES:
        t_ms, p_ms = times[name]
        flops, nbytes = work[name]
        b_ms, b_by = bound(flops, nbytes)
        say("time", f"{name}: {t_ms:.3f} ms (plain {p_ms:.3f} ms), bound {b_ms:.4f} ms by "
            f"{b_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
            f"{flops / t_ms / 1e6:.1f} GFLOP/s = {b_ms / t_ms:.1%} of the bound; "
            f"launches on its path {path_launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": f"r2d2_tpu_torch/csrc/{name}.cu",
            "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[name]}",
            "launches": path_launches[name], "max_abs_err": errs[name], "ms": t_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library.get(name), "unit": unit(name),
        })
    # the default arm's backward, two calls: the seam walk, then dWh as one
    # matmul outside it; a yardstick for K4, not one call for its function
    pair_ms = median_ms(lambda: K._outer_dwh(hprev, K.lstm_seq_bwd(*walk, burn), wh), flush=flush)
    say("time", f"default arm's pair (lstm_seq_bwd + hprev^T @ dz matmul) {pair_ms:.3f} ms beside "
        f"lstm_seq_bwd_fused {times['lstm_seq_bwd_fused'][0]:.3f} ms; lstm_seq_bwd alone "
        f"{times['lstm_seq_bwd'][0]:.3f} ms, so K4's dWh pass takes about "
        f"{times['lstm_seq_bwd_fused'][0] - times['lstm_seq_bwd'][0]:.3f} ms")
    say("time", f"seams of the sampled batch: {sorted(set(sampled.burn_in_steps.tolist()))}, "
        f"backward steps kept {kept} of {T * B}; ckpt at S={S}")
    # the column split's floor: one grid barrier per step and nothing else
    bar_ms = median_ms(lambda: K.grid_barriers(T, B, H, dev))
    say("time", f"{T} grid barriers alone at lstm_fwd's geometry {K._geometry(B, H, 'lstm_fwd', dev)}: "
        f"{bar_ms:.3f} ms, {bar_ms / T * 1e3:.2f} us per barrier; lstm_fwd "
        f"{times['lstm_fwd'][0]:.3f} ms, lstm_seq_bwd {times['lstm_seq_bwd'][0]:.3f} ms")
    # the exchange alone, in K2's geometry (both forms): its T - 1 steps of
    # one grid barrier and the carry product's exchange into the stage
    # ring, no product, through cp.async (the walks' before the ring) and
    # through the bulk ring (every walk's); a step of K2 is then a barrier,
    # an exchange and the products with the rest
    for dt, k2_ms in ((torch.float32, times["lstm_seq_bwd"][0]), (torch.bfloat16, None)):
        geo = K._geometry(B, H, "lstm_seq_bwd", dev, dt)
        ex = {bulk: median_ms(lambda: K.exchange_alone(T, B, H, dev, dt, bulk))
              for bulk in (False, True)}
        per_bar, steps = bar_ms / T, T - 1
        split = {b: (ex[b] - steps * per_bar) / steps * 1e3 for b in ex}
        line = (f"exchange alone, {K._form('lstm_seq_bwd', dt)}'s geometry {geo}: {steps} steps "
                f"of barrier + exchange, no product: cp.async {ex[False]:.3f} ms, bulk ring "
                f"{ex[True]:.3f} ms; a step's exchange {split[False]:.2f} "
                f"us through cp.async, {split[True]:.2f} us through the ring, a barrier "
                f"{per_bar * 1e3:.2f} us")
        if k2_ms is not None:
            line += (f"; of lstm_seq_bwd's {k2_ms / T * 1e3:.2f} us a step the products and the "
                     f"rest take {(k2_ms / T - per_bar) * 1e3 - split[True]:.2f} us")
        say("time", line)

    # the forward and the four backwards at the xl width, where auto takes
    # the checkpointed arm
    Hx, Sx = 2048, 85
    gx = torch.Generator(device=dev).manual_seed(8)
    projx = torch.randn(T, B, 4 * Hx, device=dev, generator=gx)
    whx = (torch.rand(Hx, 4 * Hx, device=dev, generator=gx) * 2 - 1) * Hx ** -0.5
    hx = torch.randn(1, B, Hx, device=dev, generator=gx) * 0.3
    cx = torch.randn(1, B, Hx, device=dev, generator=gx) * 0.3
    outsx, csx = K.lstm_fwd(projx, whx, hx[0], cx[0])
    walkx = (torch.randn(T, B, Hx, device=dev, generator=gx), projx,
             torch.cat([hx, outsx[:-1]]), torch.cat([cx, csx[:-1]]), csx, whx,
             torch.randn(B, Hx, device=dev, generator=gx))
    work_x = works(Hx, Sx)
    for name, fn, reps in (
        ("lstm_fwd", lambda: K.lstm_fwd(projx, whx, hx[0], cx[0]), 15),
        ("lstm_seq_bwd", lambda: K.lstm_seq_bwd(*walkx, burn), 15),
        ("lstm_bwd", lambda: K.lstm_bwd(*walkx), 15),
        ("lstm_seq_bwd_fused", lambda: K.lstm_seq_bwd_fused(*walkx, burn), 15),
        ("lstm_seq_bwd_ckpt",
         lambda: K.lstm_seq_bwd_ckpt(walkx[0], projx, hx, cx, whx, walkx[6], burn, Sx), 5),
    ):
        t_ms = median_ms(fn, reps=reps, flush=flush)
        b_ms, b_by = bound(*work_x[name])
        stride = f" S={Sx}" if name == "lstm_seq_bwd_ckpt" else ""
        say("time", f"{name} at xl (T={T} B={B} H={Hx}{stride}, "
            f"{K._geometry(B, Hx, name, dev)}): {t_ms:.3f} ms (median of {reps}), bound "
            f"{b_ms:.4f} ms by {b_by} ({work_x[name][0] / 1e9:.2f} GFLOP) = {b_ms / t_ms:.1%} "
            f"of the bound")
    pair_x = median_ms(lambda: K._outer_dwh(walkx[2], K.lstm_seq_bwd(*walkx, burn), whx),
                       flush=flush)
    say("time", f"default arm's pair at xl (lstm_seq_bwd + hprev^T @ dz matmul): "
        f"{pair_x:.3f} ms (median of 15)")
    # cuDNN's fp32 LSTM at xl under the port's fp32 numerics (TF32 off): the
    # yardsticks of fp32 K1 and K3 there
    Dx = D - H + Hx
    xx = torch.randn(T, B, Dx, device=dev, generator=gx)
    cudnn_x = torch.nn.LSTM(Dx, Hx).to(dev)
    with torch.no_grad():
        cudnn_x_ms = median_ms(lambda: cudnn_x(xx, (hx, cx)), reps=5, flush=flush)
    xg = xx.clone().requires_grad_(True)
    hxg, cxg = hx.clone().requires_grad_(True), cx.clone().requires_grad_(True)
    y, (hT, cT) = cudnn_x(xg, (hxg, cxg))
    leaves = [xg, hxg, cxg, *cudnn_x.parameters()]
    cudnn_x_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y, hT, cT), leaves, (walkx[0], walkx[6][None],
                                                          walkx[6][None]), retain_graph=True),
        reps=5, flush=flush)
    say("time", f"torch.nn.LSTM (cuDNN, fp32, TF32 "
        f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}) at xl, T={T} B={B} D={Dx} "
        f"H={Hx}: forward {cudnn_x_ms:.3f} ms, backward (dx, dWi, dWh, db, dh0, dc0) "
        f"{cudnn_x_bwd_ms:.3f} ms (median of 5)")
    del cudnn_x, y, hT, cT, leaves

    # K1's step, both forms, at the atari widths and at xl (wh streamed): a
    # barrier, the gate product's exchange of h (the exchange alone in K1's
    # geometry, through cp.async and through the bulk ring; at xl also
    # without the gate columns, so that their copy shows) and the products
    # with the rest
    per_bar = bar_ms / T
    for dt in (torch.float32, torch.bfloat16):
        for Hs, k1_args in ((H, (proj, wh, h0, c0)), (Hx, (projx, whx, hx[0], cx[0]))):
            k1_args = tuple(a.to(dt) for a in k1_args)
            k1_ms = median_ms(lambda: K.lstm_fwd(*k1_args), reps=5, flush=flush)
            geo = K._geometry(B, Hs, "lstm_fwd", dev, dt)
            step = {}
            for bulk in (False, True):
                for cols in ((True,) if geo.pinned else (True, False)):
                    ex_ms = median_ms(lambda: K.exchange_alone(T, B, Hs, dev, dt, bulk,
                                                               source="lstm_fwd", cols=cols),
                                      reps=5)
                    step[bulk, cols] = (ex_ms - (T - 1) * per_bar) / (T - 1) * 1e3
            k1_step = k1_ms / T * 1e3
            line = (f"{K._form('lstm_fwd', dt)}'s step at H={Hs} ({geo}): {k1_ms:.3f} ms, "
                    f"{k1_step:.2f} us a step: a barrier {per_bar * 1e3:.2f} us, the exchange "
                    f"of h {step[True, True]:.2f} us through the bulk ring "
                    f"({step[False, True]:.2f} through cp.async)")
            if not geo.pinned:
                line += (f", of which h alone {step[True, False]:.2f} ({step[False, False]:.2f}),"
                         f" so the streamed gate columns {step[True, True] - step[True, False]:.2f}"
                         f" ({step[False, True] - step[False, False]:.2f})")
            line += (f"; the products and the rest "
                     f"{k1_step - per_bar * 1e3 - step[True, True]:.2f} us")
            say("time", line)

    # K4's step, both forms, at the atari widths and at xl (wh streamed): a
    # barrier, the exchange of dz (the exchange alone on the bulk ring in
    # K4's geometry), the dWh pass (a launch's passes alone, no walk:
    # lstm_kernel.dwh_pass_alone) and the products with the rest; and K4
    # beside K2 and the default arm's pair (K2 + the hprev^T @ dz matmul),
    # in the same call: what the pass, run before the window step's grid
    # barrier, costs the step
    for dt in (torch.float32, torch.bfloat16):
        for Hs, wk in ((H, walk), (Hx, walkx)):
            wk = tuple(a.to(dt) if i in (1, 2, 5) else a for i, a in enumerate(wk))
            k4_ms = median_ms(lambda: K.lstm_seq_bwd_fused(*wk, burn), reps=5, flush=flush)
            k2_ms = median_ms(lambda: K.lstm_seq_bwd(*wk, burn), reps=5, flush=flush)
            pair = median_ms(lambda: K._outer_dwh(wk[2], K.lstm_seq_bwd(*wk, burn), wk[5]),
                             reps=5, flush=flush)
            geo = K._geometry(B, Hs, "lstm_seq_bwd_fused", dev, dt)
            ex_ms = median_ms(lambda: K.exchange_alone(T, B, Hs, dev, dt, True, geo=geo), reps=5)
            pass_ms = median_ms(lambda: K.dwh_pass_alone(wk[2], dt), reps=5, flush=flush)
            ex, pass_us = (ex_ms - (T - 1) * per_bar) / (T - 1) * 1e3, pass_ms / T * 1e3
            k4_step = k4_ms / T * 1e3
            say("time", f"{K._form('lstm_seq_bwd_fused', dt)}'s step at H={Hs} ({geo}): "
                f"{k4_ms:.3f} ms, {k4_step:.2f} us a step: a barrier {per_bar * 1e3:.2f} us, the "
                f"exchange of dz {ex:.2f} us (bulk ring), the dWh pass {pass_us:.2f} us alone "
                f"({pass_ms:.3f} ms a launch), the products and the rest "
                f"{k4_step - per_bar * 1e3 - ex - pass_us:.2f} us; beside "
                f"{K._form('lstm_seq_bwd', dt)} {k2_ms:.3f} ms the pass costs the step "
                f"{(k4_ms - k2_ms) / T * 1e3:.2f} us; the default arm's pair {pair:.3f} ms")

    for _ in range(120):  # about a second of queued forward launches
        K.lstm_fwd(proj, wh, h0, c0)
    loaded = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    say("time", f"SM clock under a queue of lstm_fwd launches, max: {loaded}")

    # 9. the batch in row chunks --------------------------------------------
    agree_release()  # phases 9 and 10 time single launches only
    for i, shape in enumerate(CHUNKED):
        check_chunks(*shape, seed=20 + i)
        check_chunks_bf16(*shape, seed=25 + i)

    # 10. the bf16 forms against their plain versions -----------------------
    for i, shape in enumerate(((T, B, H), (T, B, 2048), (T, WIDE_BATCH, WIDE_H))):
        check_bf16(*shape, seed=30 + i)
    say("check", "max |kernel - plain| (dz, dh0/dc0 and dWh alike), every check: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))

    # 11. the atari preset in its own bf16 -----------------------------------
    agree_drain()
    b_cfg = PRESETS["atari"]().replace(**ON_CATCH_BF16)
    t = time.perf_counter()
    b_tr, b_launches, b_m, b_ms, b_peak = drive(b_cfg, UPDATES, dev)
    say("bf16", f"atari preset as shipped: compute {b_tr.cfg.resolved_compute_dtype}, state "
        f"{b_tr.cfg.state_dtype}, arm {b_tr.backward_arm}; {UPDATES} updates, loss "
        f"{b_m['loss']:.6f}, grad_norm {b_m['grad_norm']:.4f}; ms/update first {b_ms[0]:.1f}, "
        f"median of the rest {statistics.median(b_ms[1:]):.2f} (fp32 main path "
        f"{statistics.median(ms[1:]):.2f}); update peak device memory {b_peak:.3f} GiB "
        f"(fp32 {peak:.3f}); launches {b_launches} ({time.perf_counter() - t:.1f}s with warmup)")
    if b_tr.cfg.resolved_compute_dtype != "bfloat16" or b_tr.backward_arm != ("default", 0):
        fail(f"the atari preset resolved to {b_tr.cfg.resolved_compute_dtype}, "
             f"{b_tr.backward_arm}; expected bfloat16, ('default', 0)")
    if b_launches != {"lstm_fwd_bf16": 2 * UPDATES, "lstm_seq_bwd_bf16": UPDATES}:
        fail(f"bf16: expected {2 * UPDATES} lstm_fwd_bf16 and {UPDATES} lstm_seq_bwd_bf16 "
             f"launches, got {b_launches}")
    path_launches.update(b_launches)

    bx_cfg = apply_model_preset(PRESETS["atari"](), "xl").replace(**ON_CATCH_BF16)
    t = time.perf_counter()
    bx_tr, bx_launches, bx_m, bx_ms, bx_peak = drive(bx_cfg, XL_UPDATES, dev)
    say("bf16", f"xl in bf16: hidden {bx_tr.cfg.hidden_dim}, backward_arm "
        f"{bx_tr.cfg.backward_arm!r} budget {bx_tr.cfg.backward_residual_budget_mb} MiB -> "
        f"{bx_tr.backward_arm}; {XL_UPDATES} updates, loss {bx_m['loss']:.6f}; ms/update "
        f"{', '.join(f'{v:.1f}' for v in bx_ms)} (host clock) on {card}; update peak device "
        f"memory {bx_peak:.3f} GiB; launches {bx_launches} "
        f"({time.perf_counter() - t:.1f}s with warmup)")
    if bx_tr.backward_arm != ("ckpt", 5):
        fail(f"xl in bf16 resolved to {bx_tr.backward_arm}, expected ('ckpt', 5)")
    if bx_launches != {"lstm_fwd_bf16": 2 * XL_UPDATES, "lstm_seq_bwd_ckpt_bf16": XL_UPDATES}:
        fail(f"bf16 xl: expected {2 * XL_UPDATES} lstm_fwd_bf16 and {XL_UPDATES} "
             f"lstm_seq_bwd_ckpt_bf16 launches, got {bx_launches}")
    path_launches["lstm_seq_bwd_ckpt_bf16"] = bx_launches["lstm_seq_bwd_ckpt_bf16"]

    p_cfg = b_cfg.replace(precision="bf16")
    t = time.perf_counter()
    p_tr, p_launches, p_m, p_ms, p_peak = drive(p_cfg, PRECISION_UPDATES, dev)
    store = p_tr.replay.hidden_store
    say("bf16", f"precision=bf16 (carries stored in {p_tr.cfg.state_dtype}, host store "
        f"{store.dtype}): {PRECISION_UPDATES} updates, loss {p_m['loss']:.6f}; ms/update first "
        f"{p_ms[0]:.1f}, median of the rest {statistics.median(p_ms[1:]):.2f}; update peak "
        f"device memory {p_peak:.3f} GiB; launches {p_launches} "
        f"({time.perf_counter() - t:.1f}s with warmup)")
    if store.dtype.name != "uint16" or p_launches != {
            "lstm_fwd_bf16": 2 * PRECISION_UPDATES, "lstm_seq_bwd_bf16": PRECISION_UPDATES}:
        fail(f"precision=bf16: store {store.dtype}, launches {p_launches}")
    del p_tr

    # the paths of K4-bf16 and K3-bf16: the wide model at batch 96, where
    # auto resolves to the fused arm, beside the same model's default arm;
    # the fused arm and the seamless backward at the atari widths; one
    # update of the wide model with no seam
    wide_cfg = apply_model_preset(PRESETS["atari"](), "wide").replace(
        batch_size=WIDE_BATCH, **ON_CATCH_BF16)
    bf16_paths = {}
    for label, path_cfg, n, arm, kernel in (
        ("wide B=96 auto", wide_cfg, ARM_UPDATES, ("fused_dwh", 0), "lstm_seq_bwd_fused_bf16"),
        ("wide B=96 default", wide_cfg.replace(backward_arm="default"), 2, ("default", 0),
         "lstm_seq_bwd_bf16"),
        ("fused_dwh", b_cfg.replace(backward_arm="fused_dwh"), ARM_UPDATES, ("fused_dwh", 0),
         "lstm_seq_bwd_fused_bf16"),
        ("fused_sequence=False", b_cfg.replace(fused_sequence=False), ARM_UPDATES, ("default", 0),
         "lstm_bwd_bf16"),
        ("wide B=96 fused_sequence=False", wide_cfg.replace(fused_sequence=False), 1,
         ("default", 0), "lstm_bwd_bf16"),
        ("ckpt", b_cfg.replace(backward_arm="ckpt"), ARM_UPDATES, ("ckpt", 5),
         "lstm_seq_bwd_ckpt_bf16"),
    ):
        t = time.perf_counter()
        a_tr, a_launches, a_m, a_ms, a_peak = drive(path_cfg, n, dev)
        say("bf16", f"{label}: hidden {a_tr.cfg.hidden_dim}, batch {a_tr.cfg.batch_size}, "
            f"compute {a_tr.cfg.resolved_compute_dtype}, arm {a_tr.backward_arm}; {n} updates, "
            f"loss {a_m['loss']:.6f}; ms/update {', '.join(f'{v:.2f}' for v in a_ms)} (host "
            f"clock) on {card}; update peak device memory {a_peak:.3f} GiB; launches "
            f"{a_launches} ({time.perf_counter() - t:.1f}s with warmup)")
        if a_tr.cfg.resolved_compute_dtype != "bfloat16" or a_tr.backward_arm != arm:
            fail(f"{label}: resolved to {a_tr.cfg.resolved_compute_dtype}, {a_tr.backward_arm}; "
                 f"expected bfloat16, {arm}")
        if a_launches != {"lstm_fwd_bf16": 2 * n, kernel: n}:
            fail(f"{label}: expected {2 * n} lstm_fwd_bf16 and {n} {kernel} launches, got "
                 f"{a_launches}")
        path_launches.setdefault(kernel, a_launches[kernel])
        bf16_paths[label] = (a_tr, a_peak)

    def core_peak(a_tr, arm):
        """Peak device memory (GiB) above the start of one forward and
        backward of a trainer's LSTM core alone under `arm`, on a batch of
        its width with every row's seam at the burn-in: the residuals the
        arm choice budgets, without the rest of the update."""
        c = a_tr.cfg
        core = copy.deepcopy(a_tr.state.net.core)
        core.backward_arm = arm
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn(c.batch_size, c.seq_len, core.wi.shape[0], device=dev, generator=g)
        x.requires_grad_(True)
        carry = (torch.zeros(c.batch_size, c.hidden_dim, device=dev),) * 2
        burn = torch.full((c.batch_size,), c.burn_in_steps, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        outs, _ = core(x, carry, burn)
        outs.float().sum().backward()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2**30

    w_tr = bf16_paths["wide B=96 auto"][0]
    say("bf16", f"wide B=96 update peak device memory: fused_dwh arm "
        f"{bf16_paths['wide B=96 auto'][1]:.3f} GiB, default arm "
        f"{bf16_paths['wide B=96 default'][1]:.3f} GiB; the LSTM core alone (forward and "
        f"backward, seams at {w_tr.cfg.burn_in_steps}): fused_dwh "
        f"{core_peak(w_tr, ('fused_dwh', 0)):.3f} GiB, default "
        f"{core_peak(w_tr, ('default', 0)):.3f} GiB")
    n_tr = bf16_paths["fused_sequence=False"][0]
    c_tr = bf16_paths["ckpt"][0]
    del bf16_paths

    # 12. bf16 against the CPU, and against fp32 on the card -----------------
    def rebuilt(a_tr, dtype):
        """(cfg, net, target) of a trainer's parameters in compute dtype
        `dtype`, on the card."""
        c = a_tr.cfg.replace(compute_dtype=dtype)
        nets = []
        for src in (a_tr.state.net, a_tr.state.target_net):
            n = R2D2Network.from_config(c, device=dev)
            n.load_state_dict(src.state_dict())
            nets.append(n)
        return c, *nets

    def vs_fp32(a_tr, label):
        """One bf16 update against the fp32 update on the card from the same
        parameters and batch, in tests/test_precision.py's class."""
        s = a_tr.replay.sample_batch(a_tr.sample_rng)
        c16, *nets16 = rebuilt(a_tr, "bfloat16")
        c32, *nets32 = rebuilt(a_tr, "float32")
        r16 = one_update(*nets16, c16, s, "cuda")
        r32 = one_update(*nets32, c32, s, "cuda")
        l32, l16 = float(r32[0]), float(r16[0])
        p_diff = float((r16[1] - r32[1]).abs().max())
        say("agree", f"{label}: bf16 vs fp32 on the card, same parameters and batch: loss "
            f"{l16:.6f} vs {l32:.6f} (limit 5% of max(|fp32|, 1)), priorities max |diff| "
            f"{p_diff:.3e} (rtol 0.2 atol 0.05), grad_norm {float(r16[2]):.4f} vs "
            f"{float(r32[2]):.4f}")
        if abs(l16 - l32) > 0.05 * max(abs(l32), 1.0) or not torch.allclose(
                r16[1], r32[1], rtol=0.2, atol=0.05):
            fail(f"{label}: the bf16 update leaves the fp32 update's drift class")

    b_sampled = agree(b_tr, "bf16 main path", **BF16_AGREE)
    vs_fp32(tr, "main path")
    w_sampled = agree(w_tr, "bf16 wide B=96 fused_dwh", **BF16_AGREE)
    vs_fp32(w_tr, "wide B=96 fused_dwh")
    agree(n_tr, "bf16 fused_sequence=False", **BF16_AGREE)
    vs_fp32(n_tr, "fused_sequence=False")
    del n_tr
    # K5's bf16 form, on the tensor cores, on both its paths
    agree(c_tr, "bf16 ckpt", **BF16_AGREE)
    vs_fp32(c_tr, "ckpt")
    del c_tr
    agree(bx_tr, "bf16 xl (ckpt, 5)", **BF16_AGREE)
    vs_fp32(bx_tr, "xl")
    if not args.profile:
        del bx_tr

    # 13. the bf16 forms' times and bounds -----------------------------------
    burn16 = torch.from_numpy(b_sampled.burn_in_steps).to(dev)
    kept16 = int((T - burn16.long()).sum())
    carried16 = int((T - 1 - burn16.long()).clamp(min=0).sum())
    burn_w = torch.from_numpy(w_sampled.burn_in_steps).to(dev)
    kept_w = int((T - burn_w.long()).sum())
    carried_w = int((T - 1 - burn_w.long()).clamp(min=0).sum())
    for Bh, Hh, seams, label in ((B, H, (burn16, kept16, carried16), "atari"),
                                 (WIDE_BATCH, WIDE_H, (burn_w, kept_w, carried_w), "wide B=96"),
                                 (B, 2048, (burn16, kept16, carried16), "xl")):
        rows = time_bf16(T, Bh, Hh, D - H + Hh, *seams, flush, label)
        if label == "atari":
            for name, (t_ms, p_ms, b_ms, b_by, lib_ms, _) in rows.items():
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
                    "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
                    "launches": path_launches[name], "max_abs_err": errs[name], "ms": t_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "unit": unit(name),
                })

    # 14. the main path end to end: checkpoints, metrics, resume, evaluation
    agree_release()
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        e2e("bf16", b_cfg, "threaded", dev, tmp)
        e2e("fp32", cfg, "inline", dev, tmp)
        envpool_row(b_cfg, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 15. threaded against inline on both main paths --------------------------
    agree_drain()
    for label, m_cfg in (("bf16", b_cfg), ("fp32", cfg)):
        modes(label, m_cfg, dev, args.profile)

    # 16. a hidden size off the kernels' row, padded on the card ---------------
    for label, o_extra, tol in (("fp32", ON_CATCH, {}), ("bf16", ON_CATCH_BF16, BF16_AGREE)):
        o_cfg = PRESETS["atari"]().replace(hidden_dim=ODD_HIDDEN, **o_extra)
        o_tr, o_launches, o_m, o_ms, _ = drive(o_cfg, 1, dev)
        sfx = "_bf16" if label == "bf16" else ""
        padded = o_tr.state.net.core.padded_units(dev)
        say("odd", f"{label} hidden {ODD_HIDDEN}: the kernels run at {padded} units (zero "
            f"units padded in the model); 1 update, loss {o_m['loss']:.6f}, {o_ms[0]:.1f} ms; "
            f"launches {o_launches}")
        if o_launches != {f"lstm_fwd{sfx}": 2, f"lstm_seq_bwd{sfx}": 1} or padded == ODD_HIDDEN:
            fail(f"hidden {ODD_HIDDEN} {label}: launches {o_launches}, {padded} units")
        agree(o_tr, f"{label} hidden {ODD_HIDDEN}", **tol)
        del o_tr

    # 17. the native replay core against the numpy gathers ------------------
    agree_drain()
    native_phase(tr)

    # 18. the long_context preset at full width -------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        long_context_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 19. preemption: the cut, the snapshot and the bitwise resume -----------
    agree_release()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        preempt_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 20. the tiered plane at the paper's replay capacity ----------------------
    agree_drain()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        tiered_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 21. the device planes at the paper's replay capacity ---------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        device_rows = device_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 22. collection fused on the card (--mode fused) ---------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fused_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 23. the procgen_impala path (procmaze -> IMPALA -> LSTM) ------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        procgen_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 24. the multi-task plane: one learner over four task fleets -------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        multitask_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 25. serving: the session cache, the micro-batcher, the PolicyServer ------
    agree_drain()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serve_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 26. the fleet and the live loop: serve -> replay -> learn -> reload ------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        live = fleet_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    burn_l = torch.from_numpy(live["burn"]).to(dev)
    rows_l = time_bf16(T, B, H, D, burn_l, int((T - burn_l.long()).sum()),
                       int((T - 1 - burn_l.long()).clamp(min=0).sum()), flush, "liveloop",
                       forms=set(live["launches"]))
    for name, n in live["launches"].items():
        t_ms, p_ms, b_ms, b_by, lib_ms, err = rows_l[name]
        kernels.append({
            "name": name, "path": "liveloop", "route": "cuda",
            "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
            "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
            "launches": n, "max_abs_err": err, "ms": t_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "unit": unit(name),
        })

    # 27. the pod loop: serve hosts and a learner as processes on the card ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pod = pod_phase(tmp, live["row"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    burn_p = torch.from_numpy(pod["burn"]).to(dev)
    rows_p = time_bf16(T, B, H, D, burn_p, int((T - burn_p.long()).sum()),
                       int((T - 1 - burn_p.long()).clamp(min=0).sum()), flush, "podloop",
                       forms=set(pod["launches"]))
    for name, n in pod["launches"].items():
        t_ms, p_ms, b_ms, b_by, lib_ms, err = rows_p[name]
        kernels.append({
            "name": name, "path": "podloop", "route": "cuda",
            "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
            "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
            "launches": n, "max_abs_err": err, "ms": t_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "unit": unit(name),
        })

    # 28. data parallelism: the sharded plane and two ranks over gloo --------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        dpr = dp_phase(dev, tmp, device_rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for path, burn_d, counts in (
            ("sharded", dpr["burn"][0], dpr["launches"]),
            ("multihost", torch.cat(dpr["burn"][:2]), dpr["rank_launches"])):
        rows_d = time_bf16(T, len(burn_d), H, D, burn_d, int((T - burn_d.long()).sum()),
                           int((T - 1 - burn_d.long()).clamp(min=0).sum()), flush, path,
                           forms=set(counts))
        for name, n in counts.items():
            t_ms, p_ms, b_ms, b_by, lib_ms, err = rows_d[name]
            kernels.append({
                "name": name, "path": path, "route": "cuda",
                "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
                "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
                "launches": n, "max_abs_err": err, "ms": t_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "unit": unit(name),
                "batch": len(burn_d),
            })

    # 29. M13b: the reshard, the sharded device planes, tp and fsdp -------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        el = elastic_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    timed = {}  # paths at the same shapes and seams share one timing
    for path, (burn_e, counts, h_e, d_e) in el.items():
        key = (h_e, d_e, tuple(burn_e.tolist()), tuple(sorted(counts)))
        if key not in timed:
            timed[key] = time_bf16(T, len(burn_e), h_e, d_e, burn_e,
                                   int((T - burn_e.long()).sum()),
                                   int((T - 1 - burn_e.long()).clamp(min=0).sum()), flush, path,
                                   forms=set(counts))
        rows_e = timed[key]
        for name, n in counts.items():
            t_ms, p_ms, b_ms, b_by, lib_ms, err = rows_e[name]
            kernels.append({
                "name": name, "path": path, "route": "cuda",
                "source": f"r2d2_tpu_torch/csrc/{K._SOURCE[name]}.cu",
                "replaces": f"r2d2_tpu/ops/pallas_lstm.py:{sources[K._SOURCE[name]]}",
                "launches": n, "max_abs_err": err, "ms": t_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "unit": unit(name),
                "batch": len(burn_e), "hidden": h_e,
            })

    # 30. the graph checks on the card ----------------------------------------
    agree_drain()
    graph_phase()

    if args.profile:
        profile_updates(tr, args.profile, "fp32 main path")
        profile_updates(b_tr, args.profile, "bf16 main path")
        profile_updates(w_tr, args.profile, "bf16 wide B=96 (fused_dwh)")
        profile_updates(bx_tr, args.profile, "bf16 xl (ckpt, 5)")

    say("done", f"every phase passed; wall {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
