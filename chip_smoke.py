#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):
  1. The card's name and power limit (nvidia-smi), then the build of the
     CUDA kernels from the sources in this checkout, timed, and `ptxas
     -v`'s registers and spills of every instantiation of the policy
     kernel, the gradient kernel, the rollout kernel, the connect and
     room-chain kernels and the Mosaic probe's kernels (a spill fails).
     Every phase prints its wall seconds, and the script its total.
  2. The main path at full size: Empty-8x8, `reset_batch(key(0), 2**21)`,
     `packed_init(..., "regen")`, one warm-up and three timed
     `step(generator, carry)` calls at T=256, `packed_finish`. Every
     kernel's launch counter is set to 0 just before: the rollout kernel
     must launch exactly 4 times, and the probe kernel once (its launch
     check runs when the main path first loads the library). Then
     `total_steps == B*T`; agents in bounds; `0 <= step_count <
     max_steps`. Then one kernel call and one plain-twin call on the same
     carry and generator seed must agree byte for byte (carry, rng chain
     and metrics), and the kernel alone and the twin alone are timed with
     CUDA events.
  3. Each kernel against its plain version on the card. The rollout
     kernel on random packed states (`minigrid_tpu_torch/testing.py`),
     T=64, B=8192: 8x8 and 9x7 with and without see-through walls, 16x16
     and 25x25 without. Words, registers, episodes and checksum must be
     byte-exact and per-lane reward sums bit-identical (tolerance 0). The
     probe kernel on a random (8, 128) int32 block against `x + 1`,
     exact; timed through its wrapper, and like with like against
     `torch.add(x, 1)`: raw launches against its calls (CUDA events), and
     the kernel's device time against its (`torch.profiler`). Phase 2 and
     every phase that times the rollout kernel print its launch plan
     (lanes a block, threads a lane, cell width, resident blocks and warps
     an SM from the card's occupancy) and the row's time under the
     kernel's previous design.
  4. The policy-in-the-loop main path at full width: Empty-8x8 regen,
     B=2**21, T=256, the `ActorCritic` (980 -> 256 -> 256, bf16 torso, f32
     heads) drawn from a seeded generator on the card,
     `build_policy_eval_rollout(..., as_carry=True)`, one warm-up and three
     timed `step(key, carry)` calls, `packed_finish`. With every count set
     to 0 just before, the policy kernel must launch exactly 4 times and no
     other kernel at all; then the same checks as phase 2, and the peak
     device memory.
  5. The policy kernel against its plain twin on the card, TF32 off.
     Under sparse dyadic weights (`testing.dyadic_flax_params`, every f32
     sum exact) the two must agree byte for byte, per-lane reward sums
     bit for bit (tolerance 0): one kernel launch on all 2**21 lanes of
     phase 4's warm carry at T=256 against the twin run over 32 column
     slices of 65,536 lanes with the matching columns of the same seeds
     (both timed, the twin as the sum of its slices), and on random
     packed states at 8x8 and 9x7 with and without see-through walls and
     at 16x16 and 25x25 (64-lane blocks), B=8192, T=64. Under phase 4's
     weights, after T=1, at most
     1e-4 of 65,536 lanes may differ (the f32 sums run in another order
     on the tensor cores and can flip a near-tie draw). The kernel alone
     is timed at the main path's shape and weights (mean of 3), beside the
     weight bytes its blocks read from L2 per lane-step as its design
     counts them, which must be at most half of what 64-lane blocks
     streaming W1 and W2 every step read.

  6. The fused train step at full width: Empty-8x8 regen, B=131,072
     (the largest batch the JAX package's records train at; its (T, 56, B)
     int32 trajectory spill takes 7.5 GB), T=256, `init_train_state` (the
     seeded `ActorCritic`) and `build_fused_train_step`, one warm-up and
     three timed `train_step(ts, carry, key)` calls. With every count set
     to 0 just before, the collecting policy kernel and the gradient kernel
     must each launch exactly 4 times and no other kernel at all; the loss
     must be finite, the params must have moved, and `env_steps == B*T`.
     It prints env-steps/s, the loss metrics and the peak device memory.
  7. The train path's kernels against their plain versions on the card,
     TF32 off. The collecting policy kernel under dyadic weights on all
     131,072 lanes of phase 6's warm carry at T=256, against the twin over
     two slices of 65,536 lanes: the trajectory and the carry byte for
     byte (tolerance 0). The gradient kernel on a full-size trajectory
     collected under phase 6's trained weights against `plain_grad_pass`:
     the rel-to-max error of each weight printed and held to its bound
     (f32 heads 1e-4, torso 1e-3, loss sums rtol 1e-4); two kernel
     launches bit for bit. Beside it, what the torso bound must catch: the
     share of dW1 and dW2 that one of G2's lane splits, or one of its time
     chunks, carries (the reading of a kernel that skipped it), each
     required to lie above the bound. Both kernels are timed at the main
     path's shape (mean of 3), the gradient kernel also split into G1 and
     G2 (`torch.profiler`), beside G2's yardstick: one cuBLAS bf16 GEMM of
     dW2's half over a time chunk's samples, times the chunks (timed only).

  8. KeyCorridor regen, the slice's main path: KeyCorridorS6R3 (16x16,
     occlusion, the pickup-target hook), `reset_batch(key(0), 32,768)`,
     `packed_init(..., "regen")`, one warm-up call, then at
     `regen_chunk` 128 and 32 a window of 5 timed `step(generator,
     carry)` calls at T=256 (1,280 steps: every lane truncates once, at
     step 1080), `packed_finish`. With every count set to 0 just before,
     the rollout and connect kernels must launch and no other kernel;
     each window prints env-steps/s, episodes, `reset_overlaps`, and per
     call the launches, host syncs and re-entry passes; then the peak
     device memory.
  9. The path's kernels against their plain versions on the card, byte
     for byte (reward sums bit for bit): (a) the whole chunked-regen step
     at chunk 128 from phase 8's carry whose next call holds the mass
     reset, through the kernels and through `build_packed_plain_rollout`
     (whose refresh generates with the plain connect loop); (b) the
     connect kernel on the generator's own plan for 32,768 lanes and on
     numpy-random inputs (max_itrs 5000 and 7), timed on the plan beside
     the kernel's previous design (`PREVIOUS_B4_MS`), with its launch
     plan (threads a lane, lanes a block, blocks), its bound from the draws
     the plain version counts, and the warp divergence (the mean over
     32-lane warps of the warp's most draws, over the mean); (c) the
     chunked-regen step at S3R1, S4R3 and S6R3 on planted pickup targets
     (`testing.plant_pickup_target`), `max_steps` as registered and cut
     to 5, chunks 4 and 8: `reset_overlaps` and successes must both occur;
     and the rollout kernel with the hook and the control rows alone, one
     128-step pass at phase 8's shape, timed.
 10. MultiRoom regen, this slice's main path: MultiRoom-N4-S5 (25x25,
     occlusion, the base step), `reset_batch(key(0), 32,768)`,
     `packed_init(..., "regen")`, T=288, `regen_chunk` 96. From
     `reset_batch` every lane truncates at steps 80, 160, 240, ..., so a
     call holds 3 or 4 mass resets and some chunks hold two (re-entry).
     (a) The random policy (`build_fused_rollout`) and (b) the seeded
     `ActorCritic` in the loop (`build_policy_eval_rollout`), each one
     warm-up and 3 timed `step` calls from the same carry. With every
     count set to 0 just before each window, (a) must launch only the
     rollout and room-chain kernels, (b) only the policy and room-chain
     kernels; each window prints env-steps/s, episodes, `reset_overlaps`,
     per call the launches, host syncs and re-entry passes, and the peak
     device memory; deferred resets must occur.
 11. The slice's kernels against their plain versions on the card, byte
     for byte (reward sums bit for bit): (a) the room-chain kernel on the
     generator's own retry keys and room counts for 32,768 lanes of N4-S5
     and N6 (the chain, its count, the attempts and the key rows), timed
     beside the kernel's previous design (`PREVIOUS_B5_MS`), with its
     launch plan (threads a lane, lanes a block, blocks), its bound from the
     attempts and rows the plain version counts, and the warp divergence
     (the mean over 32-lane warps of the warp's most attempts, over the
     mean); (b) the whole random-policy chunked-regen
     step from phase 10's carry whose call deferred resets, through the
     kernels and through `build_packed_plain_rollout`; (c) the same for
     policy evaluation under dyadic weights against
     `build_policy_eval_plain_rollout`, at the full 32,768 lanes; (d) the
     policy kernel at 25x25 on random packed states runs in phase 5; (e)
     both chunked-regen steps at N2-S4 with `max_steps` cut to 3, chunk 8,
     B=8192, T=16, where lanes end two episodes in a chunk; and the
     rollout kernel (hookless) and the policy kernel (BT=64) under the
     control rows alone, one 96-step pass at phase 10's shape, timed.

 12. The policy paths on random layouts, this slice's main path, at full
     width (the seeded `ActorCritic`), B=32,768, from `reset_batch(key(0))`
     and `packed_init(..., "regen")`, each one warm-up and timed calls with
     every count set to 0 just before them and a CUDA event at each piece
     the call marks: (a) KeyCorridorS6R3 policy evaluation
     (`build_policy_eval_rollout`, T=256, chunk 32, 4 timed calls: the
     window holds the every-lane truncation at step 1080) must launch only
     the policy kernel (with the pickup-target hook, under the control
     rows) and the connect kernel, and its `reset_overlaps` must equal the
     lanes the re-entry passes took; (b) the fused train step
     (`build_fused_train_step(..., regen_chunk=32)`) there, 4 timed steps,
     only the policy kernel (hook, collect, control rows), the gradient
     kernel and the connect kernel; (c) the fused train step on
     MultiRoom-N4-S5, T=288, chunk 96, 3 timed steps, only the policy
     kernel (collect, control rows, 64-lane blocks), the gradient kernel
     and the room-chain kernel, with deferred resets and re-entry passes.
     The loss must be finite, the params must move, `env_steps == B*T`.
     Each prints env-steps/s, the pieces' ms, host syncs, re-entry passes
     and the peak device memory.
 13. The slice's kernels against their plain versions, TF32 off, dyadic
     weights, byte for byte (reward sums bit for bit): (a) each new
     instantiation of the policy kernel (the hook at 8x8 and 16x16, in
     eval and collect mode, with and without random commit rows; collect
     under the commit rows at 25x25 without a hook) on random packed
     states, B=8192, T=64, the spill on each lane's committed rows; (b)
     the whole chunked-regen train rollout, merged trajectory included,
     from phase 12's carries (KeyCorridorS6R3 through the mass reset,
     MultiRoom-N4-S5 with re-entry) on all 32,768 lanes against
     `build_fused_train_plain_rollout`; (c) MultiRoom-N2-S4 with
     `max_steps` 3 and KeyCorridorS3R1 on planted pickup targets with
     `max_steps` 5, chunk 8, policy evaluation and the train rollout, with
     deferred resets; (d) KeyCorridorS3R1 and S6R3 on planted targets in
     cached mode, both surfaces; then the new instantiations alone at the
     main path's shapes, timed.
 14. The Mosaic probe (`minigrid_tpu_torch/tools/probe_mosaic.py`): each
     of the 9 variants' kernel against `plain_probe`, bit for bit under
     dyadic inputs and within 1e-2 of the largest |acc| under the probe's
     normal draws, two runs bit for bit, the variants of one formula bit
     for bit, the others within their bound of base_where, timed with
     CUDA events through the wrapper and as device time (`torch.profiler`:
     the forward and product kernels, and the whole call), beside its
     time under the previous design.
 15. DoorKey-8x8 on random layouts, which have no packed generator:
     chunked regen refreshes the templates through the batched `generate`,
     packed. From `reset_batch(key(0))`, one warm-up and 3 timed calls with
     every count set to 0 just before them (the second holds the
     every-lane truncation at step 640): (a) the random policy, regen
     B=262,144, T=256, chunk 32, only the rollout kernel, the refresh's
     share of a call printed; (b) the fused train step at B=32,768, T=256,
     chunk 32, only the policy kernel (`<64, collect, ctl, no hook>`) and
     the gradient kernel; the loss finite, the params moved, `env_steps ==
     B*T`. Then against the plain paths, TF32 off, dyadic weights, byte for
     byte at B=8,192: (c) the random policy, policy evaluation and the
     collecting rollout (merged trajectory) from the carries whose call
     holds the reset; (d) the same with `max_steps` cut to 5, chunk 8,
     with deferred resets; (e) Empty-Random-6x6 regen; then the new
     instantiation alone, one 32-step pass at B=32,768, and the rollout
     kernel alone, one 32-step chunk pass at B=262,144 from (a)'s last
     carry, each timed and byte for byte.
 16. The five family hooks (Fetch, GoToDoor, GoToObject, PutNear,
     RedBlueDoors): (a) each family's regen main path at B=32,768, T=64,
     chunk 32: after a warm-up, one random-policy call and one
     policy-evaluation call with every count set to 0 just before each
     (only the rollout kernel, then only the policy kernel), then from that
     warm carry one 32-step pass of B1, B2 eval and B2 collect under fresh
     commit rows against their plain versions, B1 and B2 eval timed; (b)
     on `testing.hooked_packed_case` states (the hook's events planted in
     front of each agent), B=8,192, T=64: B1 with and without commit rows
     under actions whose first fires the hook, B2 in eval and collect mode
     with and without them (RedBlueDoors at 6x6 too, in 64-lane blocks),
     byte for byte, and each hook must change the plain outcome against
     the base step; (c) timed windows: Fetch-5x5-N2 cached random policy
     at B=262,144, T=256, then its kernel alone, one call's pass from the
     window's last carry (no commit rows) against its plain version, byte
     for byte (its own row in the kernels line), and RedBlueDoors-8x8
     regen policy evaluation at B=32,768, T=256 (the shape of (a)'s pass).
 17. The DynamicObstacles pre-hook (the obstacles' random walk), the
     Memory, Unlock and DynamicObstacles hooks and both action remaps,
     each timed window's kernels held against their plain versions at the
     window's own shape, byte for byte (reward sums bit for bit), TF32 off:
     (a) DynamicObstacles-16x16 (8 obstacles) cached, the random policy
     (actions 0-6, so the remap acts), B=262,144, T=256, one warm-up and 3
     timed calls with only the rollout kernel launched, then one 32-step
     pass of B1 from the window's last carry against `plain_rollout`; (b)
     DynamicObstacles-8x8 regen, B=32,768, T=256, chunk 32: policy
     evaluation (the seeded 3-action `ActorCritic`; only the policy
     kernel) and the fused train step (only the policy and gradient
     kernels; the loss finite, the params moved), each one warm-up and 3
     timed calls, then B2 eval and collect under fresh commit rows, one
     32-step pass each from the windows' carries against
     `plain_policy_rollout` under dyadic 3-action weights, and the gradient
     kernel at 3 actions on the train window's trajectory against
     `plain_grad_pass` within phase 7's bounds, two launches bit for bit;
     (c) MemoryS17Random regen policy evaluation, B=32,768, T=256, chunk
     32 (128-lane blocks), the same way; (d) the regen main path of
     Unlock, UnlockPickup, BlockedUnlockPickup, MemoryS7,
     DynamicObstacles-5x5 and -Random-6x6 at B=32,768, T=64, chunk 32: one
     warm-up and one timed random-policy call with only the rollout kernel
     launched, then one 32-step B1 pass under fresh commit rows against
     `plain_rollout`. Each window has its own row in the kernels line.
     The bound of a row that runs the pre-hook counts the walk: per
     lane-step n Threefry-20 evaluations and 9·(n + 3) coordinate tests
     per obstacle.

 18. LavaGap, FourRooms, Lava and Simple Crossing, LockedRoom and
     Playground (the base step with lava, locked doors and occlusion), each
     window's kernels held against their plain versions at its own shape,
     byte for byte (reward sums bit for bit), TF32 off: (a) each of the 14
     ids' regen main path under the random policy, B=32,768, T=64, chunk
     32: one warm-up and one timed call with only the rollout kernel
     launched, then one 32-step B1 pass under fresh commit rows against
     `plain_rollout`, with the id's launch plan; (b) policy evaluation
     (the seeded `ActorCritic`) at FourRooms and LockedRoom (19x19, 64-lane
     blocks) and LavaCrossingS9N1 (128-lane blocks), regen B=32,768, T=64:
     one warm-up and one timed call with only the policy kernel launched,
     then one 64-step B2 pass under fresh commit rows against
     `plain_policy_rollout` under dyadic weights, and the seeded weights
     after one step on at most 1e-4 of the lanes; (c) BASELINE.md's config
     5 at full width: LavaCrossingS9N1 + FourRooms, 32,768 lanes a member
     (65,536 in all), T=256 (`parallel/mixed.py`):
     `build_packed_mixed_rollout` cached and regen and
     `build_mixed_policy_eval` regen (the seeded `ActorCritic` a member),
     each one warm-up and 2 timed calls with every count set to 0 just
     before them (only the rollout kernel, or only the policy kernel),
     env-steps/s of each call, each member's share of it and the pieces
     its members mark (actions or seeds, kernel passes, refresh, re-entry,
     sums) and each member's own launches; then a 1,024-lane, T=32 slice
     of each surface's warm carries against its plain twin at the main
     path's chunk (dyadic weights for the policy), carries and integer
     metrics byte for byte, and B1 cached (a 256-step call), B1 regen and
     B2 regen (a 32-step pass) of each member alone at 32,768 lanes
     against their plain versions, each its own row in the kernels line
     with that member's launches; and the cached call's action stream
     drawn at each member's shape from a key (the JAX package's actions,
     `prng.randint_stream`) and from a `torch.Generator`.
 19. ObstructedMaze (keys in boxes, blocking balls, locked doors; the
     batched `generate` refreshes its templates) and the per-env engine,
     TF32 off: (a) each of the 8 ids' regen main path, B=32,768, T=32,
     chunk 16, the key-drawn random policy, every step count within 4·T
     of `max_steps` so about a quarter of the lanes reset in each call
     (in (b) and (c) too): one warm-up and one timed
     call with only the rollout kernel launched, the template refresh's
     share of it, 4,096 fresh lanes (as near the end) through the whole
     step against `build_packed_plain_rollout` (carries and metrics byte
     for byte), then one 16-step B1 pass of 32,768 fresh lanes under
     fresh commit rows against `plain_rollout` with the id's launch plan; (b) policy evaluation (the
     seeded `ActorCritic`) at 1Dlhb and Full, regen B=32,768, T=64: a
     window with only the policy kernel launched, one 64-step B2 pass
     with the pickup-target hook under fresh commit rows against
     `plain_policy_rollout` under dyadic weights, and the seeded weights
     after one step on at most 1e-4 of the lanes; (c) one fused train step
     at 2Dlhb, B=32,768, T=64, chunk 16 (B2 collecting, B3): a window with
     only those two kernels launched, the collecting pass byte for byte
     under dyadic weights and B3 against `plain_grad_pass` within phase
     7's bounds; (d) the per-env engine (`core/rollout.py::build_rollout`,
     plain PyTorch) against `build_fused_rollout` (B1) from the same
     `reset_batch` states (step counts within 128 of `max_steps`) and
     the same key, B=32,768, T=64: Empty-8x8 cached, DoorKey-8x8 regen and
     ObstructedMaze-1Dlhb regen; episodes, total_steps, obs_checksum and
     every final state field equal, total_reward to rtol 1e-5, only the
     rollout kernel launched on the fused side, both env-steps/s, then a
     B1 pass at the final carry against `plain_rollout`; (e)
     `build_mixed_rollout` on config 5's members (`MixedEnv`, alternating
     lanes, B=8,192, T=64, step counts within 64 of each member's
     `max_steps`) on the card against the same call on the CPU: states
     and integer metrics byte for byte, reward to rtol 1e-5; its rate.

 20. `parallel/` over two meshes, M1 (every visible card) and M2 (two
     shards of the card), TF32 off; every window prints env-steps/s at M1
     and M2 beside the unsharded call's, and each window's kernels are held
     against their plain versions at a stated shard-sized shape: (a)
     `build_sharded_rollout`, Empty-8x8 regen, carry surface, B=2**21,
     T=256 (phase 2's cell), and (b) `build_sharded_policy_eval`, Empty-8x8
     cached (phase 4's cell), each mesh's call byte for byte (the metrics'
     f32 sum bit for bit) against the per-shard replay of the one-device
     build function under `fold_in(key, i)`; B1 on 65,536 of a shard's lanes at
     T=256, B2 at T=64 under dyadic weights; (c) the fused train step over
     M2 against the unsharded step on the same carry and key at Empty-8x8
     regen, B=131,072, T=256 (phase 6's cell) and KeyCorridorS6R3 regen,
     B=32,768, T=256, chunk 32 (phase 12b's): the collecting rollout on
     each shard's columns of the whole batch's seed stream, carries and
     trajectory byte for byte; the shards' gradient-kernel sums within
     phase 7's bounds; two chained steps unsharded, over M1 and over M2
     (the carry after step 1 byte for byte, the params within 2·lr a step;
     every step count within 2·T of `max_steps`, so half the lanes reset);
     B2 collect, B3 and B4 on a shard's lanes against their plain versions;
     (d) `build_train_step` and `build_packed_train_step` (plain PyTorch,
     as the JAX package's are plain XLA), Empty-8x8 cached and DoorKey-8x8
     regen, B=32,768, T=64, dyadic weights: M2 against one shard on every
     integer, and the two steps' updates within 1e-6 of each other on
     Empty-8x8; (e) config 5 (LavaCrossingS9N1 + FourRooms, 32,768 lanes a
     member, T=256, chunk 32): the packed mixed rollout cached and regen
     and mixed policy evaluation over M1 and M2 against the per-member
     sharded replay (member i, shard j under `fold_in(fold_in(key, i),
     j)`), each member's kernel against its plain version at a shard's
     lanes, T=32; (f) in a process of its own, one NCCL process group of
     world size 1 (`parallel/distributed.py`): `make_global_batch` over two
     shards of the card, the sharded rollout and `psum_metrics` through
     `all_reduce`, equal to 20a's path from `reset_batch` at B=262,144
     (that process's first library load launches the probe kernel, as
     does the first use of each card of M1 but the first); (g)
     `parallel/dryrun.py::dryrun_multichip` over M1.
 21. The user-facing surfaces on the card (`compat/`, `wrappers/`,
     `render/`, `utils/ascii.py`, `utils/checkpoint.py`,
     `tools/profile.py`): (a) all 63 trajectory fixtures of
     `tests/golden/` through `Env.step` on the card, the start states from
     the port's `CompatEnv` and `state_to_device`, DynamicObstacles through
     `dynobst_step` (the host MT19937 walk): images and flags byte for
     byte, rewards to rtol 1e-6; (b) the three `wrappers_*` fixtures: full
     obs, one-hot, `render_state` at tile 8 without highlight,
     `render_obs_image`, and the flat vector of the adapter's path through
     `host_env.flat_obs`, byte for byte; (c) DoorKey-8x8, B=32,768: a regen
     carry through B1 (T=64, chunk 32, every count set to 0 just before:
     B1 must launch), `packed_finish`, then `full_obs`,
     `one_hot_partial_obs`, `rgb_img_partial_obs` and `rgb_img_obs` (tile
     8) and `render_state` with the highlight on the final states, each
     against the same function on a CPU copy on every lane, byte for byte,
     with its ms a call and frames/s, and B1 against its plain version at
     a 32-step pass; (d) `state_bonus` and `action_bonus` over those
     lanes, 16 steps, against the CPU: counts equal, rewards bit for bit;
     (e) the checkpoint round trip: the carry, a `TrainState` and M2's two
     shards of the carry, each restored byte for byte and the restored
     carry and shards taking one B1 call to the same carries as the
     originals, with the files' sizes; (f) one env through the adapter's
     per-step path (`compat/host_env.py::HostEnv`, whose `gymnasium`
     subclass this machine cannot load): reset, `Env.step` on a batch of
     one, `render_state` at tile 32, `render_ascii` and the hash, on the
     card and on the CPU, equal at every step, with the steps/s of each;
     (g) `tools/profile.py::trace` around one B1 call writes a Chrome
     trace whose events name the kernel.
 22. The root scripts of `minigrid_tpu_torch/tools/` on the card, through
     their `main`: (a) `benchmark` with 50 resets and 500 single-env
     steps through `HostEnv`, 100 renders and the batched `build_rollout`
     at its default B=8192, T=256 on the default device (its lines
     printed), then its batched rollout at B=256, T=32 on the card and on
     the CPU under the same keys: final states and integer metrics byte
     for byte, the reward sum to rtol 1e-6; (b) `run_tests` over all 70
     ids (25 random steps each, determinism, render, the functional
     wrappers, and the class wrappers' behaviours on `HostEnv`, since this
     machine has no gymnasium): it must print `all tests passed` and the
     line that says the class wrappers were skipped; (c) `manual_control`
     at its default id (MultiRoom-N6) with `ScriptedWindow` pressing every
     key once, then backspace and escape, with and without
     `--agent_view`: every frame and caption equal to the CPU's run, byte
     for byte. The per-env generators of KeyCorridor (in 22b) and
     MultiRoom (22b, 22c) launch the connect and room-chain kernels on one
     lane a call: every count is set to 0 just before each of 22a-22c and
     read just after, each call of the two kernels is caught at its
     wrapper, and (d) every caught call is replayed through the kernel and
     its plain version on the same inputs, byte for byte, both timed.

The kernels line gives each kernel's launches on its main path, its
largest difference from the plain version, its time and the plain
version's, its bound on this card (`bound_ms`: the larger of its bytes
over the memory rate and its operations over the peak rate for their
type, counted from this run's shapes) and, where one PyTorch call
computes the same function, that call's time (`library_ms`). The
capability probe's row gives device times (the kernel's and
`torch.add`'s), the rest times through the wrappers. The room-chain
kernel has a row at each of its phase 11a shapes: N4-S5's with its
launches on phase 10's path, N6's with 0 launches, since no batched path
that the script drives runs N6. The `*_one_env` rows are the connect and
room-chain kernels at the one-lane shapes of phase 22's path (N6's
included), with their launches there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ENV_ID = "MiniGrid-Empty-8x8-v0"
DEVICE = "cuda:0"
MAIN_B = 2_097_152
MAIN_T = 256
TIMED_CALLS = 3
CHECK_B = 8192
CHECK_T = 64
CHECK_CONFIGS = [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, False), (25, 25, False)]
KERNEL_SOURCE = "minigrid_tpu_torch/ops/csrc/rollout_kernel.cu"
KERNEL_REPLACES = "minigrid_tpu/ops/fused_rollout.py:519"
PROBE_REPLACES = "minigrid_tpu/utils/platform.py:48"
PROBE_REPS = 200
POLICY_SOURCE = "minigrid_tpu_torch/ops/csrc/policy_kernel.cu"
POLICY_HOOK_SOURCES = {
    "fetch": "minigrid_tpu_torch/ops/csrc/policy_hooks_fetch_goto.cu",
    "gotodoor": "minigrid_tpu_torch/ops/csrc/policy_hooks_fetch_goto.cu",
    "gotoobject": "minigrid_tpu_torch/ops/csrc/policy_hooks_fetch_goto.cu",
    "putnear": "minigrid_tpu_torch/ops/csrc/policy_hooks_putnear_rbd.cu",
    "redbluedoors": "minigrid_tpu_torch/ops/csrc/policy_hooks_putnear_rbd.cu",
    "memory": "minigrid_tpu_torch/ops/csrc/policy_hooks_memory_unlock.cu",
    "unlock": "minigrid_tpu_torch/ops/csrc/policy_hooks_memory_unlock.cu",
    "dynamicobstacles": "minigrid_tpu_torch/ops/csrc/policy_hooks_dynobst.cu",
}
POLICY_REPLACES = "minigrid_tpu/ops/policy_rollout.py:282"
POLICY_T = 256
SLICE_B = 65_536
POLICY_CHECK_CONFIGS = [(8, 8, True), (8, 8, False), (9, 7, True), (9, 7, False), (16, 16, False), (25, 25, False)]
FLAX_T1_MAX_SHARE = 1e-4
POLICY_TIMED_CALLS = 3
GRAD_SOURCE = "minigrid_tpu_torch/ops/csrc/grad_kernel.cu"
GRAD_REPLACES = "minigrid_tpu/ops/grad_kernel.py:81"
TRAIN_B = 131_072
TRAIN_T = 256
TRAIN_TIMED_CALLS = 3
TRAIN_SLICE_B = 65_536
# The gradient kernel against its plain version, rel-to-max per weight.
# Both sum the same bf16 products in f32, in other orders, so they differ
# by the order of the sums and by the rare one-ulp flip of a bf16 rounding
# of h1, h2, dh2 or dh1 that such a difference causes. The torso bound is
# set from the readings on an H100 (at most 6.6e-5, for wt2, at B=131,072
# T=256) with room to spare, and well below what one lane split or time
# chunk of G2 left out reads (printed and checked in phase 7).
GRAD_HEAD_TOL = 1e-4
GRAD_TORSO_TOL = 1e-3
GRAD_SUMS_RTOL = 1e-4
KC_ENV_ID = "MiniGrid-KeyCorridorS6R3-v0"
KC_B = 32_768
KC_T = 256
KC_CHUNKS = (128, 32)
# Episodes end by truncation, all lanes together at step 1080: 5 calls
# (1,280 steps) hold one mass reset of every lane.
KC_WINDOW = 5
KC_CHECK_IDS = ("MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-KeyCorridorS4R3-v0", "MiniGrid-KeyCorridorS6R3-v0")
KC_CHECK_B = 8192
KC_CHECK_T = 16
KC_CUT_MAX_STEPS = 5
KC_TIMED = 3
GEN_SOURCE = "minigrid_tpu_torch/ops/csrc/gen_kernel.cu"
GEN_REPLACES = "minigrid_tpu/ops/gen_kernel.py:70"
MR_REPLACES = "minigrid_tpu/ops/gen_kernel.py:224"
MR_ENV_ID = "MiniGrid-MultiRoom-N4-S5-v0"
MR_B = 32_768
# Every lane truncates together at steps 80, 160, 240, ...: a 288-step call
# holds 3 or 4 mass resets, and some 96-step chunks hold two (re-entry).
MR_T = 288
MR_CHUNK = 96
MR_TIMED = 3
MR_CHAIN_IDS = ("MiniGrid-MultiRoom-N4-S5-v0", "MiniGrid-MultiRoom-N6-v0")
MR_CUT_ID = "MiniGrid-MultiRoom-N2-S4-v0"
MR_CUT_MAX_STEPS = 3
MR_CUT_CHUNK = 8
MR_CUT_B = 8192
MR_CUT_T = 16
# Phases 12-13: the policy paths on random layouts at full width.
RT_B = 32_768
RT_KC_T = 256
RT_KC_CHUNK = 32
# From reset_batch, the warm-up call and 4 timed calls (1,280 steps) hold
# the every-lane truncation at step 1080.
RT_KC_TIMED = 4
RT_MR_T = 288
RT_MR_CHUNK = 96
RT_MR_TIMED = 3
RT_CHECK_CONFIGS = [(8, 8, True), (16, 16, True), (25, 25, False)]  # (width, height, pickup-target hook)
RT_TIMED_KERNEL = 3
PROBE_MOSAIC_SOURCE = "minigrid_tpu_torch/ops/csrc/probe_mosaic.cu"
PROBE_MOSAIC_REPLACES = "tools/probe_mosaic.py:61"
PROBE_MOSAIC_REPS = 20
# Phase 15: DoorKey-8x8 on random layouts (chunked regen through the
# batched generate). From reset_batch every lane truncates at step 640, so
# of a warm-up and 3 timed 256-step calls the second timed one holds that
# every-lane reset.
DK_ENV_ID = "MiniGrid-DoorKey-8x8-v0"
DK_B = 262_144
DK_T = 256
DK_CHUNK = 32
DK_TIMED = 3
DK_TRAIN_B = 32_768
DK_TRAIN_T = 256
DK_CHECK_B = 8192
DK_CUT_MAX_STEPS = 5
DK_CUT_T = 16
DK_CUT_CHUNK = 8
ER_ENV_ID = "MiniGrid-Empty-Random-6x6-v0"
# Phase 16: the five family hooks. Transition -> (an id of its family, the
# action that fires the hook on `testing.hooked_packed_case` states).
HOOK_FAMILIES = {
    "fetch": ("MiniGrid-Fetch-8x8-N3-v0", 3),
    "gotodoor": ("MiniGrid-GoToDoor-8x8-v0", 6),
    "gotoobject": ("MiniGrid-GoToObject-8x8-N2-v0", 6),
    "putnear": ("MiniGrid-PutNear-8x8-N3-v0", 4),
    "redbluedoors": ("MiniGrid-RedBlueDoors-8x8-v0", 5),
}
HK_B = 32_768
HK_T = 64
HK_CHUNK = 32
HK_TIMED = 3
FETCH_TIMED_ID = "MiniGrid-Fetch-5x5-N2-v0"
FETCH_TIMED_B = 262_144
FETCH_TIMED_T = 256
RBD_TIMED_ID = "MiniGrid-RedBlueDoors-8x8-v0"
RBD_TIMED_T = 256
# Phase 17: the pre-hook, the last three hooks and the remaps.
DO_CACHED_ID = "MiniGrid-Dynamic-Obstacles-16x16-v0"
DO_CACHED_B = 262_144
DO_CACHED_T = 256
DO_REGEN_ID = "MiniGrid-Dynamic-Obstacles-8x8-v0"
MEM_REGEN_ID = "MiniGrid-MemoryS17Random-v0"
NEW_B = 32_768
NEW_T = 256
NEW_CHUNK = 32
NEW_TIMED = 3
NEW_FAMILY_IDS = ("MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0", "MiniGrid-BlockedUnlockPickup-v0",
                  "MiniGrid-MemoryS7-v0", "MiniGrid-Dynamic-Obstacles-5x5-v0",
                  "MiniGrid-Dynamic-Obstacles-Random-6x6-v0")
NEW_FAMILY_T = 64
# Phase 18: LavaGap, FourRooms, the Crossings, LockedRoom and Playground,
# and BASELINE.md's config 5 (LavaCrossing + FourRooms, B = 65,536, T =
# 256; BASELINE.json configs[4]).
S12_IDS = tuple(f"MiniGrid-LavaGapS{s}-v0" for s in (5, 6, 7)) + ("MiniGrid-FourRooms-v0",) + tuple(
    f"MiniGrid-{o}CrossingS{n}-v0" for o in ("Lava", "Simple") for n in ("9N1", "9N2", "9N3", "11N5")) + (
    "MiniGrid-LockedRoom-v0", "MiniGrid-Playground-v0")
S12_B = 32_768
S12_T = 64
S12_CHUNK = 32
S12_POLICY_IDS = ("MiniGrid-FourRooms-v0", "MiniGrid-LockedRoom-v0", "MiniGrid-LavaCrossingS9N1-v0")
MIXED_IDS = ("MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-FourRooms-v0")
MIXED_B = 32_768  # a member: 65,536 lanes in all
MIXED_T = 256
MIXED_CHUNK = 32
MIXED_TIMED = 2
MIXED_CHECK_B = 1024
MIXED_CHECK_T = 32
# Phase 19: ObstructedMaze (B1, B2, B3 on its layouts) and the per-env
# engine held against B1 and run on the mixed batch.
OM_IDS = tuple(f"MiniGrid-ObstructedMaze-{n}-v0" for n in ("1Dl", "1Dlh", "1Dlhb", "2Dlh", "2Dlhb", "1Q", "2Q", "Full"))
OM_B = 32_768
OM_T = 32
OM_CHUNK = 16
OM_CHECK_B = 4096
OM_POLICY_IDS = ("MiniGrid-ObstructedMaze-1Dlhb-v0", "MiniGrid-ObstructedMaze-Full-v0")
OM_POLICY_T = 64
OM_TRAIN_ID = "MiniGrid-ObstructedMaze-2Dlhb-v0"
OM_TRAIN_T = 64
ENGINE_CELLS = (("MiniGrid-Empty-8x8-v0", "cached"), ("MiniGrid-DoorKey-8x8-v0", "regen"),
                ("MiniGrid-ObstructedMaze-1Dlhb-v0", "regen"))
ENGINE_B = 32_768
ENGINE_T = 64
ENGINE_MIXED_B = 8192
ENGINE_MIXED_T = 64
# Phase 21: the user-facing surfaces.
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
SURF_ENV_ID = "MiniGrid-DoorKey-8x8-v0"
SURF_B = 32_768
SURF_T = 64
SURF_CHUNK = 32
SURF_TILE = 8
SURF_REPS = 3
BONUS_T = 16
ADAPTER_ENV_ID = "MiniGrid-DoorKey-8x8-v0"
ADAPTER_STEPS = 48
# Phase 20: parallel/ over M1 (every visible card) and M2 (two shards of the card).
P20_B = MAIN_B  # 20a, 20b: phases 2's and 4's cells
P20_T = 256
P20_CHECK_B = 65_536  # the lanes of the kernels' checks against their plain versions in 20a-20b
P20_CHECK_T = 64  # 20b's check's steps
P20_TRAIN_CELLS = (("MiniGrid-Empty-8x8-v0", 131_072, 256, 32), ("MiniGrid-KeyCorridorS6R3-v0", 32_768, 256, 32))
P20_STEP_B = 32_768  # 20d
P20_STEP_T = 64
P20_STEP_CELLS = (("MiniGrid-Empty-8x8-v0", "cached"), ("MiniGrid-DoorKey-8x8-v0", "regen"))
P20_MIXED_B = 32_768  # 20e: a member
P20_DIST_B = 262_144  # 20f
P20_DIST_TIMEOUT = 300
# Adam's mu and nu after a step over a mesh against the reference step's,
# per flax layer, relative to the leaf's largest entry (`_p20_moment_gaps`):
# they hold the gradient each step used, after the sum over the shards and
# the clip. The fused step (20c) adds the shards' f32 kernel sums in
# another order, then rounds the torso's to bf16 once: an f32 difference
# that straddles a bf16 rounding moves an entry by one bf16 ulp, 2^-8 to
# 2^-7 of it, so up to 2^-7 in mu and 2^-6 in nu: the torso's bound is
# 2^-6. The heads stay f32, but the clip scales every leaf by the global
# norm, which those flips move (by 1.04e-5 at Empty-8x8 on an H100): 1e-4,
# phase 7's head bound. The autograd steps (20d) round every time chunk's
# torso cotangents to bf16 per shard; they are held to the bounds the CPU
# tests hold them to against the JAX package
# (tests/port/test_torch_parallel_train.py, AUTOGRAD_TOL). A wrong
# denominator or a shard's sum left out moves the moments by about half.
P20_FUSED_MOMENT_TOL = {"actor": GRAD_HEAD_TOL, "critic": GRAD_HEAD_TOL, "torso_0": 2**-6, "torso_1": 2**-6}
P20_AUTOGRAD_MOMENT_TOL = {"actor": 1e-3, "critic": 1e-3, "torso_0": 0.05, "torso_1": 0.05}
# Phase 22: the root scripts (`minigrid_tpu_torch/tools/`).
P22_RESETS = 50  # 22a: `benchmark.main`'s resets and single-env steps (the batch at its defaults)
P22_FRAMES = 500
P22_CHECK_B = 256  # 22a: the batched rollout held card against CPU (after 10 resets and 100 frames each)
P22_CHECK_T = 32
# 22b: `run_tests.main`'s random steps an id. At its default, 100, phase 22
# took 208 s and the script 1154.8 s of its 1200 on an H100 whose host ran
# slow (PERF.md §6), so the sweep runs a quarter of them.
P22_STEPS = 25
P22_KEYS = ("left", "right", "up", "pageup", "p", "pagedown", "d", " ", "enter", "backspace", "escape")  # 22c
P22_TIMED = 3  # 22d: replays of the caught kernel calls, timed

# Times under the previous design of the rollout kernel (one thread a lane,
# int32 grids) and of the Mosaic probe (the forward recomputed by every
# block), from PERF.md §6's kernel table (NVIDIA H100 80GB HBM3, 700 W):
# the rollout kernel's rows by (family, width, height, B, T), and the
# probe's base_where. Printed beside this run's.
PREVIOUS_B1_MS = {
    ("empty", 8, 8, 2_097_152, 256): 39.835052,
    ("keycorridor", 16, 16, 32_768, 128): 3.279093,
    ("multiroom", 25, 25, 32_768, 96): 4.695392,
    ("fetch", 8, 8, 32_768, 32): 0.249173,
    ("gotodoor", 8, 8, 32_768, 32): 0.231733,
    ("gotoobject", 8, 8, 32_768, 32): 0.206656,
    ("putnear", 8, 8, 32_768, 32): 0.257472,
    ("redbluedoors", 16, 8, 32_768, 32): 0.464939,
    ("doorkey", 8, 8, 262_144, 32): 1.664171,
    ("fetch", 5, 5, 262_144, 256): 5.397579,
    ("dynamicobstacles", 16, 16, 262_144, 32): 12.875488,
    ("unlock", 11, 6, 32_768, 32): 0.402933,
    ("unlockpickup", 11, 6, 32_768, 32): 0.412491,
    ("blockedunlockpickup", 11, 6, 32_768, 32): 0.400363,
    ("memory", 7, 7, 32_768, 32): 0.423296,
    ("dynamicobstacles", 5, 5, 32_768, 32): 0.427808,
    ("dynamicobstacles", 6, 6, 32_768, 32): 0.503264,
}
PREVIOUS_MOSAIC_BASE_WHERE_MS = 11.130352
# Times of the connect kernel (B4) on phase 9b's generator plan and of the
# room-chain kernel (B5) on phase 11a's inputs under their previous design
# (one thread a lane, the whole loop serial), from
# `tools/gen_kernel_sweep.py --parent` on a checkout of that design
# (NVIDIA H100 80GB HBM3, 700 W). Printed beside this run's.
PREVIOUS_B4_MS = 0.392054
PREVIOUS_B5_MS = {"MiniGrid-MultiRoom-N4-S5-v0": 0.563469, "MiniGrid-MultiRoom-N6-v0": 8.372461}

# The card's published peaks (H100 SXM data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# The fewest integer instructions a packed random-policy step needs per
# lane, derived from the function (not counted from the kernel): each view
# cell an address add, a bounds test, a load, three field extracts and
# three adds into the checksum; the transition (action load, forward-cell
# address and load, its field tests, position, direction and step-count
# updates, the done test, the reward, the write-back, the sums) about 30.
ROLLOUT_INSTR_PER_VIEW_CELL = 9
ROLLOUT_INSTR_PER_TRANSITION = 30
# With occlusion, per view row: its transparency bits (2 per cell), the
# 2(V-1) shift-and-or steps of the flood (3 each) and about 8 for its
# edges; the hook and the commit rows add about 10 to the transition.
ROLLOUT_INSTR_FLOOD_PER_CELL = 2
ROLLOUT_INSTR_FLOOD_PER_SHIFT = 3
ROLLOUT_INSTR_FLOOD_PER_ROW = 8
ROLLOUT_INSTR_HOOK_CTL = 10
# The DynamicObstacles walk, per obstacle and lane-step: one Threefry-2x32
# evaluation (20 rounds of add, rotate and xor, 5 key injections of 3, and
# 4 set-up operations) and 9·(n + 3) coordinate tests, one each (each of
# the 9 cells of the box against the bounds, the goal, the agent and the
# n obstacles).
ROLLOUT_INSTR_THREEFRY = 79
# The fewest integer operations one connect-loop draw needs, from the
# function: 21 Threefry-2x32 blocks (split(key, 5), then per randint a
# split and two bits), each 20 rounds of add, rotate and xor plus 5 key
# injections of 3 and 4 set-up operations (79); the four randint
# reductions (2 mods, a multiply, an add, a mod: 5 each); the R*C-step
# reachability flood (9 each); and about 30 for the door test and update.
CONNECT_OPS_PER_DRAW_BASE = 21 * 79 + 4 * 5 + 30
CONNECT_OPS_PER_FLOOD_STEP = 9
# The fewest integer operations of the room-chain loop, from the function:
# per key row 5 Threefry-2x32 blocks (the row's key, its split, two bits)
# and its randint reduction (6; the exit-position row reduces twice, counted
# once); per try about 40 (the exit and corner selects, the bounds and the
# overlap tests); per attempt the split (2 blocks) and about 20 to keep the
# best chain. Rows and tries are those the plain version counts.
MR_OPS_PER_ROW = 5 * 79 + 6
MR_OPS_PER_TRY = 40
MR_OPS_PER_ATTEMPT = 2 * 79 + 20


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


# Kernel names in `ptxas -v`'s log whose registers and spills phase 1
# reports: the policy kernel (B2), the gradient kernel (B3), the rollout
# kernel (B1), the connect kernel (B4), the room-chain kernel (B5) and the
# Mosaic probe's kernels.
REPORTED_KERNELS = ("policy_kernel", "grad_g", "rollout_generic", "rollout_cells16", "connect_kernel",
                    "mr_chain_kernel", "probe_forward_kernel", "probe_product")


def kernel_label(name: str) -> str:
    """A readable label of a mangled kernel name from `ptxas -v`."""
    import re

    for pattern, fmt in (
        (r"policy_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d+)E", "policy_kernel<BT={}, collect={}, ctl={}, hook={}>"),
        (r"rollout_cells16ILi(\d+)ELb(\d)ELi(\d+)ELi(\d+)E", "rollout_cells16<hook={}, ctl={}, threads={}, view={}>"),
        (r"rollout_genericILi(\d+)ELb(\d)E", "rollout_generic<hook={}, ctl={}>"),
        (r"probe_forward_kernelILi(\d+)E", "probe_forward_kernel<variant={}>"),
        (r"\d(connect_kernel|mr_chain_kernel)E", "{}"),
    ):
        m = re.search(pattern, name)
        if m:
            return fmt.format(*m.groups())
    return re.sub(r".*?((?:grad_g\d|probe_product_f32|probe_product)_kernel).*", r"\1", name)


def compiler_report(log: str) -> None:
    """`ptxas -v`'s registers and spills of every instantiation of the
    policy kernel (B2), the gradient kernel (B3), the rollout kernel (B1),
    the connect and room-chain kernels (B4, B5) and the Mosaic probe, one
    line each; any spill fails."""
    import re

    current, rows = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
        if current is None or not any(k in current for k in REPORTED_KERNELS):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows.setdefault(current, {})["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(current, {})["registers"] = int(m.group(1))
    spilled = []
    for name, row in sorted(rows.items()):
        label = kernel_label(name)
        spills = row.get("spills", (0, 0))
        print(f"phase 1: {label}: {row.get('registers')} registers, spill stores {spills[0]} B, "
              f"spill loads {spills[1]} B", flush=True)
        if any(spills):
            spilled.append(label)
    counts = {k: sum(k in name for name in rows) for k in REPORTED_KERNELS}
    print(f"phase 1: {len(rows)} kernel instantiations ({counts}), {len(spilled)} with a spill", flush=True)
    if spilled:
        raise RuntimeError(f"phase 1: register spills in {spilled}")


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def state_bytes(hw: int, b: int, t: int) -> int:
    """Bytes a packed rollout must move: words and registers in and out,
    the templates in, one int32 per lane-step in (actions or seeds), and
    the per-lane reward sum, episodes and checksum out."""
    from minigrid_tpu_torch.ops.packing import NUM_REGS

    return 4 * (3 * hw * b + 3 * NUM_REGS * b + t * b) + 12 * b


def int_issue_rate(dev) -> float:
    """Thread-instructions per second at one warp-instruction per clock on
    each of an SM's four schedulers, at the card's highest SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * 4 * 32 * mhz * 1e6


def rollout_instr(cfg, hook_ctl: bool) -> int:
    """The rollout kernel's fewest integer instructions per lane-step on
    `cfg`: the view and the transition, the flood where walls occlude, the
    hook and commit rows if `hook_ctl`, and the DynamicObstacles walk where
    `cfg` has obstacles."""
    v = cfg.agent_view_size
    instr = ROLLOUT_INSTR_PER_VIEW_CELL * v * v + ROLLOUT_INSTR_PER_TRANSITION
    if hook_ctl:
        instr += ROLLOUT_INSTR_HOOK_CTL
    n = cfg.n_obstacles or 0
    instr += n * (ROLLOUT_INSTR_THREEFRY + 9 * (n + 3))
    if not cfg.see_through_walls:
        instr += v * (ROLLOUT_INSTR_FLOOD_PER_CELL * v + ROLLOUT_INSTR_FLOOD_PER_SHIFT * 2 * (v - 1)
                      + ROLLOUT_INSTR_FLOOD_PER_ROW)
    return instr


def b1_bound(cfg, b, t, dev, ctl=True, hook=True):
    """The rollout kernel's bound for `b` lanes and `t` steps of `cfg`,
    with the commit rows if `ctl` and a hook if `hook`."""
    nbytes = state_bytes(cfg.width * cfg.height, b, t) + (2 * 12 * b if ctl else 0)
    return bound(nbytes, rollout_instr(cfg, ctl or hook) * b * t, int_issue_rate(dev))


def policy_weight_bytes(v: int) -> int:
    """Bytes of the policy kernel's weights at view size `v`: W1 (20
    one-hot channels per view cell) and W2 in bf16, their biases in bf16,
    the f32 heads."""
    from minigrid_tpu_torch.ops import policy_rollout as pr

    return (pr.HIDDEN * v * v * 20 * 2 + pr.HIDDEN * pr.HIDDEN * 2 + 2 * pr.HIDDEN * 2
            + pr.HEAD_ROWS * (pr.HIDDEN + 1) * 4)


def policy_flop(v: int) -> int:
    """The policy's operations per lane-step at view size `v`: one W1 row of
    256 adds per channel of each view cell (every value of a valid state is
    in range), the 256x256 product and the 8-row head."""
    from minigrid_tpu_torch.ops import policy_rollout as pr

    return 3 * v * v * pr.HIDDEN + 2 * pr.HIDDEN * pr.HIDDEN + 2 * pr.HEAD_ROWS * pr.HIDDEN


def b2_bound(cfg, b, t, collect, ctl=True, dev=None):
    """The policy kernel's bound for `b` lanes and `t` steps of `cfg`: the
    weights, the state, the seeds, the commit rows if `ctl` and the spill
    if `collect`, and the network's operations; with `dev`, also the env
    step's integer instructions (`rollout_instr`, the walk included) at
    the card's issue rate, when they take longer."""
    from minigrid_tpu_torch.ops import policy_rollout as pr

    v = cfg.agent_view_size
    spill = 4 * pr._spill_rows(v * v) * b * t if collect else 0
    nbytes = (state_bytes(cfg.width * cfg.height, b, t) + (2 * 12 * b if ctl else 0) + policy_weight_bytes(v)
              + spill)
    out = bound(nbytes, policy_flop(v) * b * t, BF16_FLOP_PER_S)
    if dev is not None:
        int_ms = rollout_instr(cfg, True) * b * t / int_issue_rate(dev) * 1e3
        if int_ms > out[0]:
            out = (int_ms, "operations")
    return out


def b1_plan(cfg, b, t) -> str:
    """The last rollout-kernel launch's plan (`fused_rollout.rollout_plan`
    with the card's occupancy) and the row's time under the previous
    design, for a print."""
    from minigrid_tpu_torch.ops import fused_rollout as fr

    p = fr.last_rollout_plan
    old = PREVIOUS_B1_MS.get((cfg.family, cfg.width, cfg.height, b, t))
    resident = p.blocks_per_sm * p.lanes * p.threads_per_lane // 32
    return (f"plan: {p.lanes} lanes a block, {p.threads_per_lane} threads a lane, {p.cell_bits}-bit cells, "
            f"{p.smem} B of shared memory a block; {p.blocks_per_sm} blocks ({resident} warps) resident an SM, "
            f"{p.warps_per_sm:.2f} warps an SM on average; the previous design's time "
            f"{old if old is not None else 'not measured'} ms")


def compare(got, want):
    """(mismatch count per output, max abs difference over all outputs);
    f32 outputs are compared as bit patterns."""
    import torch

    names = ("words", "regs", "rsum", "episodes", "checksum")
    counts, max_err = {}, 0.0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        gb, wb = (g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
        counts[name] = int((gb != wb).sum())
        max_err = max(max_err, float((g.double() - w.double()).abs().max()))
    return counts, max_err


def phase_kernel_vs_plain(dev, card):
    import numpy as np
    import torch

    from minigrid_tpu_torch.core.state import EnvConfig
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.testing import random_packed_case

    max_err = 0.0
    for w, h, stw in CHECK_CONFIGS:
        cfg = EnvConfig(family="empty", width=w, height=h, max_steps=4 * w * h, see_through_walls=stw)
        case = random_packed_case(w * h + stw, w, h, CHECK_B, cfg.max_steps)
        args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
        rng = np.random.default_rng(w * h)
        actions = torch.from_numpy(rng.integers(0, 7, (CHECK_T, CHECK_B)).astype(np.int32)).to(dev)
        got = fr.run_rollout_kernel(*args, actions, cfg)
        want = fr.plain_rollout(*args, actions, cfg)
        torch.cuda.synchronize()
        counts, err = compare(got, want)
        max_err = max(max_err, err)
        episodes = int(want[3].sum())
        print(f"phase 3: {w}x{h} see_through_walls={stw} B={CHECK_B} T={CHECK_T} "
              f"episodes={episodes} mismatches={counts} max_abs_err={err}", flush=True)
        if any(counts.values()) or episodes == 0:
            raise RuntimeError(f"phase 3 failed on {w}x{h} see_through_walls={stw}")
    return max_err


def phase_probe(dev, card, phase="3"):
    """The probe kernel against `x + 1` on a random (8, 128) int32 block,
    exact; both, and `torch.add(x, 1)`, timed with CUDA events; then like
    with like: raw `mg_probe_launch` calls against `torch.add` calls
    (events), and the kernel's device time against `torch.add`'s
    (`torch.profiler`). Returns (error, the kernel's device ms, the plain
    version's ms, `torch.add`'s device ms); a time the profiler did not see
    falls back to its events reading."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.ops import _build

    x = np.random.default_rng(0).integers(-(2**31), 2**31 - 1, _build.PROBE_SHAPE, dtype=np.int32)
    x = torch.from_numpy(x).to(dev)
    _build.probe(x)  # warm
    ms, got = time_events(lambda: _build.probe(x), PROBE_REPS)
    plain_ms, want = time_events(lambda: x + 1, PROBE_REPS)
    library_ms, _ = time_events(lambda: torch.add(x, 1), PROBE_REPS)
    mismatches = int((got != want).sum())
    err = float((got.double() - want.double()).abs().max())
    raw_ms, device_ms = probe_device_time(dev, x)
    add_device_ms = torch_add_device_time(x)
    slower = ("not measured" if device_ms is None or add_device_ms is None
              else "the kernel" if device_ms > add_device_ms else "its wrapper (the kernel is not)")
    print(f"phase {phase}: probe kernel on {dev}, {tuple(x.shape)}: {ms:.6f} ms/call through its wrapper, plain x+1 "
          f"{plain_ms:.6f} "
          f"ms/call; like with like: raw launches {raw_ms:.6f} ms/call against torch.add {library_ms:.6f} ms/call "
          f"(events), the kernel's device time {device_ms if device_ms is not None else 'not measured'} ms/launch "
          f"against torch.add's {add_device_ms if add_device_ms is not None else 'not measured'} ms (profiler); "
          f"the slower against torch.add: {slower} (it runs once per process, in load_library); "
          f"mismatches={mismatches} max_abs_err={err} [{card}]", flush=True)
    if mismatches:
        raise RuntimeError(f"phase {phase} failed: the probe kernel differs from x + 1 on {dev}")
    return (err, device_ms if device_ms is not None else raw_ms, plain_ms,
            add_device_ms if add_device_ms is not None else library_ms)


def torch_add_device_time(x):
    """`torch.add(x, 1)`'s device time per call from `torch.profiler` over
    PROBE_REPS calls, or None if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROBE_REPS):
            torch.add(x, 1)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / PROBE_REPS / 1e3 if us else None


def probe_device_time(dev, x):
    """The probe kernel without its wrapper's host path (capability check,
    allocation, device guard): CUDA events around PROBE_REPS raw
    `mg_probe_launch` calls into one output, and the kernel's own device
    time per launch from `torch.profiler` (None if the profiler saw no
    device time)."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    from minigrid_tpu_torch.ops import _build

    lib = _build.load_library(dev)
    out = torch.empty_like(x)
    args = (ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), x.numel(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    raw_ms, _ = time_events(lambda: lib.mg_probe_launch(*args), PROBE_REPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROBE_REPS):
            lib.mg_probe_launch(*args)
        torch.cuda.synchronize()
    us = kernel_device_us(prof, "probe_kernel")
    return raw_ms, (us / PROBE_REPS / 1e3 if us else None)


def kernel_device_us(prof, name: str) -> float:
    """Device microseconds of the kernels whose name contains `name` in a
    `torch.profiler` run."""
    total = 0.0
    for e in prof.key_averages():
        if name in e.key:
            total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    return total


def time_events(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_main_path(dev, card):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.rollout import generator_policy
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import fused_rollout as fr

    # Every kernel's count starts at 0 here and is read right after
    # `packed_finish`: they count only the main path's launches.
    fr.rollout_kernel_launches = 0
    _build.probe_launches = 0
    env = make(ENV_ID)
    cfg = env.config
    t0 = time.perf_counter()
    states, _ = env.reset_batch(key(0, device=dev), MAIN_B)
    carry = fr.packed_init(env, states, "regen")
    torch.cuda.synchronize()
    print(f"phase 2: {ENV_ID} B={MAIN_B} T={MAIN_T} regen: reset_batch + packed_init "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    step = fr.build_fused_rollout(env, MAIN_T, mode="regen", as_carry=True)
    gen = torch.Generator(device=dev).manual_seed(1)

    torch.cuda.synchronize()
    carry, metrics = step(gen, carry)  # warm-up
    warm_carry = carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episodes = 0
    for _ in range(TIMED_CALLS):
        carry, metrics = step(gen, carry)
        episodes += int(metrics.episodes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    final = fr.packed_finish(env, carry)
    torch.cuda.synchronize()
    launches = {"rollout_kernel": fr.rollout_kernel_launches, "probe_kernel": _build.probe_launches}

    steps_per_s = MAIN_B * MAIN_T * TIMED_CALLS / seconds
    print(f"phase 2: kernel path {TIMED_CALLS} step calls {seconds:.4f} s, "
          f"{steps_per_s:.6e} env-steps/s, episodes {episodes} [{card}]", flush=True)
    print(f"phase 2: launches on the main path {launches}", flush=True)
    if launches != {"rollout_kernel": 1 + TIMED_CALLS, "probe_kernel": 1}:
        raise RuntimeError(f"main path launches {launches}, expected {1 + TIMED_CALLS} and 1")
    if int(metrics.total_steps) != MAIN_B * MAIN_T:
        raise RuntimeError(f"total_steps {int(metrics.total_steps)} != {MAIN_B * MAIN_T}")
    x, y = final.agent_pos[:, 0], final.agent_pos[:, 1]
    if not bool(((x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)).all()):
        raise RuntimeError("an agent left the room's interior")
    sc = final.step_count
    if not bool(((sc >= 0) & (sc < cfg.max_steps)).all()):
        raise RuntimeError("step_count out of [0, max_steps)")
    if episodes == 0 or int(metrics.obs_checksum) == 0:
        raise RuntimeError("no episode ended, or the checksum is 0: the rollout did not run")

    # The same carry and actions through the kernel and the plain twin.
    plain_step = fr.build_packed_plain_rollout(env, MAIN_T, mode="regen", as_carry=True)
    results = []
    for fn in (step, plain_step):
        g = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn(g, warm_carry))
        torch.cuda.synchronize()
        results[-1] += (time.perf_counter() - t0,)
    (ck, mk, sk), (cp, mp, sp) = results
    bad = [n for n, a, b in zip(ck._fields, ck, cp) if not torch.equal(a, b)]
    bad += [n for n, a, b in zip(mk._fields, mk, mp) if not torch.equal(a, b)]
    print(f"phase 2: kernel step call {sk:.4f} s vs plain step call {sp:.4f} s on the same carry; "
          f"plain {MAIN_B * MAIN_T / sp:.6e} env-steps/s [{card}]; differing: {bad or 'none'}", flush=True)
    if bad:
        raise RuntimeError(f"kernel and plain twin differ at full size in {bad}")

    # The kernel alone and the twin alone, on fixed actions.
    actions = generator_policy(cfg.num_actions)(torch.Generator(device=dev).manual_seed(11), MAIN_T, MAIN_B)
    args = (warm_carry.words, warm_carry.regs, warm_carry.tmpl_words, warm_carry.tmpl_regs, actions, cfg)
    fr.run_rollout_kernel(*args)  # warm
    kernel_ms, got = time_events(lambda: fr.run_rollout_kernel(*args), 5)
    plain_ms, want = time_events(lambda: fr.plain_rollout(*args), 1)
    counts, max_err = compare(got, want)
    print(f"phase 2: rollout kernel {kernel_ms:.4f} ms/call ({MAIN_B * MAIN_T / kernel_ms * 1e3:.6e} "
          f"env-steps/s), plain twin {plain_ms:.4f} ms/call ({MAIN_B * MAIN_T / plain_ms * 1e3:.6e} "
          f"env-steps/s), mismatches={counts} [{card}]; {b1_plan(cfg, MAIN_B, MAIN_T)}", flush=True)
    if any(counts.values()):
        raise RuntimeError("kernel and plain twin differ on fixed actions at full size")
    return launches, max_err, kernel_ms, plain_ms


def phase_policy_main_path(dev, card):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr

    # Every kernel's count starts at 0 here and is read right after
    # `packed_finish`: they count only this path's launches.
    fr.rollout_kernel_launches = 0
    _build.probe_launches = 0
    pr.policy_kernel_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    env = make(ENV_ID)
    cfg = env.config
    t0 = time.perf_counter()
    carry = fr.packed_init(env, env.reset_batch(key(0), MAIN_B)[0], "regen")
    model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    step = pr.build_policy_eval_rollout(env, model, POLICY_T, mode="regen", as_carry=True)
    torch.cuda.synchronize()
    print(f"phase 4: {ENV_ID} B={MAIN_B} T={POLICY_T} regen, ActorCritic on {next(model.parameters()).device}: "
          f"reset_batch + packed_init + model {time.perf_counter() - t0:.3f} s", flush=True)

    carry, metrics = step(key(100), carry)  # warm-up
    warm_carry = carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episodes = 0
    for i in range(POLICY_TIMED_CALLS):
        carry, metrics = step(key(101 + i), carry)
        episodes += int(metrics.episodes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    final = fr.packed_finish(env, carry)
    torch.cuda.synchronize()
    launches = {
        "rollout_kernel": fr.rollout_kernel_launches,
        "probe_kernel": _build.probe_launches,
        "policy_kernel": pr.policy_kernel_launches,
    }
    peak = torch.cuda.max_memory_allocated(dev)

    steps_per_s = MAIN_B * POLICY_T * POLICY_TIMED_CALLS / seconds
    print(f"phase 4: policy path {POLICY_TIMED_CALLS} step calls {seconds:.4f} s, {steps_per_s:.6e} env-steps/s, "
          f"episodes {episodes}, reward {float(metrics.total_reward):.6f} in the last call, "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    print(f"phase 4: launches on the policy path {launches}", flush=True)
    if launches != {"rollout_kernel": 0, "probe_kernel": 0, "policy_kernel": 1 + POLICY_TIMED_CALLS}:
        raise RuntimeError(f"policy path launches {launches}, expected only {1 + POLICY_TIMED_CALLS} policy kernels")
    if int(metrics.total_steps) != MAIN_B * POLICY_T:
        raise RuntimeError(f"total_steps {int(metrics.total_steps)} != {MAIN_B * POLICY_T}")
    x, y = final.agent_pos[:, 0], final.agent_pos[:, 1]
    if not bool(((x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)).all()):
        raise RuntimeError("an agent left the room's interior")
    sc = final.step_count
    if not bool(((sc >= 0) & (sc < cfg.max_steps)).all()):
        raise RuntimeError("step_count out of [0, max_steps)")
    if episodes == 0 or int(metrics.obs_checksum) == 0:
        raise RuntimeError("no episode ended, or the checksum is 0: the rollout did not run")
    return env, model, warm_carry, launches["policy_kernel"], seconds, peak


def compare_lanes(got, want):
    """Lanes whose words, registers, reward sum, episodes or checksum differ
    (f32 compared as bit patterns)."""
    import torch

    bad = None
    for g, w in zip(got, want):
        gb, wb = (g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
        lane_bad = (gb != wb).any(dim=0)
        bad = lane_bad if bad is None else bad | lane_bad
    return int(bad.sum())


def phase_policy_vs_plain(dev, card, env, model, warm_carry):
    import numpy as np
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.state import EnvConfig
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.testing import dyadic_flax_params, random_packed_case

    cfg = env.config
    view = cfg.agent_view_size
    dyadic = pr.eval_weights_from_params(dyadic_flax_params(7), view, device=dev)
    seeds_full = pr._seeds_for(key(200), POLICY_T, MAIN_B)
    full = (warm_carry.words, warm_carry.regs, warm_carry.tmpl_words, warm_carry.tmpl_regs)

    # One kernel launch over all of phase 4's warm carry at T=256, held
    # against the twin run over consecutive column slices of SLICE_B lanes.
    dyadic_ms, got = time_events(lambda: pr.run_policy_kernel(*full, seeds_full, dyadic, cfg), 1)
    plain_ms, max_err, episodes, bad = 0.0, 0.0, 0, {}
    for lo in range(0, MAIN_B, SLICE_B):
        cols = slice(lo, lo + SLICE_B)
        part = [x[:, cols].contiguous() for x in full]
        seeds = seeds_full[:, cols].contiguous()
        ms, want = time_events(lambda: pr.plain_policy_rollout(*part, seeds, dyadic, cfg), 1)
        plain_ms += ms
        counts, err = compare([g[:, cols] for g in got], want)
        max_err = max(max_err, err)
        episodes += int(want[3].sum())
        bad = {n: bad.get(n, 0) + c for n, c in counts.items()}
    print(f"phase 5: {ENV_ID} warm carry, B={MAIN_B} T={POLICY_T}, dyadic weights: kernel {dyadic_ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms over {MAIN_B // SLICE_B} slices of {SLICE_B} lanes; "
          f"episodes={episodes} mismatches={bad} max_abs_err={max_err} [{card}]", flush=True)
    if any(bad.values()) or episodes == 0:
        raise RuntimeError("phase 5 failed on the warm carry at full size")
    del got, want

    for w, h, stw in POLICY_CHECK_CONFIGS:
        c = EnvConfig(family="empty", width=w, height=h, max_steps=4 * w * h, see_through_walls=stw)
        case = random_packed_case(w * h + 100 * stw, w, h, CHECK_B, c.max_steps)
        args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
        rng = np.random.default_rng(w * h)
        s = torch.from_numpy(rng.integers(-(2**31), 2**31, (CHECK_T, CHECK_B)).astype(np.int32)).to(dev)
        got = pr.run_policy_kernel(*args, s, dyadic, c)
        want = pr.plain_policy_rollout(*args, s, dyadic, c)
        torch.cuda.synchronize()
        counts, err = compare(got, want)
        max_err = max(max_err, err)
        episodes = int(want[3].sum())
        print(f"phase 5: {w}x{h} see_through_walls={stw} B={CHECK_B} T={CHECK_T} dyadic weights: "
              f"episodes={episodes} mismatches={counts} max_abs_err={err}", flush=True)
        if any(counts.values()) or episodes == 0:
            raise RuntimeError(f"phase 5 failed on {w}x{h} see_through_walls={stw}")

    # Phase 4's weights (flax's initialisers) after one step.
    weights = pr.eval_weights_from_params(model, view)
    part = [x[:, :SLICE_B].contiguous() for x in full]
    seed_row = seeds_full[:1, :SLICE_B].contiguous()
    got = pr.run_policy_kernel(*part, seed_row, weights, cfg)
    want = pr.plain_policy_rollout(*part, seed_row, weights, cfg)
    lanes = compare_lanes(got, want)
    print(f"phase 5: ActorCritic weights, T=1, B={SLICE_B}: {lanes} lanes differ "
          f"(limit {FLAX_T1_MAX_SHARE * SLICE_B:.2f})", flush=True)
    if lanes > FLAX_T1_MAX_SHARE * SLICE_B:
        raise RuntimeError(f"phase 5: {lanes} of {SLICE_B} lanes differ after one step")

    # The kernel alone at the main path's shape and weights.
    pr.run_policy_kernel(*full, seeds_full, weights, cfg)  # warm
    ms, _ = time_events(lambda: pr.run_policy_kernel(*full, seeds_full, weights, cfg), POLICY_TIMED_CALLS)
    per_lane_step, streamed_64 = policy_weight_traffic(cfg)
    print(f"phase 5: policy kernel B={MAIN_B} T={POLICY_T} {ms:.4f} ms/call "
          f"({MAIN_B * POLICY_T / ms * 1e3:.6e} env-steps/s); weight bytes a block reads from L2 per lane-step "
          f"{per_lane_step:.2f} (64-lane blocks streaming W1 and W2 every step: {streamed_64:.2f}) [{card}]",
          flush=True)
    if per_lane_step > streamed_64 / 2:
        raise RuntimeError("phase 5: the policy kernel reads more than half the weight bytes of 64-lane blocks")
    return max_err, ms, plain_ms, lanes


def policy_weight_traffic(cfg):
    """Weight bytes the policy kernel's blocks read from L2 per lane-step at
    `cfg`, as its design counts them: each block copies W1ᵀ's and W2ᵀ's
    slabs once a step (`policy_plan`). Beside it, 64-lane blocks that read
    both every step."""
    from minigrid_tpu_torch.ops import policy_rollout as pr

    step_bytes = (pr.padded_features(cfg.agent_view_size) * pr.HIDDEN + pr.HIDDEN * pr.HIDDEN) * 2
    return step_bytes / pr.policy_lane_block(cfg), step_bytes / 64


def phase_train_main_path(dev, card):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import grad_kernel as gk
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr

    # Every kernel's count starts at 0 here and is read right after the
    # timed calls: they count only this path's launches.
    fr.rollout_kernel_launches = 0
    _build.probe_launches = 0
    pr.policy_kernel_launches = 0
    gk.grad_kernel_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    env = make(ENV_ID)
    t0 = time.perf_counter()
    carry = fr.packed_init(env, env.reset_batch(key(0), TRAIN_B)[0], "regen")
    ts = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    step = tr.build_fused_train_step(env, TRAIN_T, mode="regen")
    p0 = tr.flatten_params(ts.params.flax_params())
    torch.cuda.synchronize()
    print(f"phase 6: {ENV_ID} B={TRAIN_B} T={TRAIN_T} regen, fused train step, ActorCritic on "
          f"{next(ts.params.parameters()).device}: reset_batch + packed_init + init_train_state "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    ts, carry, metrics = step(ts, carry, key(300))  # warm-up
    warm_carry = carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(TRAIN_TIMED_CALLS):
        ts, carry, metrics = step(ts, carry, key(301 + i))
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "rollout_kernel": fr.rollout_kernel_launches,
        "probe_kernel": _build.probe_launches,
        "policy_kernel": pr.policy_kernel_launches,
        "grad_kernel": gk.grad_kernel_launches,
    }
    peak = torch.cuda.max_memory_allocated(dev)
    moved = float((tr.flatten_params(ts.params.flax_params()) - p0).abs().max())

    steps_per_s = TRAIN_B * TRAIN_T * TRAIN_TIMED_CALLS / seconds
    last = {k: float(v) for k, v in metrics.items()}
    print(f"phase 6: train path {TRAIN_TIMED_CALLS} train steps {seconds:.4f} s, {steps_per_s:.6e} env-steps/s, "
          f"loss per step {losses}, last metrics {last}, params moved by up to {moved:.6e}, "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    print(f"phase 6: launches on the train path {launches}", flush=True)
    want = {"rollout_kernel": 0, "probe_kernel": 0, "policy_kernel": 1 + TRAIN_TIMED_CALLS,
            "grad_kernel": 1 + TRAIN_TIMED_CALLS}
    if launches != want:
        raise RuntimeError(f"train path launches {launches}, expected {want}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"the loss is not finite: {losses}")
    if int(metrics["env_steps"]) != TRAIN_B * TRAIN_T:
        raise RuntimeError(f"env_steps {int(metrics['env_steps'])} != {TRAIN_B * TRAIN_T}")
    if not moved > 0:
        raise RuntimeError("the train steps did not move the params")
    if int(ts.opt_state.count) != 1 + TRAIN_TIMED_CALLS:
        raise RuntimeError(f"optimizer count {int(ts.opt_state.count)}")
    return env, ts, warm_carry, launches, seconds, peak


def grad_flop(v: int) -> int:
    """The gradient kernel's operations per sample at view size `v`: the
    forward (layer 1 by its 3 V*V active one-hot rows), the head, and the
    backward products dwta, wta^T.dhead, dW2, W2^T.dh2 and dW1 (by the
    active rows again)."""
    from minigrid_tpu_torch.ops import policy_rollout as pr

    h, k_active = pr.HIDDEN, 3 * v * v
    return (k_active * h + 2 * h * h + 2 * pr.HEAD_ROWS * h) + (4 * pr.HEAD_ROWS * h + 4 * h * h + k_active * h)


def grad_bound(v: int, b: int, t: int):
    """The gradient kernel's bound for `b` lanes and `t` steps: each
    sample's obs words, action, advantage and return read once, the weights
    read and their gradients written, and `grad_flop` per sample."""
    return bound(4 * (v * v + 3) * b * t + 2 * policy_weight_bytes(v), grad_flop(v) * b * t, BF16_FLOP_PER_S)


def _grad_compare(args):
    """The gradient kernel on `run_grad_kernel`'s `args` against
    `plain_grad_pass`: one launch, then `TRAIN_TIMED_CALLS` timed ones (the
    last compared), the plain pass timed once. Returns (ms, plain_ms, the
    rel-to-max error per weight, the loss sums' rel error, max_abs_err,
    two launches bit-identical, the kernel's loss sums, the plain (grads,
    sums))."""
    import torch

    from minigrid_tpu_torch.ops import grad_kernel as gk
    from minigrid_tpu_torch.ops import policy_rollout as pr

    first = gk.run_grad_kernel(*args)
    ms, second = time_events(lambda: gk.run_grad_kernel(*args), TRAIN_TIMED_CALLS)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((*first[0], first[1]), (*second[0], second[1])))
    plain_ms, (want_gw, want_sums) = time_events(lambda: gk.plain_grad_pass(*args), 1)
    rel, err = {}, 0.0
    for name, g, w in zip(pr.EvalWeights._fields, second[0], want_gw):
        rel[name] = float((g - w).abs().max() / (w.abs().max() + 1e-9))
        err = max(err, float((g.double() - w.double()).abs().max()))
    sums_rel = float(((second[1] - want_sums).abs() / want_sums.abs()).max())
    err = max(err, float((second[1].double() - want_sums.double()).abs().max()))
    return ms, plain_ms, rel, sums_rel, err, same, second[1], (want_gw, want_sums)


def _grad_within_bounds(rel, sums_rel, same, sums) -> bool:
    """Phase 7's bounds: heads 1e-4 and torso 1e-3 of each weight's largest
    entry, loss sums rtol 1e-4, finite, two launches bit for bit."""
    import torch

    return (rel["wta"] < GRAD_HEAD_TOL and rel["ba"] < GRAD_HEAD_TOL
            and all(rel[n] < GRAD_TORSO_TOL for n in ("wt1", "b1", "wt2", "b2"))
            and bool(torch.isfinite(sums).all()) and sums_rel < GRAD_SUMS_RTOL and same)


def phase_train_vs_plain(dev, card, env, ts, warm_carry):
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import grad_kernel as gk
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    cfg = env.config
    view = cfg.agent_view_size
    full = (warm_carry.words, warm_carry.regs, warm_carry.tmpl_words, warm_carry.tmpl_regs)
    seeds = pr._seeds_for(key(400), TRAIN_T, TRAIN_B)

    # The collecting policy kernel on all lanes under dyadic weights, held
    # against the twin over column slices.
    dyadic = pr.train_weights_from_params(dyadic_flax_params(8), view, device=dev)
    _, got = time_events(lambda: pr.run_policy_kernel(*full, seeds, dyadic, cfg, collect=True), 1)
    collect_plain_ms, max_err, episodes, bad = 0.0, 0.0, 0, {}
    fields = ("words", "regs", "rsum", "episodes", "checksum", "obs_w", "actions", "logp", "value", "reward", "done")
    for lo in range(0, TRAIN_B, TRAIN_SLICE_B):
        cols = slice(lo, lo + TRAIN_SLICE_B)
        part = [x[:, cols].contiguous() for x in full]
        ms, want = time_events(
            lambda: pr.plain_policy_rollout(*part, seeds[:, cols].contiguous(), dyadic, cfg, collect=True), 1
        )
        collect_plain_ms += ms
        for name, g, w in zip(fields, (*got[:5], *got[5]), (*want[:5], *want[5])):
            g = g[..., cols]
            if g.dtype != w.dtype or g.shape != w.shape:
                raise RuntimeError(f"phase 7: {name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            gb, wb = (g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
            bad[name] = bad.get(name, 0) + int((gb != wb).sum())
            max_err = max(max_err, float((g.double() - w.double()).abs().max()))
        episodes += int(want[3].sum())
        del want
    print(f"phase 7: collecting policy kernel, {ENV_ID} warm carry, B={TRAIN_B} T={TRAIN_T}, dyadic weights: "
          f"plain twin {collect_plain_ms:.4f} ms over {TRAIN_B // TRAIN_SLICE_B} slices of {TRAIN_SLICE_B} lanes; "
          f"episodes={episodes} mismatches={bad} max_abs_err={max_err} [{card}]", flush=True)
    if any(bad.values()) or episodes == 0:
        raise RuntimeError("phase 7 failed: the collect spill differs from the twin")
    del got

    # Both kernels timed at the main path's shape under the trained weights.
    weights = pr.train_weights_from_params(ts.params, view)
    pr.run_policy_kernel(*full, seeds, weights, cfg, collect=True)  # warm
    collect_ms, out = time_events(
        lambda: pr.run_policy_kernel(*full, seeds, weights, cfg, collect=True), TRAIN_TIMED_CALLS
    )
    obs_w, actions, _, value, reward, done = out[5]
    ret = tr._trajectory_returns(reward, done, tr.GAMMA)
    adv = ret - value
    denom = float(TRAIN_T * TRAIN_B)
    args = (weights, obs_w, actions, adv, ret, cfg.num_actions, denom, tr.VALUE_COEF, tr.ENTROPY_COEF)
    grad_ms, grad_plain_ms, rel, sums_rel, grad_err, same, sums, (want_gw, want_sums) = _grad_compare(args)
    # What a G2 that left out its last lane split, or its first time
    # chunk, would read on dW1 and dW2: that part's share of the plain sums.
    splits, split_lanes = gk.grad_splits(TRAIN_B)
    parts = {
        f"lane split of {split_lanes}": (slice(None), slice(TRAIN_B - split_lanes, TRAIN_B)),
        f"time chunk of {gk.TIME_CHUNK}": (slice(0, gk.TIME_CHUNK), slice(None)),
    }
    dropped = {}
    for part, (steps, cols) in parts.items():
        part_gw, _ = gk.plain_grad_pass(
            weights, obs_w[steps, :, cols], actions[steps, cols], adv[steps, cols], ret[steps, cols], *args[5:]
        )
        dropped[part] = {n: float(getattr(part_gw, n).abs().max() / (getattr(want_gw, n).abs().max() + 1e-9))
                         for n in ("wt1", "wt2")}
    print(f"phase 7: grad kernel torso bound {GRAD_TORSO_TOL}; rel-to-max reading of a G2 that left out one "
          f"part ({splits} lane splits): {dropped} [{card}]", flush=True)
    if min(min(r.values()) for r in dropped.values()) <= GRAD_TORSO_TOL:
        raise RuntimeError("phase 7 failed: the torso bound would not catch a G2 that left out a part")
    per_lane_step, _ = policy_weight_traffic(cfg)
    print(f"phase 7: collecting policy kernel B={TRAIN_B} T={TRAIN_T} {collect_ms:.4f} ms/call "
          f"({TRAIN_B * TRAIN_T / collect_ms * 1e3:.6e} env-steps/s); weight bytes from L2 per lane-step "
          f"{per_lane_step:.2f} [{card}]", flush=True)
    g1_ms, g2_ms = grad_split_times(args)
    g2_library_ms = g2_yardstick(dev)
    w1 = pr.padded_features(view) * pr.HIDDEN * 2
    print(f"phase 7: grad kernel B={TRAIN_B} T={TRAIN_T} {grad_ms:.4f} ms/call (profiler: G1 {g1_ms:.4f}, G2 "
          f"{g2_ms:.4f} ms), plain_grad_pass {grad_plain_ms:.4f} ms, G2's yardstick {g2_library_ms:.4f} ms; "
          f"G1 weight bytes from L2 per sample {(w1 + 4 * pr.HIDDEN * pr.HIDDEN) / gk.LANE_BLOCK:.2f}, G2 scratch and obs "
          f"bytes per sample over its tiles {g2_sample_bytes(view):.2f}; rel-to-max error {rel}, loss sums rel "
          f"{sums_rel:.3e} (kernel {sums.tolist()}, plain {want_sums.tolist()}), max_abs_err {grad_err}; "
          f"two launches bit-identical: {same} [{card}]", flush=True)
    if not _grad_within_bounds(rel, sums_rel, same, sums):
        raise RuntimeError("phase 7 failed: the grad kernel is outside its bounds or does not repeat")
    return max_err, collect_ms, collect_plain_ms, grad_err, grad_ms, grad_plain_ms, g2_library_ms


def grad_split_times(args):
    """G1's and G2's device milliseconds in one gradient-kernel call on
    `run_grad_kernel`'s `args`, from `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from minigrid_tpu_torch.ops import grad_kernel as gk

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gk.run_grad_kernel(*args)
        torch.cuda.synchronize()
    return kernel_device_us(prof, "grad_g1_kernel") / 1e3, kernel_device_us(prof, "grad_g2_kernel") / 1e3


def g2_sample_bytes(view: int) -> float:
    """Bytes G2's tiles read per sample: each dW1ᵀ tile dh1's 256 rows and
    the obs words, each dW2 tile its 128 rows of dh2 and h1's 256 rows."""
    from minigrid_tpu_torch.ops import grad_kernel as gk

    _, w1_tiles, w2_tiles = gk.g2_tiles(view)
    return w1_tiles * (2 * 256 + 4 * view * view) + w2_tiles * (2 * 128 + 2 * 256)


def g2_yardstick(dev) -> float:
    """A yardstick for G2, timed and used nowhere in the port: one cuBLAS
    bf16 GEMM (f32 accumulation) of dW2's half, dh2 · h1ᵀ, over one time
    chunk's samples at the train path's shape (operands of the scratch's
    shape), times the chunks of a call."""
    import torch

    from minigrid_tpu_torch.ops import grad_kernel as gk
    from minigrid_tpu_torch.ops import policy_rollout as pr

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((pr.HIDDEN, gk.TIME_CHUNK * TRAIN_B), device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn((pr.HIDDEN, gk.TIME_CHUNK * TRAIN_B), device=dev, generator=g).to(torch.bfloat16)
    torch.matmul(a, b.T)  # warm
    ms, _ = time_events(lambda: torch.matmul(a, b.T), TRAIN_TIMED_CALLS)
    del a, b
    return ms * (TRAIN_T // gk.TIME_CHUNK)


def phase_kc_main_path(dev, card):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import chunked_regen as cr
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import gen_kernel as gk
    from minigrid_tpu_torch.ops import grad_kernel as grk
    from minigrid_tpu_torch.ops import policy_rollout as pr

    # Every kernel's count starts at 0 here and is read right after
    # `packed_finish`: they count only this path's launches.
    fr.rollout_kernel_launches = 0
    gk.connect_kernel_launches = 0
    _build.probe_launches = 0
    pr.policy_kernel_launches = 0
    grk.grad_kernel_launches = 0
    cr.host_syncs = 0
    cr.reentry_passes = 0
    torch.cuda.reset_peak_memory_stats(dev)
    env = make(KC_ENV_ID)
    cfg = env.config
    t0 = time.perf_counter()
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), KC_B)[0], "regen")
    torch.cuda.synchronize()
    print(f"phase 8: {KC_ENV_ID} B={KC_B} T={KC_T} regen: reset_batch + packed_init "
          f"{time.perf_counter() - t0:.3f} s, {gk.connect_kernel_launches} connect kernel launches", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    steps = {c: fr.build_fused_rollout(env, KC_T, mode="regen", as_carry=True, regen_chunk=c) for c in KC_CHUNKS}
    carry, _ = steps[KC_CHUNKS[0]](gen, carry)  # warm-up
    torch.cuda.synchronize()
    warm_carry, reset_carry, done_steps = carry, None, KC_T
    results = {}
    for chunk in KC_CHUNKS:
        before = (fr.rollout_kernel_launches, gk.connect_kernel_launches, cr.host_syncs, cr.reentry_passes)
        metrics = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(KC_WINDOW):
            if reset_carry is None and done_steps + KC_T > cfg.max_steps:
                reset_carry = carry  # the carry whose next call holds the mass reset
            carry, m = steps[chunk](gen, carry)
            metrics.append(m)
            done_steps += KC_T
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = (fr.rollout_kernel_launches, gk.connect_kernel_launches, cr.host_syncs, cr.reentry_passes)
        per_call = [(a - b) / KC_WINDOW for a, b in zip(after, before)]
        totals = {n: sum(int(getattr(m, n)) for m in metrics) for n in ("episodes", "obs_checksum", "reset_overlaps")}
        reward = sum(float(m.total_reward) for m in metrics)
        if any(int(m.total_steps) != KC_B * KC_T for m in metrics):
            raise RuntimeError("phase 8: total_steps != B*T")
        rate = KC_B * KC_T * KC_WINDOW / seconds
        results[chunk] = {"seconds": seconds, "rate": rate, **totals, "reward": reward, "per_call": per_call}
        print(f"phase 8: regen_chunk {chunk}: {KC_WINDOW} step calls {seconds:.4f} s, {rate:.6e} env-steps/s; "
              f"episodes {totals['episodes']}, reset_overlaps {totals['reset_overlaps']}, reward {reward:.6f}; "
              f"per call: rollout kernel launches {per_call[0]}, connect kernel launches {per_call[1]}, "
              f"host syncs {per_call[2]}, re-entry passes {per_call[3]} [{card}]", flush=True)
        if totals["episodes"] == 0 or totals["obs_checksum"] == 0:
            raise RuntimeError(f"phase 8: no episode ended, or the checksum is 0, at regen_chunk {chunk}")
    final = fr.packed_finish(env, carry)
    torch.cuda.synchronize()
    launches = {
        "rollout_kernel": fr.rollout_kernel_launches,
        "connect_kernel": gk.connect_kernel_launches,
        "probe_kernel": _build.probe_launches,
        "policy_kernel": pr.policy_kernel_launches,
        "grad_kernel": grk.grad_kernel_launches,
    }
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 8: launches on the KeyCorridor regen path {launches}; peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    if launches["rollout_kernel"] == 0 or launches["connect_kernel"] == 0:
        raise RuntimeError(f"phase 8: a kernel of the path did not launch: {launches}")
    if launches["probe_kernel"] or launches["policy_kernel"] or launches["grad_kernel"]:
        raise RuntimeError(f"phase 8: a kernel off the path launched: {launches}")
    x, y = final.agent_pos[:, 0], final.agent_pos[:, 1]
    if not bool(((x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)).all()):
        raise RuntimeError("phase 8: an agent left the grid's interior")
    if not bool(((final.step_count >= 0) & (final.step_count < cfg.max_steps)).all()):
        raise RuntimeError("phase 8: step_count out of [0, max_steps)")
    return env, warm_carry, reset_carry, launches, results, peak


def _same_carry_and_metrics(got, want):
    """Names of carry leaves and metrics that differ (f32 bit for bit)."""
    import torch

    (cg, mg), (cw, mw) = got, want
    bad = [n for n, a, b in zip(cg._fields, cg, cw) if not torch.equal(a, b)]
    bad += [n for n, a, b in zip(mg._fields, mg, mw)
            if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)]
    return bad


def kc_connect_inputs(cfg, b, dev):
    """The connect kernel's arguments that KeyCorridor's generator makes
    for `b` lanes: one `generate_packed` call on numpy keys (seed 8),
    caught at the wrapper."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.envs.keycorridor import generate_packed
    from minigrid_tpu_torch.ops import gen_kernel as gk

    captured = []
    run = gk.run_connect_kernel
    gk.run_connect_kernel = lambda *a: captured.append(a) or run(*a)
    try:
        keys = torch.from_numpy(np.random.default_rng(8).integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.int64))
        generate_packed(keys.to(dev), cfg)
    finally:
        gk.run_connect_kernel = run
    return captured[0]


def mr_chain_inputs(cfg, b, dev):
    """The room-chain kernel's arguments that MultiRoom's `_plan` makes for
    `b` lanes from numpy keys (seed 8): the retry key rows, the room
    counts, `cfg` and `MAX_ATTEMPTS`."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.envs.multiroom import MAX_ATTEMPTS
    from minigrid_tpu_torch.ops.packing import key_rows

    keys = torch.from_numpy(np.random.default_rng(8).integers(0, 2**32, (b, 2), dtype=np.uint64)
                            .astype(np.int64)).to(dev)
    k, _ = prng.split(keys, 2).unbind(1)
    ks = prng.split(k, 6).unbind(1)
    return (key_rows(ks[1]), prng.randint(ks[0], cfg.min_num_rooms, cfg.max_num_rooms + 1)[None].contiguous(), cfg,
            MAX_ATTEMPTS)


def phase_kc_vs_plain(dev, card, env, warm_carry, reset_carry):
    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import gen_kernel as gk
    from minigrid_tpu_torch.ops.packing import key_rows
    from minigrid_tpu_torch.testing import plant_pickup_target
    from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    cfg = env.config
    # (a) The whole chunked-regen step at chunk 128 from the carry of phase 8
    # whose next call holds the mass reset: kernels against plain versions.
    out = {}
    for name, build in (("kernel", fr.build_fused_rollout), ("plain", fr.build_packed_plain_rollout)):
        step = build(env, KC_T, mode="regen", as_carry=True, regen_chunk=KC_CHUNKS[0])
        g = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(g, reset_carry)
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t0)
    bad = _same_carry_and_metrics(out["kernel"][0], out["plain"][0])
    m = out["kernel"][0][1]
    print(f"phase 9a: chunked-regen step at chunk {KC_CHUNKS[0]}, B={KC_B} T={KC_T}, through the mass reset: "
          f"kernels {out['kernel'][1]:.4f} s, plain versions {out['plain'][1]:.4f} s; episodes {int(m.episodes)}, "
          f"reset_overlaps {int(m.reset_overlaps)}; differing: {bad or 'none'} [{card}]", flush=True)
    if bad or int(m.episodes) < KC_B // 2:
        raise RuntimeError(f"phase 9a failed: differing {bad}, episodes {int(m.episodes)}")

    # (b) B4 alone: the generator's own connect inputs for B lanes (taken
    # from one generate_packed call), and numpy-random ones with locked
    # rooms, some lanes unable to connect, and a small max_itrs.
    plan = kc_connect_inputs(cfg, KC_B, dev)
    rows, cols = cfg.num_rows, cfg.num_cols
    rng = np.random.default_rng(9)
    t = torch.from_numpy
    locked = gk._pack_bits(t(rng.random((KC_B, rows * cols)) < 0.1))
    hd0 = torch.cat([gk._pack_bits(t(rng.random((KC_B, rows * cols)) < 0.15)) for _ in range(4)])
    random_in = (key_rows(t(rng.integers(0, 2**32, (KC_B, 2), dtype=np.uint64).astype(np.int64))),
                 t(rng.integers(0, cols, (1, KC_B)).astype(np.int32)), t(rng.integers(0, rows, (1, KC_B)).astype(np.int32)),
                 locked, hd0)
    cases = [("generator plan", plan)] + [(f"random, max_itrs {mi}", tuple(x.to(dev) for x in random_in) + (rows, cols, mi))
                                          for mi in (5000, 7)]
    max_err, timing = 0.0, None
    for name, args in cases:
        got = gk.run_connect_kernel(*args)
        want = gk.plain_connect_plan(*args)
        torch.cuda.synchronize()
        mism = {n: int((g != w).sum()) for n, g, w in zip(("doors", "colors", "draws"), got, want)}
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        max_err = max(max_err, err)
        draws = want[2][0].double()
        warp_draws = float(draws.reshape(-1, 32).max(dim=1).values.mean())
        print(f"phase 9b: connect kernel, {name}, B={KC_B}: draws mean {float(draws.mean()):.4f} max "
              f"{int(draws.max())}, mean of the 32-lane warp's max {warp_draws:.4f} "
              f"({warp_draws / max(float(draws.mean()), 1e-9):.3f}x); mismatches {mism}", flush=True)
        if any(mism.values()):
            raise RuntimeError(f"phase 9b failed on {name}: {mism}")
        if timing is None:  # the main path's inputs
            gk.run_connect_kernel(*args)  # warm
            ms, _ = time_events(lambda: gk.run_connect_kernel(*args), KC_TIMED)
            plain_ms, _ = time_events(lambda: gk.plain_connect_plan(*args), 1)
            timing = (ms, plain_ms, float(draws.sum()), int(draws.max()), float(draws.mean()),
                      gk.card_plan(0, KC_B, dev, rows=rows, cols=cols))
    ops = (CONNECT_OPS_PER_DRAW_BASE + CONNECT_OPS_PER_FLOOD_STEP * rows * cols) * timing[2]
    b4_bound = bound(4 * (2 + 3 + 4) * KC_B + 4 * (4 + rows * cols * 4 + 1) * KC_B, ops, int_issue_rate(dev))
    print(f"phase 9b: connect kernel on the generator plan, B={KC_B}: {timing[0]:.6f} ms/call (mean of {KC_TIMED}; "
          f"previous design {PREVIOUS_B4_MS} ms), plain {timing[1]:.4f} ms; {timing[2]:.0f} draws (mean "
          f"{timing[4]:.4f}, max {timing[3]}); bound {b4_bound}; plan {timing[5]} [{card}]", flush=True)

    # (c) B1 with the hook and the control rows: the chunked-regen step
    # through the kernels and through the plain versions, on planted
    # targets, at two chunks, with max_steps as registered and cut.
    overlaps, successes = 0, 0.0
    for env_id in KC_CHECK_IDS:
        base = make(env_id)
        states = plant_pickup_target(state_to_numpy(base.reset_batch(key(3, device=dev), KC_CHECK_B)[0]))
        for max_steps in (base.config.max_steps, KC_CUT_MAX_STEPS):
            e = base if max_steps == base.config.max_steps else dataclasses.replace(
                base, config=dataclasses.replace(base.config, max_steps=max_steps))
            carry = fr.packed_init(e, state_from_numpy(states, device=dev), "regen")
            for chunk in (4, 8):
                res = []
                for build in (fr.build_fused_rollout, fr.build_packed_plain_rollout):
                    step = build(e, KC_CHECK_T, mode="regen", as_carry=True, regen_chunk=chunk)
                    res.append(step(torch.Generator(device=dev).manual_seed(chunk), carry))
                bad = _same_carry_and_metrics(*res)
                m = res[0][1]
                overlaps += int(m.reset_overlaps)
                successes += float(m.total_reward)
                print(f"phase 9c: {env_id} max_steps {max_steps} chunk {chunk} B={KC_CHECK_B} T={KC_CHECK_T}: "
                      f"episodes {int(m.episodes)}, reward {float(m.total_reward):.6f}, reset_overlaps "
                      f"{int(m.reset_overlaps)}; differing: {bad or 'none'}", flush=True)
                if bad:
                    raise RuntimeError(f"phase 9c failed on {env_id} max_steps {max_steps} chunk {chunk}: {bad}")
    if overlaps == 0 or successes <= 0:
        raise RuntimeError(f"phase 9c: reset_overlaps {overlaps}, reward {successes}: the protocol was not exercised")

    # B1 with the hook and the control rows alone, one 128-step pass of the
    # main path's shape from phase 8's warm carry.
    w = warm_carry
    actions = torch.randint(0, 7, (KC_CHUNKS[0], KC_B), dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(12))
    ctl = torch.zeros((3, KC_B), dtype=torch.int32, device=dev)
    args = (w.words, w.regs, w.tmpl_words, w.tmpl_regs, actions, cfg)
    fr.run_rollout_kernel(*args, transition=env.transition, ctl=ctl)  # warm
    b1_ms, got = time_events(lambda: fr.run_rollout_kernel(*args, transition=env.transition, ctl=ctl), KC_TIMED)
    b1_plain_ms, want = time_events(lambda: fr.plain_rollout(*args, transition=env.transition, ctl=ctl), 1)
    counts, b1_err = compare(got[:5], want[:5])
    counts["ctl"] = int((got[5] != want[5]).sum())
    b1_bnd = b1_bound(cfg, KC_B, KC_CHUNKS[0], dev)
    print(f"phase 9: rollout kernel with the hook and the control rows, {KC_ENV_ID} B={KC_B} "
          f"T={KC_CHUNKS[0]}: {b1_ms:.6f} ms/call (mean of {KC_TIMED}), plain {b1_plain_ms:.4f} ms, "
          f"mismatches {counts}; bound {b1_bnd} ({rollout_instr(cfg, True)} instructions per lane-step) "
          f"[{card}]; {b1_plan(cfg, KC_B, KC_CHUNKS[0])}", flush=True)
    if any(counts.values()):
        raise RuntimeError("phase 9: the rollout kernel with the hook differs from its plain version")
    return (max_err, timing[0], timing[1], b4_bound), (b1_err, b1_ms, b1_plain_ms, b1_bnd)


def _zero_counts():
    """Set every kernel's launch count, and chunked regen's host-sync and
    re-entry counts, to 0."""
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import chunked_regen as cr
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import gen_kernel as gk
    from minigrid_tpu_torch.ops import grad_kernel as grk
    from minigrid_tpu_torch.ops import policy_rollout as pr

    from minigrid_tpu_torch.tools import probe_mosaic as pm

    fr.rollout_kernel_launches = gk.connect_kernel_launches = gk.mr_chain_kernel_launches = 0
    _build.probe_launches = pr.policy_kernel_launches = grk.grad_kernel_launches = pm.probe_kernel_launches = 0
    cr.host_syncs = cr.reentry_passes = cr.reentry_lanes = 0


def _counts():
    from minigrid_tpu_torch.ops import _build
    from minigrid_tpu_torch.ops import chunked_regen as cr
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import gen_kernel as gk
    from minigrid_tpu_torch.ops import grad_kernel as grk
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.tools import probe_mosaic as pm

    return {
        "rollout_kernel": fr.rollout_kernel_launches,
        "policy_kernel": pr.policy_kernel_launches,
        "mr_chain_kernel": gk.mr_chain_kernel_launches,
        "connect_kernel": gk.connect_kernel_launches,
        "probe_kernel": _build.probe_launches,
        "grad_kernel": grk.grad_kernel_launches,
        "mosaic_probe_kernel": pm.probe_kernel_launches,
        "host_syncs": cr.host_syncs,
        "reentry_passes": cr.reentry_passes,
        "reentry_lanes": cr.reentry_lanes,
    }


def _mr_window(name, step, sources, carry, env, dev, card, path_kernels):
    """One warm-up call, then `MR_TIMED` timed calls with every count set to
    0 just before them. Returns (the carry before each timed call, their
    metrics, the counts, env-steps/s, peak memory)."""
    import torch

    from minigrid_tpu_torch.ops import fused_rollout as fr

    cfg = env.config
    carry, _ = step(sources[0], carry)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    befores, metrics = [], []
    t0 = time.perf_counter()
    for source in sources[1:]:
        befores.append(carry)
        carry, m = step(source, carry)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    final = fr.packed_finish(env, carry)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    totals = {n: sum(int(getattr(m, n)) for m in metrics) for n in ("episodes", "obs_checksum", "reset_overlaps")}
    rate = MR_B * MR_T * MR_TIMED / seconds
    per_call = {n: c / MR_TIMED for n, c in counts.items() if c}
    print(f"phase 10{name}: {MR_TIMED} step calls {seconds:.4f} s, {rate:.6e} env-steps/s; episodes "
          f"{totals['episodes']}, reset_overlaps {totals['reset_overlaps']}, reward "
          f"{sum(float(m.total_reward) for m in metrics):.6f}; per call {per_call}; peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    if any(int(m.total_steps) != MR_B * MR_T for m in metrics):
        raise RuntimeError(f"phase 10{name}: total_steps != B*T")
    if totals["episodes"] < MR_B or totals["obs_checksum"] == 0 or totals["reset_overlaps"] == 0:
        raise RuntimeError(f"phase 10{name}: the mass resets or the re-entry did not run: {totals}")
    kernels = {n: c for n, c in counts.items() if n.endswith("_kernel")}
    if any(kernels[n] == 0 for n in path_kernels) or any(c for n, c in kernels.items() if n not in path_kernels):
        raise RuntimeError(f"phase 10{name}: launches {kernels}; the path runs {path_kernels} and no other kernel")
    x, y = final.agent_pos[:, 0], final.agent_pos[:, 1]
    if not bool(((x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)).all()):
        raise RuntimeError(f"phase 10{name}: an agent left the grid's interior")
    if not bool(((final.step_count >= 0) & (final.step_count < cfg.max_steps)).all()):
        raise RuntimeError(f"phase 10{name}: step_count out of [0, max_steps)")
    return befores, metrics, counts, rate, peak


def phase_mr_main_path(dev, card):
    """MultiRoom-N4-S5 regen at full size, (a) under the random policy and
    (b) with the seeded ActorCritic in the loop, both through chunked regen
    at chunk 96 from one `packed_init`."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr

    env = make(MR_ENV_ID)
    t0 = time.perf_counter()
    carry0 = fr.packed_init(env, env.reset_batch(key(0, device=dev), MR_B)[0], "regen")
    torch.cuda.synchronize()
    print(f"phase 10: {MR_ENV_ID} B={MR_B} T={MR_T} regen_chunk {MR_CHUNK}: reset_batch + packed_init "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    step = fr.build_fused_rollout(env, MR_T, mode="regen", as_carry=True, regen_chunk=MR_CHUNK)
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = _mr_window("a", step, [gen] * (1 + MR_TIMED), carry0, env, dev, card,
                      ("rollout_kernel", "mr_chain_kernel"))
    model = ActorCritic(env.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    pstep = pr.build_policy_eval_rollout(env, model, MR_T, mode="regen", as_carry=True, regen_chunk=MR_CHUNK)
    policy = _mr_window("b", pstep, [key(100 + i, device=dev) for i in range(1 + MR_TIMED)], carry0, env, dev,
                        card, ("policy_kernel", "mr_chain_kernel"))
    return env, model, rand, policy


def _overlap_carry(window):
    """The carry of a window whose next call deferred the most resets."""
    befores, metrics = window[0], window[1]
    i = max(range(len(metrics)), key=lambda j: int(metrics[j].reset_overlaps))
    return befores[i]


def phase_mr_vs_plain(dev, card, env, rand, policy):
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import gen_kernel as gk
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    # (a) B5 on the generator's own retry keys and room counts.
    chain = {}
    for env_id in MR_CHAIN_IDS:
        cfg = make(env_id).config
        args = mr_chain_inputs(cfg, MR_B, dev)
        gk.run_mr_chain_kernel(*args)  # warm
        ms, got = time_events(lambda: gk.run_mr_chain_kernel(*args), MR_TIMED)
        plan = gk.card_plan(1, MR_B, dev, nmax=cfg.max_num_rooms)
        plain_ms, want = time_events(lambda: gk.plain_mr_chain(*args), 1)
        mism = {n: int((g != w).sum()) for n, g, w in zip(("rooms", "count", "attempts", "rows"), got, want)}
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        att, rows = want[2][0].double(), want[3][0].double()
        attempts, rows_total = float(att.sum()), float(rows.sum())
        tries = (rows_total - 4 * attempts) / 5
        ops = rows_total * MR_OPS_PER_ROW + tries * MR_OPS_PER_TRY + attempts * MR_OPS_PER_ATTEMPT
        nbytes = 4 * 3 * MR_B + 4 * (6 * cfg.max_num_rooms + 3) * MR_B
        b5_bound = bound(nbytes, ops, int_issue_rate(dev))
        warp_att = float(att.reshape(-1, 32).max(dim=1).values.mean())
        warp_rows = float(rows.reshape(-1, 32).max(dim=1).values.mean())
        print(f"phase 11a: room-chain kernel, {env_id}, B={MR_B}: {ms:.6f} ms/call (mean of {MR_TIMED}; previous "
              f"design {PREVIOUS_B5_MS[env_id]} ms), plain {plain_ms:.4f} ms; attempts mean {float(att.mean()):.4f} "
              f"max {int(att.max())}, mean of the 32-lane warp's max {warp_att:.4f} "
              f"({warp_att / float(att.mean()):.3f}x); rows mean {float(rows.mean()):.4f}, warp max mean "
              f"{warp_rows:.4f} ({warp_rows / float(rows.mean()):.3f}x); count == num_rooms on "
              f"{int((want[1] == args[1]).sum())} lanes; bound {b5_bound} ({ops:.6e} operations); plan {plan}; "
              f"mismatches {mism} [{card}]", flush=True)
        if any(mism.values()):
            raise RuntimeError(f"phase 11a failed on {env_id}: {mism}")
        chain[env_id] = (err, ms, plain_ms, b5_bound)

    # (b) The whole random-policy chunked-regen step from phase 10's carry
    # whose call deferred resets: kernels against plain versions.
    carry = _overlap_carry(rand)
    out = {}
    for name, build in (("kernel", fr.build_fused_rollout), ("plain", fr.build_packed_plain_rollout)):
        step = build(env, MR_T, mode="regen", as_carry=True, regen_chunk=MR_CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(torch.Generator(device=dev).manual_seed(7), carry)
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t0)
    bad = _same_carry_and_metrics(out["kernel"][0], out["plain"][0])
    m = out["kernel"][0][1]
    print(f"phase 11b: random-policy chunked-regen step, B={MR_B} T={MR_T} chunk {MR_CHUNK}: kernels "
          f"{out['kernel'][1]:.4f} s, plain versions {out['plain'][1]:.4f} s; episodes {int(m.episodes)}, "
          f"reset_overlaps {int(m.reset_overlaps)}; differing: {bad or 'none'} [{card}]", flush=True)
    if bad or int(m.episodes) < MR_B or int(m.reset_overlaps) == 0:
        raise RuntimeError(f"phase 11b failed: differing {bad}, episodes {int(m.episodes)}, "
                           f"reset_overlaps {int(m.reset_overlaps)}")

    # (c) The policy-eval chunked-regen step under dyadic weights, kernel
    # against twin, from phase 10's carry whose call deferred resets.
    params = dyadic_flax_params(7)
    carry = _overlap_carry(policy)
    out = {}
    for name, build in (("kernel", pr.build_policy_eval_rollout), ("twin", pr.build_policy_eval_plain_rollout)):
        step = build(env, params, MR_T, mode="regen", as_carry=True, regen_chunk=MR_CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(key(300, device=dev), carry)
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t0)
    bad = _same_carry_and_metrics(out["kernel"][0], out["twin"][0])
    m = out["kernel"][0][1]
    print(f"phase 11c: policy-eval chunked-regen step, dyadic weights, B={MR_B} T={MR_T} chunk {MR_CHUNK}: "
          f"kernels {out['kernel'][1]:.4f} s, twin {out['twin'][1]:.4f} s; episodes {int(m.episodes)}, "
          f"reset_overlaps {int(m.reset_overlaps)}; differing: {bad or 'none'} [{card}]", flush=True)
    if bad or int(m.episodes) < MR_B or int(m.reset_overlaps) == 0:
        raise RuntimeError(f"phase 11c failed: differing {bad}, episodes {int(m.episodes)}, "
                           f"reset_overlaps {int(m.reset_overlaps)}")

    # (d) B2 at 25x25 on random packed states runs in phase 5
    # (POLICY_CHECK_CONFIGS). (e) B1 <kHookNone, kCtl> and B2 with kCtl where
    # lanes end two episodes in a chunk: N2-S4, max_steps cut, both steps
    # through the kernels and through the plain versions.
    cut = make(MR_CUT_ID)
    cut = dataclasses.replace(cut, config=dataclasses.replace(cut.config, max_steps=MR_CUT_MAX_STEPS))
    carry = fr.packed_init(cut, cut.reset_batch(key(3, device=dev), MR_CUT_B)[0], "regen")
    for path, builds, source in (
        ("random", (fr.build_fused_rollout, fr.build_packed_plain_rollout), None),
        ("policy", (pr.build_policy_eval_rollout, pr.build_policy_eval_plain_rollout), "key"),
    ):
        res = []
        for build in builds:
            args = (cut, MR_CUT_T) if path == "random" else (cut, params, MR_CUT_T)
            step = build(*args, mode="regen", as_carry=True, regen_chunk=MR_CUT_CHUNK)
            src = torch.Generator(device=dev).manual_seed(5) if source is None else key(5, device=dev)
            res.append(step(src, carry))
        bad = _same_carry_and_metrics(*res)
        m = res[0][1]
        print(f"phase 11e: {path}, {MR_CUT_ID} max_steps {MR_CUT_MAX_STEPS} chunk {MR_CUT_CHUNK} B={MR_CUT_B} "
              f"T={MR_CUT_T}: episodes {int(m.episodes)}, reset_overlaps {int(m.reset_overlaps)}; differing: "
              f"{bad or 'none'}", flush=True)
        if bad or int(m.reset_overlaps) == 0:
            raise RuntimeError(f"phase 11e failed on the {path} path: differing {bad}, "
                               f"reset_overlaps {int(m.reset_overlaps)}")

    # The kernels alone under the commit rows, one 96-step pass of the main
    # path's shape from phase 10's carries: B1 hookless, B2 at BT = 64 under
    # dyadic weights; each against its plain version, byte for byte.
    cfg = env.config
    v = cfg.agent_view_size
    ctl = torch.zeros((3, MR_B), dtype=torch.int32, device=dev)
    w = rand[0][0]
    actions = torch.randint(0, 7, (MR_CHUNK, MR_B), dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(12))
    args = (w.words, w.regs, w.tmpl_words, w.tmpl_regs, actions, cfg)
    fr.run_rollout_kernel(*args, ctl=ctl)  # warm
    b1_ms, got = time_events(lambda: fr.run_rollout_kernel(*args, ctl=ctl), MR_TIMED)
    b1_plain_ms, want = time_events(lambda: fr.plain_rollout(*args, ctl=ctl), 1)
    counts, b1_err = compare(got[:5], want[:5])
    counts["ctl"] = int((got[5] != want[5]).sum())
    b1_bnd = b1_bound(cfg, MR_B, MR_CHUNK, dev)
    print(f"phase 11: rollout kernel with the control rows, {MR_ENV_ID} B={MR_B} T={MR_CHUNK}: {b1_ms:.6f} "
          f"ms/call (mean of {MR_TIMED}), plain {b1_plain_ms:.4f} ms, mismatches {counts}; bound {b1_bnd} "
          f"({rollout_instr(cfg, True)} instructions per lane-step) [{card}]; {b1_plan(cfg, MR_B, MR_CHUNK)}",
          flush=True)
    if any(counts.values()):
        raise RuntimeError("phase 11: the rollout kernel with the control rows differs from its plain version")

    p = policy[0][0]
    weights = pr.eval_weights_from_params(params, v, device=dev)
    seeds = pr._seeds_for(key(301, device=dev), MR_CHUNK, MR_B)
    args = (p.words, p.regs, p.tmpl_words, p.tmpl_regs, seeds, weights, cfg)
    pr.run_policy_kernel(*args, ctl=ctl)  # warm
    b2_ms, got = time_events(lambda: pr.run_policy_kernel(*args, ctl=ctl), MR_TIMED)
    b2_plain_ms, want = time_events(lambda: pr.plain_policy_rollout(*args, ctl=ctl), 1)
    counts, b2_err = compare(got[:5], want[:5])
    counts["ctl"] = int((got[5] != want[5]).sum())
    b2_bnd = b2_bound(cfg, MR_B, MR_CHUNK, collect=False)
    print(f"phase 11: policy kernel with the control rows, BT={pr.policy_lane_block(cfg)}, {MR_ENV_ID} B={MR_B} "
          f"T={MR_CHUNK}, dyadic weights: {b2_ms:.6f} ms/call (mean of {MR_TIMED}), twin {b2_plain_ms:.4f} ms, "
          f"mismatches {counts}; bound {b2_bnd} [{card}]", flush=True)
    if any(counts.values()):
        raise RuntimeError("phase 11: the policy kernel with the control rows differs from its twin")
    return chain, (b1_err, b1_ms, b1_plain_ms, b1_bnd), (b2_err, b2_ms, b2_plain_ms, b2_bnd)


def _mark_window(tag, call, n_timed, dev, path_kernels, phase="12"):
    """One warm-up `call(0, mark)`, then `n_timed` timed calls `call(i,
    mark)` with every count set to 0 just before them and a CUDA event at
    each of their marks. Returns (the timed calls' results, the counts,
    seconds, ms per call of each marked piece, peak memory); raises unless
    the calls launched every kernel of `path_kernels` and no other."""
    import torch

    call(0, _no_mark)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(piece):
        events.append((piece, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    _zero_counts()
    t0 = time.perf_counter()
    events[0][1].record()
    out = [call(i, mark) for i in range(1, n_timed + 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    pieces = {}
    for (_, a), (piece, b) in zip(events, events[1:]):
        pieces[piece] = pieces.get(piece, 0.0) + a.elapsed_time(b) / n_timed
    peak = torch.cuda.max_memory_allocated(dev)
    kernels = {n: c for n, c in counts.items() if n.endswith("_kernel")}
    if any(kernels[n] == 0 for n in path_kernels) or any(c for n, c in kernels.items() if n not in path_kernels):
        raise RuntimeError(f"phase {phase}{tag}: launches {kernels}; the path runs {path_kernels} and no other kernel")
    return out, counts, seconds, pieces, peak


def _no_mark(_piece):
    pass


def phase_regen_policy_main_path(dev, card):
    """The slice's main path at full width, B = 32,768: (a) KeyCorridorS6R3
    policy evaluation and (b) the fused train step, both regen at T=256,
    chunk 32; (c) the fused train step on MultiRoom-N4-S5 regen at T=288,
    chunk 96. Returns the carries each timed window started from, and
    each window's env-steps/s (`out["rates"]`)."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import chunked_regen as cr
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr

    out = {}
    kc = make(KC_ENV_ID)
    kc_carry0 = fr.packed_init(kc, kc.reset_batch(key(0, device=dev), RT_B)[0], "regen")
    model = ActorCritic(kc.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    eval_step = pr.build_policy_eval_rollout(kc, model, RT_KC_T, mode="regen", as_carry=True,
                                             regen_chunk=RT_KC_CHUNK)
    state = {"carry": kc_carry0, "befores": []}

    def eval_call(i, mark):
        state["befores"].append(state["carry"])
        state["carry"], m = eval_step(key(400 + i, device=dev), state["carry"], mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("a", eval_call, RT_KC_TIMED, dev,
                                                      ("policy_kernel", "connect_kernel"))
    _report_window("a", f"{KC_ENV_ID} policy evaluation", res, counts, seconds, pieces, peak, RT_KC_T, card)
    if sum(int(m.episodes) for m in res) < RT_B:
        raise RuntimeError("phase 12a: the window held no mass reset")
    out["kc_eval"] = (state["befores"][1:], res, counts)
    out["rates"] = {"a": RT_B * RT_KC_T * RT_KC_TIMED / seconds}

    for tag, env_id, t, chunk, n_timed, kernels in (
        ("b", KC_ENV_ID, RT_KC_T, RT_KC_CHUNK, RT_KC_TIMED, ("policy_kernel", "grad_kernel", "connect_kernel")),
        ("c", MR_ENV_ID, RT_MR_T, RT_MR_CHUNK, RT_MR_TIMED, ("policy_kernel", "grad_kernel", "mr_chain_kernel")),
    ):
        env = make(env_id)
        carry0 = fr.packed_init(env, env.reset_batch(key(0, device=dev), RT_B)[0], "regen")
        ts0 = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
        step = tr.build_fused_train_step(env, t, mode="regen", regen_chunk=chunk)
        p0 = tr.flatten_params(ts0.params.flax_params())
        state = {"ts": ts0, "carry": carry0, "befores": [], "lanes": []}

        def train_call(i, mark, step=step, state=state):
            state["befores"].append((state["ts"], state["carry"]))
            lanes = cr.reentry_lanes
            state["ts"], state["carry"], m = step(state["ts"], state["carry"], key(500 + i, device=dev), mark=mark)
            state["lanes"].append(cr.reentry_lanes - lanes)
            return m

        res, counts, seconds, pieces, peak = _mark_window(tag, train_call, n_timed, dev, kernels)
        losses = [float(m["loss"]) for m in res]
        moved = float((tr.flatten_params(state["ts"].params.flax_params()) - p0).abs().max())
        overlaps = sum(state["lanes"][1:])
        rate = RT_B * t * n_timed / seconds
        print(f"phase 12{tag}: {env_id} fused train step, regen B={RT_B} T={t} chunk {chunk}: {n_timed} train steps "
              f"{seconds:.4f} s, {rate:.6e} env-steps/s; loss per step {losses}; episodes "
              f"{[float(m['episodes']) for m in res]}; reset_overlaps {overlaps}; params moved by up to "
              f"{moved:.6e}; per step {_per_call(counts, n_timed)}; pieces ms per step "
              f"{ {k: round(v, 4) for k, v in pieces.items()} }; peak memory {peak} B ({peak / 2**30:.3f} GiB) "
              f"[{card}]", flush=True)
        if not all(map(math.isfinite, losses)) or not moved > 0:
            raise RuntimeError(f"phase 12{tag}: loss {losses}, params moved by {moved}")
        if any(int(m["env_steps"]) != RT_B * t for m in res):
            raise RuntimeError(f"phase 12{tag}: env_steps != B*T")
        if env_id == MR_ENV_ID and (overlaps == 0 or counts["reentry_passes"] == 0):
            raise RuntimeError(f"phase 12{tag}: no deferred reset or re-entry: {overlaps}, {counts}")
        out[f"train_{tag}"] = (env, state["befores"], res, counts)
        out["rates"][tag] = rate
    return kc, model, out


def _per_call(counts, n):
    return {k: v / n for k, v in counts.items() if v}


def _report_window(tag, what, metrics, counts, seconds, pieces, peak, t, card, b=RT_B, phase="12", mode="regen"):
    totals = {n: sum(int(getattr(m, n)) for m in metrics) for n in ("episodes", "obs_checksum", "reset_overlaps")}
    n = len(metrics)
    print(f"phase {phase}{tag}: {what}, {mode} B={b} T={t}: {n} step calls {seconds:.4f} s, "
          f"{b * t * n / seconds:.6e} env-steps/s; episodes {totals['episodes']}, reset_overlaps "
          f"{totals['reset_overlaps']}, reward {sum(float(m.total_reward) for m in metrics):.6f}; per call "
          f"{_per_call(counts, n)}; pieces ms per call { {k: round(v, 4) for k, v in pieces.items()} }; peak memory "
          f"{peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    if any(int(m.total_steps) != b * t for m in metrics) or totals["obs_checksum"] == 0:
        raise RuntimeError(f"phase {phase}{tag}: total_steps != B*T or a zero checksum")
    if totals["reset_overlaps"] != counts["reentry_lanes"]:
        raise RuntimeError(f"phase {phase}{tag}: reset_overlaps {totals['reset_overlaps']} != re-entry lanes "
                           f"{counts['reentry_lanes']}")
    return totals


def _hooked_case(cfg, b, seed, hook):
    """Random packed states whose aux rows name a pickup target when `hook`."""
    import numpy as np

    from minigrid_tpu_torch.core import constants as C
    from minigrid_tpu_torch.ops.packing import R_AUX
    from minigrid_tpu_torch.testing import random_packed_case

    case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    if hook:
        rng = np.random.default_rng(seed + 1)
        for regs in (case["regs"], case["tmpl_regs"]):
            regs[R_AUX] = rng.choice([C.KEY, C.BALL, C.BOX], size=b)
            regs[R_AUX + 1] = rng.integers(0, 6, size=b)
    return case


def _policy_mismatches(got, want, ctl_in):
    """{output: differing entries} of two policy-kernel results; f32 as
    bits; under `ctl_in` the spill only on each lane's committed rows."""
    import torch

    bad = {}
    for name, g, w in zip(("words", "regs", "rsum", "episodes", "checksum"), got[:5], want[:5]):
        bad[name] = int((g.view(torch.int32) != w.view(torch.int32)).sum())
    if ctl_in is not None:
        bad["ctl"] = int((got[-1] != want[-1]).sum())
    if len(got) > 5 + (ctl_in is not None):
        t, b = got[5][1].shape
        mask = torch.ones((t, b), dtype=torch.bool, device=got[0].device)
        if ctl_in is not None:
            mask = torch.arange(t, device=mask.device)[:, None] < (want[-1][1] - ctl_in[1])[None, :]
        for k, (g, w) in enumerate(zip(got[5], want[5])):
            m = mask if g.ndim == 2 else mask[:, None, :]
            bad[f"traj{k}"] = int(((g.view(torch.int32) != w.view(torch.int32)) & m).sum())
    return {k: v for k, v in bad.items() if v}


def _same_train_runs(got, want):
    """Names of carry leaves, metrics and trajectory arrays that differ."""
    import torch

    (cg, tg, mg), (cw, tw, mw) = got, want
    bad = _same_carry_and_metrics((cg, mg), (cw, mw))
    bad += [f"traj{k}" for k, (a, b) in enumerate(zip(tg, tw)) if not torch.equal(a.view(torch.int32),
                                                                                  b.view(torch.int32))]
    return bad


def phase_regen_policy_vs_plain(dev, card, kc, model, runs):
    """The slice's kernels against their plain versions, TF32 off, under
    dyadic weights, byte for byte (reward sums bit for bit)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.testing import dyadic_flax_params, plant_pickup_target
    from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    params = dyadic_flax_params(9)
    max_err = 0.0
    # (a) Each new instantiation of B2 on random packed states and commit rows.
    for w_, h_, hook in RT_CHECK_CONFIGS:
        cfg = dc.replace(make(ENV_ID).config, width=w_, height=h_, max_steps=12)
        case = _hooked_case(cfg, CHECK_B, 31, hook)
        args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
        rng = np.random.default_rng(32)
        seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (CHECK_T, CHECK_B)).astype(np.int32)).to(dev)
        ctl = torch.from_numpy(np.stack([rng.integers(0, 2, CHECK_B), rng.integers(0, CHECK_T + 1, CHECK_B),
                                         rng.random(CHECK_B) < 0.1]).astype(np.int32)).to(dev)
        for collect in (False, True):
            weights = (pr.train_weights_from_params if collect else pr.eval_weights_from_params)(params, 7, device=dev)
            for ctl_in in (None, ctl):
                if not hook and not (collect and ctl_in is not None):
                    continue  # the hookless instantiations without both flags are checked in phases 5, 7, 11
                kw = dict(collect=collect, ctl=ctl_in, transition="pickup_target" if hook else "base")
                got = pr.run_policy_kernel(*args, seeds, weights, cfg, **kw)
                want = pr.plain_policy_rollout(*args, seeds, weights, cfg, **kw)
                bad = _policy_mismatches(got, want, ctl_in)
                max_err = max(max_err, float((got[2] - want[2]).abs().max()))
                print(f"phase 13a: policy kernel {w_}x{h_} hook={hook} collect={collect} ctl={ctl_in is not None}, "
                      f"BT={pr.policy_lane_block(cfg)}, B={CHECK_B} T={CHECK_T}, dyadic weights: episodes "
                      f"{int(want[3].sum())}, reward {float(want[2].sum()):.4f}; mismatches {bad or 'none'}",
                      flush=True)
                if bad:
                    raise RuntimeError(f"phase 13a failed at {w_}x{h_} hook={hook} collect={collect}: {bad}")

    # (b) The whole chunked-regen train rollout, merged trajectory included,
    # from phase 12's carries whose call deferred the most resets.
    tw = pr.train_weights_from_params(params, 7, device=dev)
    for tag, env_id, t, chunk in (("b", KC_ENV_ID, RT_KC_T, RT_KC_CHUNK), ("c", MR_ENV_ID, RT_MR_T, RT_MR_CHUNK)):
        env, befores, _, _ = runs[f"train_{tag}"]
        carry = befores[-1][1]
        res, secs = {}, {}
        for name, build in (("kernel", pr.build_fused_train_rollout), ("plain", pr.build_fused_train_plain_rollout)):
            roll = build(env, t, mode="regen", regen_chunk=chunk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = roll(tw, key(600, device=dev), carry)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        bad = _same_train_runs(res["kernel"], res["plain"])
        m = res["kernel"][2]
        print(f"phase 13b: {env_id} train rollout, regen B={RT_B} T={t} chunk {chunk}, dyadic weights: kernels "
              f"{secs['kernel']:.4f} s, plain {secs['plain']:.4f} s; episodes {int(m.episodes)}, reset_overlaps "
              f"{int(m.reset_overlaps)}; differing: {bad or 'none'} [{card}]", flush=True)
        if bad or int(m.episodes) == 0:
            raise RuntimeError(f"phase 13b failed on {env_id}: {bad}, episodes {int(m.episodes)}")
        if env_id == MR_ENV_ID and int(m.reset_overlaps) == 0:
            raise RuntimeError("phase 13b: no deferred reset at MultiRoom")

    # (c) Deferred resets everywhere: MultiRoom-N2-S4 with max_steps 3, and
    # KeyCorridorS3R1 on planted pickup targets with max_steps 5 (eval and
    # train rollouts), chunk 8; (d) KeyCorridor in cached mode.
    ew = params
    cases = [("c", MR_CUT_ID, MR_CUT_MAX_STEPS, "regen", False), ("c", KC_CHECK_IDS[0], 5, "regen", True),
             ("d", KC_CHECK_IDS[0], None, "cached", True), ("d", KC_ENV_ID, None, "cached", True)]
    for tag, env_id, max_steps, mode, planted in cases:
        env = make(env_id)
        if max_steps is not None:
            env = dc.replace(env, config=dc.replace(env.config, max_steps=max_steps))
        states, _ = env.reset_batch(key(7, device=dev), MR_CUT_B)
        if planted:
            states = state_from_numpy(plant_pickup_target(state_to_numpy(states)), device=dev)
        carry = fr.packed_init(env, states, mode)
        for surface in ("eval", "train"):
            if surface == "eval":
                builds = (pr.build_policy_eval_rollout, pr.build_policy_eval_plain_rollout)
                outs = [b(env, ew, MR_CUT_T, mode=mode, as_carry=True, regen_chunk=MR_CUT_CHUNK)(key(8, device=dev),
                                                                                              carry)
                        for b in builds]
                bad = _same_carry_and_metrics(*outs)
                m = outs[0][1]
            else:
                builds = (pr.build_fused_train_rollout, pr.build_fused_train_plain_rollout)
                outs = [b(env, MR_CUT_T, mode=mode, regen_chunk=MR_CUT_CHUNK)(tw, key(8, device=dev), carry)
                        for b in builds]
                bad = _same_train_runs(*outs)
                m = outs[0][2]
            print(f"phase 13{tag}: {env_id} {mode} max_steps {env.config.max_steps} {surface}, chunk {MR_CUT_CHUNK} "
                  f"B={MR_CUT_B} T={MR_CUT_T}: episodes {int(m.episodes)}, reward {float(m.total_reward):.4f}, "
                  f"reset_overlaps {int(m.reset_overlaps)}; differing: {bad or 'none'}", flush=True)
            if bad or int(m.episodes) == 0 or (mode == "regen" and int(m.reset_overlaps) == 0):
                raise RuntimeError(f"phase 13{tag} failed on {env_id} {mode} {surface}: {bad}")
            if planted and float(m.total_reward) == 0:
                raise RuntimeError(f"phase 13{tag}: the hook's successes did not fire on {env_id}")

    # The new instantiations alone at the main path's shapes, timed: B2
    # with the hook under the control rows (KeyCorridorS6R3, 16x16, BT =
    # 128, one 32-step pass; eval and collect) and collecting under the
    # control rows without a hook (MultiRoom-N4-S5, 25x25, BT = 64, one
    # 96-step pass), from phase 12's carries, against the twin.
    timed = {}
    for name, (env_id, carry, t, collect, hook) in {
        "hook_ctl": (KC_ENV_ID, runs["kc_eval"][0][0], RT_KC_CHUNK, False, True),
        "hook_collect_ctl": (KC_ENV_ID, runs["train_b"][1][0][1], RT_KC_CHUNK, True, True),
        "collect_ctl": (MR_ENV_ID, runs["train_c"][1][0][1], RT_MR_CHUNK, True, False),
    }.items():
        cfg = make(env_id).config
        v = cfg.agent_view_size
        weights = tw if collect else pr.eval_weights_from_params(params, v, device=dev)
        seeds = pr._seeds_for(key(700, device=dev), t, RT_B)
        ctl = torch.zeros((3, RT_B), dtype=torch.int32, device=dev)
        args = (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, seeds, weights, cfg)
        kw = dict(collect=collect, ctl=ctl, transition="pickup_target" if hook else "base")
        pr.run_policy_kernel(*args, **kw)  # warm
        ms, got = time_events(lambda: pr.run_policy_kernel(*args, **kw), RT_TIMED_KERNEL)
        plain_ms, want = time_events(lambda: pr.plain_policy_rollout(*args, **kw), 1)
        bad = _policy_mismatches(got, want, ctl)
        err = float((got[2] - want[2]).abs().max())
        bnd = b2_bound(cfg, RT_B, t, collect)
        print(f"phase 13: policy kernel {name}, BT={pr.policy_lane_block(cfg)}, {env_id} B={RT_B} T={t}, dyadic "
              f"weights: {ms:.6f} ms/call (mean of {RT_TIMED_KERNEL}), twin {plain_ms:.4f} ms, mismatches "
              f"{bad or 'none'}; bound {bnd} [{card}]", flush=True)
        if bad:
            raise RuntimeError(f"phase 13: the policy kernel ({name}) differs from its twin: {bad}")
        timed[name] = (max(err, max_err), ms, plain_ms, bnd)
    return timed


def phase_mosaic_probe(dev, card):
    """The Mosaic probe: each variant's kernel against `plain_probe` (bit
    for bit under dyadic inputs, within `NORMAL_REL_TOL` of the largest
    |acc| under the probe's normal draws), two runs bit for bit, and the
    cross-variant table, timed with CUDA events."""
    from minigrid_tpu_torch.tools import probe_mosaic as pm

    _zero_counts()
    rows = pm.table(dev, reps=PROBE_MOSAIC_REPS)
    launches = pm.probe_kernel_launches
    # Bytes: obs, g, the four weights in, the accumulator out; operations
    # per lane: layer 1 by its 3 V*V active rows, layer 2, and dh.h1^T.
    nbytes = 4 * pm.STEPS * pm.V2 * pm.BT + 4 * pm.H * pm.BT + 2 * (pm.H * pm.F + pm.H * pm.H + 2 * pm.H) + 4 * pm.H * pm.H
    ops = pm.STEPS * pm.BT * (3 * pm.V2 * pm.H + 2 * pm.H * pm.H + 2 * pm.H * pm.H)
    bnd = bound(nbytes, ops, BF16_FLOP_PER_S)
    base = rows["base_where"]
    print(f"phase 14: Mosaic probe kernel, {len(rows)} variants, {launches} launches; base_where {base['ms']:.6f} "
          f"ms/call through its wrapper (the previous design: {PREVIOUS_MOSAIC_BASE_WHERE_MS} ms), device time "
          f"of its kernels {base['device_ms']} ms, of the whole call {base['call_device_ms']} ms; plain "
          f"{base['plain_ms']:.6f} ms; "
          f"bound {bnd} [{card}]", flush=True)
    err = max(r["max_abs_err"] for r in rows.values())
    return launches, err, base["ms"], base["plain_ms"], bnd


def _slice_carry(carry, n):
    """The first `n` lanes of a `PackedCarry`."""
    from minigrid_tpu_torch.ops.fused_rollout import PackedCarry

    return PackedCarry(carry.words[:, :n].contiguous(), carry.regs[:, :n].contiguous(),
                       carry.tmpl_words[:, :n].contiguous(), carry.tmpl_regs[:, :n].contiguous(),
                       carry.rng[:n].contiguous())


def _time_pass(name, cfg, carry, t, dev, card, transition, surface, weights=None, reps=RT_TIMED_KERNEL, seed=0,
               ctl=True, repeats=1):
    """One chunk pass of `t` steps from `carry`, under fresh commit rows if
    `ctl` (regen's chunk passes) or none (cached mode's calls): the kernel
    (warm, then timed, mean of `reps`; with `repeats` > 1 the median of that
    many such means) and its plain version (timed once), compared byte for
    byte. Returns (max_abs_err, ms, plain_ms, bound)."""
    import torch

    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr

    b = carry.words.shape[1]
    ctl_rows = torch.zeros((3, b), dtype=torch.int32, device=dev) if ctl else None
    args = (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs)
    g = torch.Generator(device=dev).manual_seed(seed)
    if surface == "random":
        stream = torch.randint(0, 7, (t, b), dtype=torch.int32, device=dev, generator=g)
        kernel = lambda: fr.run_rollout_kernel(*args, stream, cfg, transition=transition, ctl=ctl_rows)  # noqa: E731
        plain = lambda: fr.plain_rollout(*args, stream, cfg, transition=transition, ctl=ctl_rows)  # noqa: E731
        bnd = b1_bound(cfg, b, t, dev, ctl=ctl)
    else:
        collect = surface == "collect"
        stream = torch.randint(-(2**31), 2**31, (t, b), dtype=torch.int32, device=dev, generator=g)
        kw = dict(collect=collect, ctl=ctl_rows, transition=transition)
        kernel = lambda: pr.run_policy_kernel(*args, stream, weights, cfg, **kw)  # noqa: E731
        plain = lambda: pr.plain_policy_rollout(*args, stream, weights, cfg, **kw)  # noqa: E731
        bnd = b2_bound(cfg, b, t, collect, ctl=ctl, dev=dev)
    kernel()  # warm
    readings = [time_events(kernel, reps) for _ in range(repeats)]
    ms, got = statistics.median(r[0] for r in readings), readings[-1][1]
    plain_ms, want = time_events(plain, 1)
    bad = _policy_mismatches(got, want, ctl_rows)
    err = float((got[2] - want[2]).abs().max())
    spread = f"; the median of {', '.join(f'{r[0]:.6f}' for r in readings)}" if repeats > 1 else ""
    print(f"phase {name}: {surface} pass under {transition!r}, commit rows {ctl}, {cfg.width}x{cfg.height} B={b} "
          f"T={t}: kernel {ms:.6f} ms/call (mean of {reps}{spread}), plain {plain_ms:.4f} ms; episodes "
          f"{int(want[3].sum())}; mismatches {bad or 'none'}; bound {bnd} [{card}]"
          + (f"; {b1_plan(cfg, b, t)}" if surface == "random" else ""), flush=True)
    if bad:
        raise RuntimeError(f"phase {name}: the {surface} kernel under {transition!r} differs from its plain version")
    return err, ms, plain_ms, bnd


def phase_doorkey_main_path(dev, card):
    """DoorKey-8x8 on random layouts, chunked regen through the generic
    route (the batched `generate`, packed): (a) the random policy at B =
    262,144, T = 256, chunk 32; (b) the fused train step at B = 32,768, T =
    256, chunk 32 (B2 `<64, collect, ctl, no hook>`, B3). Each from
    `reset_batch(key(0))`, one warm-up and 3 timed calls with every count
    set to 0 just before them: the second timed call holds the every-lane
    truncation at step 640."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.parallel import train as tr

    env = make(DK_ENV_ID)
    out = {"env": env}
    carry0 = fr.packed_init(env, env.reset_batch(key(0, device=dev), DK_B)[0], "regen")
    step = fr.build_fused_rollout(env, DK_T, mode="regen", as_carry=True, regen_chunk=DK_CHUNK)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = {"carry": carry0, "befores": []}

    def rand_call(i, mark):
        state["befores"].append(state["carry"])
        state["carry"], m = step(gen, state["carry"], mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("a", rand_call, DK_TIMED, dev, ("rollout_kernel",), phase="15")
    totals = _report_window("a", f"{DK_ENV_ID} random policy, chunk {DK_CHUNK}", res, counts, seconds, pieces, peak,
                            DK_T, card, b=DK_B, phase="15")
    share = pieces.get("refresh", 0.0) / sum(pieces.values())
    print(f"phase 15a: the template refresh (the batched generate, packed) takes {share:.4f} of a call; "
          f"{counts['rollout_kernel']} rollout kernel launches [{card}]", flush=True)
    if totals["episodes"] < DK_B:
        raise RuntimeError("phase 15a: the window held no every-lane reset")
    out["rand"] = (state["befores"], res, counts, state["carry"])
    del carry0, state
    torch.cuda.empty_cache()

    carry0 = fr.packed_init(env, env.reset_batch(key(0, device=dev), DK_TRAIN_B)[0], "regen")
    ts0 = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    train = tr.build_fused_train_step(env, DK_TRAIN_T, mode="regen", regen_chunk=DK_CHUNK)
    p0 = tr.flatten_params(ts0.params.flax_params())
    state = {"ts": ts0, "carry": carry0, "befores": []}

    def train_call(i, mark):
        state["befores"].append((state["ts"], state["carry"]))
        state["ts"], state["carry"], m = train(state["ts"], state["carry"], key(800 + i, device=dev), mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("b", train_call, DK_TIMED, dev, ("policy_kernel", "grad_kernel"),
                                                      phase="15")
    losses = [float(m["loss"]) for m in res]
    moved = float((tr.flatten_params(state["ts"].params.flax_params()) - p0).abs().max())
    rate = DK_TRAIN_B * DK_TRAIN_T * DK_TIMED / seconds
    print(f"phase 15b: {DK_ENV_ID} fused train step, regen B={DK_TRAIN_B} T={DK_TRAIN_T} chunk {DK_CHUNK}: "
          f"{DK_TIMED} train steps {seconds:.4f} s, {rate:.6e} env-steps/s; loss per step {losses}; episodes "
          f"{[float(m['episodes']) for m in res]}; params moved by up to {moved:.6e}; per step "
          f"{_per_call(counts, DK_TIMED)}; pieces ms per step { {k: round(v, 4) for k, v in pieces.items()} }; "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    if not all(map(math.isfinite, losses)) or not moved > 0:
        raise RuntimeError(f"phase 15b: loss {losses}, params moved by {moved}")
    if any(int(m["env_steps"]) != DK_TRAIN_B * DK_TRAIN_T for m in res):
        raise RuntimeError("phase 15b: env_steps != B*T")
    if sum(float(m["episodes"]) for m in res) < DK_TRAIN_B:
        raise RuntimeError("phase 15b: the window held no every-lane reset")
    out["train"] = (state["befores"], res, counts)
    return out


def phase_doorkey_vs_plain(dev, card, runs):
    """The DoorKey path against its plain versions, TF32 off, dyadic
    weights, byte for byte (reward sums bit for bit), at B = 8,192: (c)
    from the carries whose call holds the every-lane reset, the random
    policy's chunked-regen step, policy evaluation and the collecting
    rollout with its merged trajectory; (d) the same three with
    `max_steps` cut to 5 and chunk 8 (deferred resets); (e)
    Empty-Random-6x6 regen, one call of each surface; then B2 `<64,
    collect, ctl, no hook>` alone, one 32-step pass at B = 32,768, and B1
    alone, one 32-step chunk pass at B = 262,144 from the random policy's
    last carry, each timed. Returns their (max_abs_err, ms, plain_ms,
    bound)."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    env = runs["env"]
    params = dyadic_flax_params(9)
    tw = pr.train_weights_from_params(params, 7, device=dev)

    def three_surfaces(tag, e, rand_carry, policy_carry, t, chunk, need_overlaps):
        outs = {}
        for surface, builds in (
            ("random", (fr.build_fused_rollout, fr.build_packed_plain_rollout)),
            ("eval", (pr.build_policy_eval_rollout, pr.build_policy_eval_plain_rollout)),
            ("collect", (pr.build_fused_train_rollout, pr.build_fused_train_plain_rollout)),
        ):
            res = []
            for build in builds:
                if surface == "random":
                    step = build(e, t, mode="regen", as_carry=True, regen_chunk=chunk)
                    res.append(step(torch.Generator(device=dev).manual_seed(3), rand_carry))
                elif surface == "eval":
                    step = build(e, params, t, mode="regen", as_carry=True, regen_chunk=chunk)
                    res.append(step(key(4, device=dev), policy_carry))
                else:
                    res.append(build(e, t, mode="regen", regen_chunk=chunk)(tw, key(5, device=dev), policy_carry))
            bad = _same_train_runs(*res) if surface == "collect" else _same_carry_and_metrics(*res)
            m = res[0][-1]
            print(f"phase 15{tag}: {e.env_id} max_steps {e.config.max_steps} {surface}, regen chunk {chunk} "
                  f"B={rand_carry.words.shape[1]} T={t}: episodes {int(m.episodes)}, reward "
                  f"{float(m.total_reward):.4f}, reset_overlaps {int(m.reset_overlaps)}; differing: {bad or 'none'}",
                  flush=True)
            if bad or int(m.episodes) == 0 or (need_overlaps and int(m.reset_overlaps) == 0):
                raise RuntimeError(f"phase 15{tag} failed on {e.env_id} {surface}: {bad}")
            outs[surface] = res
        return outs

    three_surfaces("c", env, _slice_carry(runs["rand"][0][2], DK_CHECK_B),
                   _slice_carry(runs["train"][0][2][1], DK_CHECK_B), DK_T, DK_CHUNK, False)
    cut = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=DK_CUT_MAX_STEPS))
    carry = fr.packed_init(cut, cut.reset_batch(key(6, device=dev), DK_CHECK_B)[0], "regen")
    three_surfaces("d", cut, carry, carry, DK_CUT_T, DK_CUT_CHUNK, True)
    er = make(ER_ENV_ID)
    carry = fr.packed_init(er, er.reset_batch(key(7, device=dev), DK_CHECK_B)[0], "regen")
    three_surfaces("e", er, carry, carry, CHECK_T, DK_CHUNK, False)

    # The new instantiation alone at the train step's shape, and B1 at the
    # random policy's.
    collect = _time_pass("15", env.config, runs["train"][0][1][1], DK_CHUNK, dev, card, "base", "collect", tw)
    rand = _time_pass("15", env.config, runs["rand"][3], DK_CHUNK, dev, card, "base", "random")
    return collect, rand


def _hook_fired(want, base):
    """True if the hooked plain run's reward sums or episode counts differ
    from the base step's."""
    import torch

    return not (torch.equal(want[2], base[2]) and torch.equal(want[3], base[3]))


def phase_hooks(dev, card):
    """The five family hooks. (a) Each family's main path at B = 32,768,
    regen, T = 64, chunk 32, from `reset_batch(key(0))`: a `_mark_window`
    of one warm-up and one timed call of the random policy, then one of
    policy evaluation (the seeded `ActorCritic`); then
    from that warm carry one 32-step pass of B1, B2 eval and B2 collect
    under fresh commit rows against their plain versions (B1 and B2 eval
    timed). (b) On `testing.hooked_packed_case` states, B = 8,192, T =
    64: B1 with and without commit rows under actions whose first is the
    one that fires the hook, and B2 in eval and collect mode with and
    without them (RedBlueDoors at 6x6 too, in 64-lane blocks), against
    their plain versions; each hook must change the plain outcome against
    the base step. (c) Timed: Fetch-5x5-N2 cached random policy at B =
    262,144, T = 256, and RedBlueDoors-8x8 regen policy evaluation at B =
    32,768, T = 256, chunk 32, each one warm-up and 3 timed calls; then
    the Fetch window's kernel alone, one call's pass from its last carry
    (no commit rows), against its plain version. Returns `{row: {"rollout"
    or "policy": [launches, max_abs_err, ms, plain_ms, bound]}}`, one row
    per hook and `fetch_cached` for Fetch's timed window."""
    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.testing import dyadic_flax_params, hooked_packed_case

    params = dyadic_flax_params(11)
    rows = {}
    for transition, (env_id, fire) in HOOK_FAMILIES.items():
        env = make(env_id)
        cfg = env.config
        model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), HK_B)[0], "regen")}
        launches = {}
        for surface in ("random", "eval"):
            if surface == "random":
                step = fr.build_fused_rollout(env, HK_T, mode="regen", as_carry=True, regen_chunk=HK_CHUNK)
                source = torch.Generator(device=dev).manual_seed(2)
            else:
                step = pr.build_policy_eval_rollout(env, model, HK_T, mode="regen", as_carry=True,
                                                    regen_chunk=HK_CHUNK)
                source = key(3, device=dev)

            def call(i, mark, step=step, source=source):
                state["carry"], m = step(source, state["carry"], mark=mark)
                return m

            kernel = {"random": "rollout_kernel", "eval": "policy_kernel"}[surface]
            res, counts, seconds, pieces, peak = _mark_window("a", call, 1, dev, (kernel,), phase="16")
            _report_window("a", f"{env_id} {surface}, chunk {HK_CHUNK}", res, counts, seconds, pieces, peak, HK_T,
                           card, b=HK_B, phase="16")
            launches[surface] = counts[kernel]
        carry = state.pop("carry")
        ew = pr.eval_weights_from_params(params, cfg.agent_view_size, device=dev)
        tw = pr.train_weights_from_params(params, cfg.agent_view_size, device=dev)
        b1 = _time_pass("16a", cfg, carry, HK_CHUNK, dev, card, transition, "random")
        b2 = _time_pass("16a", cfg, carry, HK_CHUNK, dev, card, transition, "eval", ew)
        b2c = _time_pass("16a", cfg, carry, HK_CHUNK, dev, card, transition, "collect", tw, reps=1)
        rows[transition] = {"rollout": [launches["random"], b1[0], b1[1], b1[2], b1[3]],
                            "policy": [launches["eval"], max(b2[0], b2c[0]), b2[1], b2[2], b2[3]]}
        del carry, step, state
        torch.cuda.empty_cache()

        # (b) Planted events on random packed states.
        grids = [env_id] + (["MiniGrid-RedBlueDoors-6x6-v0"] if transition == "redbluedoors" else [])
        for grid_id in grids:
            gcfg = dataclasses.replace(make(grid_id).config, max_steps=12)
            case = hooked_packed_case(41, transition, gcfg.width, gcfg.height, CHECK_B, gcfg.max_steps)
            args = [torch.from_numpy(case[k]).to(dev) for k in ("words", "regs", "tmpl_words", "tmpl_regs")]
            rng = np.random.default_rng(42)
            actions = rng.integers(0, 7, (CHECK_T, CHECK_B)).astype(np.int32)
            actions[0] = fire
            actions = torch.from_numpy(actions).to(dev)
            seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (CHECK_T, CHECK_B)).astype(np.int32)).to(dev)
            ctl = torch.from_numpy(np.stack([rng.integers(0, 2, CHECK_B), rng.integers(0, CHECK_T + 1, CHECK_B),
                                             rng.random(CHECK_B) < 0.1]).astype(np.int32)).to(dev)
            ctl[:, : CHECK_B // 2] = 0
            runs = []
            if grid_id == env_id:
                runs += [("random", None, ctl_in) for ctl_in in (None, ctl)]
            runs += [(s, w, ctl_in) for s, w in (("eval", ew), ("collect", tw)) for ctl_in in (None, ctl)]
            for surface, weights, ctl_in in runs:
                if surface == "random":
                    def run(fn, tr_):
                        return fn(*args, actions, gcfg, transition=tr_, ctl=ctl_in)
                    fns = (fr.run_rollout_kernel, fr.plain_rollout)
                else:
                    kw = dict(collect=surface == "collect", ctl=ctl_in)

                    def run(fn, tr_, kw=kw, weights=weights):
                        return fn(*args, seeds, weights, gcfg, transition=tr_, **kw)
                    fns = (pr.run_policy_kernel, pr.plain_policy_rollout)
                got, want, base = run(fns[0], transition), run(fns[1], transition), run(fns[1], "base")
                bad = _policy_mismatches(got, want, ctl_in)
                err = float((got[2] - want[2]).abs().max())
                key_ = "rollout" if surface == "random" else "policy"
                rows[transition][key_][1] = max(rows[transition][key_][1], err)
                fired = _hook_fired(want, base)
                print(f"phase 16b: {transition} {surface} {gcfg.width}x{gcfg.height} ctl={ctl_in is not None} "
                      f"B={CHECK_B} T={CHECK_T}: episodes {int(want[3].sum())} (base step {int(base[3].sum())}), "
                      f"reward {float(want[2].sum()):.4f} (base step {float(base[2].sum()):.4f}); mismatches "
                      f"{bad or 'none'}", flush=True)
                if bad or not fired:
                    raise RuntimeError(f"phase 16b failed: {transition} {surface} ctl={ctl_in is not None}: {bad}, "
                                       f"hook fired {fired}")

    # (c) The timed windows.
    fetch = make(FETCH_TIMED_ID)
    state = {"carry": fr.packed_init(fetch, fetch.reset_batch(key(0, device=dev), FETCH_TIMED_B)[0], "cached")}
    step = fr.build_fused_rollout(fetch, FETCH_TIMED_T, mode="cached", as_carry=True)
    gen = torch.Generator(device=dev).manual_seed(5)

    def fetch_call(i, mark):
        state["carry"], m = step(gen, state["carry"])
        return m

    res, counts, seconds, pieces, peak = _mark_window("c", fetch_call, HK_TIMED, dev, ("rollout_kernel",), phase="16")
    _report_window("c", f"{FETCH_TIMED_ID} random policy", res, counts, seconds, pieces, peak, FETCH_TIMED_T, card,
                   b=FETCH_TIMED_B, phase="16", mode="cached")
    # The window's kernel alone at its own shape: one call's pass from its
    # last carry, without commit rows, against the plain version.
    err, ms, plain_ms, bnd = _time_pass("16c", fetch.config, state["carry"], FETCH_TIMED_T, dev, card, "fetch",
                                        "random", ctl=False)
    rows["fetch_cached"] = {"rollout": [counts["rollout_kernel"], err, ms, plain_ms, bnd]}
    del state, step
    torch.cuda.empty_cache()

    rbd = make(RBD_TIMED_ID)
    model = ActorCritic(rbd.config.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    state = {"carry": fr.packed_init(rbd, rbd.reset_batch(key(0, device=dev), HK_B)[0], "regen")}
    step = pr.build_policy_eval_rollout(rbd, model, RBD_TIMED_T, mode="regen", as_carry=True, regen_chunk=HK_CHUNK)

    def rbd_call(i, mark):
        state["carry"], m = step(key(900 + i, device=dev), state["carry"], mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("c", rbd_call, HK_TIMED, dev, ("policy_kernel",), phase="16")
    _report_window("c", f"{RBD_TIMED_ID} policy evaluation, chunk {HK_CHUNK}", res, counts, seconds, pieces, peak,
                   RBD_TIMED_T, card, b=HK_B, phase="16")
    rows["redbluedoors"]["policy"][0] += counts["policy_kernel"]
    return rows


def _grad_vs_plain(tag, cfg, weights, traj, card):
    """The gradient kernel on a collected trajectory against
    `plain_grad_pass`, within phase 7's bounds. Returns (max_abs_err, ms,
    plain_ms, bound)."""
    from minigrid_tpu_torch.parallel import train as tr

    obs_w, actions, _, value, reward, done = traj
    t, b = actions.shape
    ret = tr._trajectory_returns(reward, done, tr.GAMMA)
    args = (weights, obs_w, actions, ret - value, ret, cfg.num_actions, float(t * b), tr.VALUE_COEF,
            tr.ENTROPY_COEF)
    ms, plain_ms, rel, sums_rel, err, same, sums, _ = _grad_compare(args)
    bnd = grad_bound(cfg.agent_view_size, b, t)
    print(f"phase {tag}: grad kernel at {cfg.num_actions} actions, B={b} T={t}: {ms:.4f} ms/call, plain_grad_pass "
          f"{plain_ms:.4f} ms; rel-to-max error {rel}, loss sums rel {sums_rel:.3e}, max_abs_err {err}; two "
          f"launches bit-identical: {same}; bound {bnd} [{card}]", flush=True)
    if not _grad_within_bounds(rel, sums_rel, same, sums):
        raise RuntimeError(f"phase {tag} failed: the grad kernel is outside its bounds or does not repeat")
    return err, ms, plain_ms, bnd


def phase_new_hooks(dev, card):
    """Phase 17 (module docstring): the DynamicObstacles pre-hook, the
    Memory, Unlock and DynamicObstacles hooks and the remaps, each timed
    window's kernels held against their plain versions at the window's
    shape. Returns `{row name: [launches, max_abs_err, ms, plain_ms, bound,
    source]}`."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    rows = {}

    # (a) B1 with the pre-hook at its heaviest, cached.
    env = make(DO_CACHED_ID)
    state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), DO_CACHED_B)[0], "cached")}
    step = fr.build_fused_rollout(env, DO_CACHED_T, mode="cached", as_carry=True)
    gen = torch.Generator(device=dev).manual_seed(7)

    def cached_call(i, mark):
        state["carry"], m = step(gen, state["carry"])
        return m

    res, counts, seconds, pieces, peak = _mark_window("a", cached_call, NEW_TIMED, dev, ("rollout_kernel",), phase="17")
    totals = _report_window("a", f"{DO_CACHED_ID} random policy", res, counts, seconds, pieces, peak, DO_CACHED_T,
                            card, b=DO_CACHED_B, phase="17", mode="cached")
    if totals["episodes"] == 0:
        raise RuntimeError("phase 17a: no episode ended")
    err, ms, plain_ms, bnd = _time_pass("17a", env.config, state["carry"], NEW_CHUNK, dev, card, env.transition,
                                        "random", ctl=False)
    rows["rollout_kernel_prehook"] = [counts["rollout_kernel"], err, ms, plain_ms, bnd, KERNEL_SOURCE]
    del state, step
    torch.cuda.empty_cache()

    # (b) DynamicObstacles-8x8 regen: policy evaluation and the train step.
    env = make(DO_REGEN_ID)
    cfg = env.config
    carry0 = fr.packed_init(env, env.reset_batch(key(0, device=dev), NEW_B)[0], "regen")
    model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    eval_step = pr.build_policy_eval_rollout(env, model, NEW_T, mode="regen", as_carry=True, regen_chunk=NEW_CHUNK)
    state = {"carry": carry0}

    def eval_call(i, mark):
        state["carry"], m = eval_step(key(1000 + i, device=dev), state["carry"], mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("b", eval_call, NEW_TIMED, dev, ("policy_kernel",), phase="17")
    _report_window("b", f"{DO_REGEN_ID} policy evaluation, chunk {NEW_CHUNK}", res, counts, seconds, pieces, peak,
                   NEW_T, card, b=NEW_B, phase="17")
    eval_launches, eval_carry = counts["policy_kernel"], state["carry"]

    ts0 = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    train = tr.build_fused_train_step(env, NEW_T, mode="regen", regen_chunk=NEW_CHUNK)
    p0 = tr.flatten_params(ts0.params.flax_params())
    state = {"ts": ts0, "carry": carry0}

    def train_call(i, mark):
        state["ts"], state["carry"], m = train(state["ts"], state["carry"], key(1100 + i, device=dev), mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("b", train_call, NEW_TIMED, dev,
                                                      ("policy_kernel", "grad_kernel"), phase="17")
    losses = [float(m["loss"]) for m in res]
    moved = float((tr.flatten_params(state["ts"].params.flax_params()) - p0).abs().max())
    print(f"phase 17b: {DO_REGEN_ID} fused train step, regen B={NEW_B} T={NEW_T} chunk {NEW_CHUNK}, "
          f"{cfg.num_actions} actions: {NEW_TIMED} train steps {seconds:.4f} s, "
          f"{NEW_B * NEW_T * NEW_TIMED / seconds:.6e} env-steps/s; loss per step {losses}; episodes "
          f"{[float(m['episodes']) for m in res]}; params moved by up to {moved:.6e}; per step "
          f"{_per_call(counts, NEW_TIMED)}; pieces ms per step { {k: round(v, 4) for k, v in pieces.items()} }; "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    if not all(map(math.isfinite, losses)) or not moved > 0 or any(int(m["env_steps"]) != NEW_B * NEW_T for m in res):
        raise RuntimeError(f"phase 17b: loss {losses}, params moved by {moved}, or env_steps != B*T")
    params = dyadic_flax_params(12, num_actions=cfg.num_actions)
    ew = pr.eval_weights_from_params(params, cfg.agent_view_size, device=dev)
    tw = pr.train_weights_from_params(params, cfg.agent_view_size, device=dev)
    b2 = _time_pass("17b", cfg, eval_carry, NEW_CHUNK, dev, card, env.transition, "eval", ew)
    b2c = _time_pass("17b", cfg, state["carry"], NEW_CHUNK, dev, card, env.transition, "collect", tw, reps=1)
    rows["policy_kernel_dynamicobstacles"] = [eval_launches, b2[0], b2[1], b2[2], b2[3],
                                              POLICY_HOOK_SOURCES["dynamicobstacles"]]
    rows["policy_kernel_dynamicobstacles_collect"] = [counts["policy_kernel"], b2c[0], b2c[1], b2c[2], b2c[3],
                                                      POLICY_HOOK_SOURCES["dynamicobstacles"]]
    # B3 at 3 actions on a trajectory of the trained weights.
    weights = pr.train_weights_from_params(state["ts"].params, cfg.agent_view_size)
    roll = pr.build_fused_train_rollout(env, NEW_T, mode="regen", regen_chunk=NEW_CHUNK)
    _, traj, _ = roll(weights, key(1200, device=dev), state["carry"])
    b3 = _grad_vs_plain("17b", cfg, weights, traj, card)
    rows["grad_kernel_3_actions"] = [counts["grad_kernel"], b3[0], b3[1], b3[2], b3[3], GRAD_SOURCE]
    del state, eval_carry, carry0, traj, roll, train, eval_step
    torch.cuda.empty_cache()

    # (c) MemoryS17Random regen policy evaluation, 128-lane blocks.
    env = make(MEM_REGEN_ID)
    cfg = env.config
    model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    step = pr.build_policy_eval_rollout(env, model, NEW_T, mode="regen", as_carry=True, regen_chunk=NEW_CHUNK)
    state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), NEW_B)[0], "regen")}

    def mem_call(i, mark):
        state["carry"], m = step(key(1300 + i, device=dev), state["carry"], mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("c", mem_call, NEW_TIMED, dev, ("policy_kernel",), phase="17")
    _report_window("c", f"{MEM_REGEN_ID} policy evaluation, chunk {NEW_CHUNK}, {pr.policy_lane_block(cfg)}-lane "
                   "blocks", res, counts, seconds, pieces, peak, NEW_T, card, b=NEW_B, phase="17")
    ew = pr.eval_weights_from_params(dyadic_flax_params(13), cfg.agent_view_size, device=dev)
    b2 = _time_pass("17c", cfg, state["carry"], NEW_CHUNK, dev, card, env.transition, "eval", ew)
    rows["policy_kernel_memory"] = [counts["policy_kernel"], b2[0], b2[1], b2[2], b2[3], POLICY_HOOK_SOURCES["memory"]]
    del state, step
    torch.cuda.empty_cache()

    # (d) Each new family's regen main path under the random policy.
    for env_id in NEW_FAMILY_IDS:
        env = make(env_id)
        step = fr.build_fused_rollout(env, NEW_FAMILY_T, mode="regen", as_carry=True, regen_chunk=NEW_CHUNK)
        state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), NEW_B)[0], "regen")}
        gen = torch.Generator(device=dev).manual_seed(8)

        def family_call(i, mark, step=step, state=state, gen=gen):
            state["carry"], m = step(gen, state["carry"], mark=mark)
            return m

        res, counts, seconds, pieces, peak = _mark_window("d", family_call, 1, dev, ("rollout_kernel",), phase="17")
        _report_window("d", f"{env_id} random policy, chunk {NEW_CHUNK}", res, counts, seconds, pieces, peak,
                       NEW_FAMILY_T, card, b=NEW_B, phase="17")
        b1 = _time_pass("17d", env.config, state["carry"], NEW_CHUNK, dev, card, env.transition, "random")
        rows[f"rollout_kernel_{_row_name(env_id)}"] = [counts["rollout_kernel"], b1[0], b1[1], b1[2], b1[3],
                                                       KERNEL_SOURCE]
        del state, step
        torch.cuda.empty_cache()
    return rows


def _row_name(env_id: str) -> str:
    return env_id.removeprefix("MiniGrid-").removesuffix("-v0").lower().replace("-", "_")


def _same_mixed(got, want):
    """(mismatching fields, |total_reward| difference) of two mixed calls'
    `(carries, metrics)`: carries and integer metrics byte for byte."""
    import torch

    bad = [f"member {i} {name}" for i, (cg, cw) in enumerate(zip(got[0], want[0]))
           for name, g, w in zip(cg._fields, cg, cw) if not torch.equal(g, w)]
    bad += [n for n in ("episodes", "total_steps", "obs_checksum", "reset_overlaps")
            if not torch.equal(getattr(got[1], n), getattr(want[1], n))]
    return bad, abs(float(got[1].total_reward) - float(want[1].total_reward))


def _time_action_sources(cfg, dev, card):
    """The random policy's `(MIXED_T, MIXED_B)` action stream at `cfg`'s
    action count, drawn from a key (`prng.randint_stream`, the JAX
    package's actions) and from a `torch.Generator` (`torch.randint`):
    device ms a draw, mean of 3 after a warm-up."""
    import torch

    from minigrid_tpu_torch.core import prng
    from minigrid_tpu_torch.core.rollout import generator_policy

    src = prng.key(1990, device=dev)
    g = torch.Generator(device=dev).manual_seed(1990)
    by_key = lambda: prng.randint_stream(src, MIXED_T, MIXED_B, 0, cfg.num_actions)  # noqa: E731
    by_gen = lambda: generator_policy(cfg.num_actions)(g, MIXED_T, MIXED_B)  # noqa: E731
    by_key(), by_gen()
    key_ms, _ = time_events(by_key, 3)
    gen_ms, _ = time_events(by_gen, 3)
    print(f"phase 18c: the action stream, {cfg.num_actions} actions, T={MIXED_T} B={MIXED_B}: from a key "
          f"{key_ms:.6f} ms, from a torch.Generator {gen_ms:.6f} ms (mean of 3) [{card}]", flush=True)


def _mixed_window(tag, what, step, carries, dev, card, path_kernel):
    """One warm-up call, then `MIXED_TIMED` timed calls with every count set
    to 0 just before them, each timed alone (env-steps/s) and split into
    its members' shares by the step's marks, and each member's launches
    of `path_kernel` read at its mark. Returns (the warm carries, the
    counts, the launches a member over the timed calls)."""
    import torch

    from minigrid_tpu_torch.core.prng import key

    carries, _ = step(key(1900, device=dev), carries)  # warm-up
    torch.cuda.synchronize()
    warm = carries
    _zero_counts()
    member_launches = [0] * len(MIXED_IDS)
    for i in range(1, MIXED_TIMED + 1):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        seen = [_counts()[path_kernel]]

        def mark(piece):
            events.append((piece, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()
            if piece.startswith("member"):
                n = _counts()[path_kernel]
                member_launches[int(piece.split()[1])] += n - seen[0]
                seen[0] = n

        t0 = time.perf_counter()
        events[0][1].record()
        carries, m = step(key(1900 + i, device=dev), carries, mark=mark)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        members, pieces, member_ms = [], {}, 0.0
        for (_, a), (piece, e) in zip(events, events[1:]):
            ms = a.elapsed_time(e)
            member_ms += ms
            if piece.startswith("member"):
                members.append(round(member_ms, 4))
                member_ms = 0.0
            else:
                pieces[piece] = round(pieces.get(piece, 0.0) + ms, 4)
        b = MIXED_B * len(MIXED_IDS)
        print(f"phase 18c: {what}, call {i}: B={b} T={MIXED_T} {seconds:.4f} s, {b * MIXED_T / seconds:.6e} "
              f"env-steps/s; members ms {dict(zip(MIXED_IDS, members))}; pieces ms (both members) {pieces}; "
              f"episodes {int(m.episodes)}, reset_overlaps {int(m.reset_overlaps)}, reward "
              f"{float(m.total_reward):.6f} [{card}]", flush=True)
        if int(m.total_steps) != b * MIXED_T or int(m.obs_checksum) == 0 or int(m.episodes) == 0:
            raise RuntimeError(f"phase 18{tag}: total_steps != B*T, a zero checksum or no episode: {m}")
    counts = _counts()
    kernels = {n: c for n, c in counts.items() if n.endswith("_kernel")}
    if kernels[path_kernel] == 0 or any(c for n, c in kernels.items() if n != path_kernel):
        raise RuntimeError(f"phase 18{tag}: launches {kernels}; the path runs only the {path_kernel}")
    if sum(member_launches) != kernels[path_kernel] or 0 in member_launches:
        raise RuntimeError(f"phase 18{tag}: members' launches {member_launches} against {kernels[path_kernel]}")
    print(f"phase 18c: {what}: per call {_per_call(counts, MIXED_TIMED)}; {path_kernel} launches a member over "
          f"{MIXED_TIMED} calls {dict(zip(MIXED_IDS, member_launches))} [{card}]", flush=True)
    return warm, counts, member_launches


def phase_slice12(dev, card):
    """Phase 18 (module docstring): LavaGap, FourRooms, the Crossings,
    LockedRoom and Playground, and config 5's mixed batch. Returns `{row
    name: [launches, max_abs_err, ms, plain_ms, bound, source]}`."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.testing import dyadic_flax_params

    rows = {}

    # (a) Each id's regen main path under the random policy.
    for env_id in S12_IDS:
        env = make(env_id)
        step = fr.build_fused_rollout(env, S12_T, mode="regen", as_carry=True, regen_chunk=S12_CHUNK)
        state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), S12_B)[0], "regen")}

        def family_call(i, mark, step=step, state=state):
            state["carry"], m = step(key(1700 + i, device=dev), state["carry"], mark=mark)
            return m

        res, counts, seconds, pieces, peak = _mark_window("a", family_call, 1, dev, ("rollout_kernel",), phase="18")
        _report_window("a", f"{env_id} random policy, chunk {S12_CHUNK}", res, counts, seconds, pieces, peak, S12_T,
                       card, b=S12_B, phase="18")
        b1 = _time_pass("18a", env.config, state["carry"], S12_CHUNK, dev, card, env.transition, "random")
        rows[f"rollout_kernel_{_row_name(env_id)}"] = [counts["rollout_kernel"], b1[0], b1[1], b1[2], b1[3],
                                                       KERNEL_SOURCE]
        del state, step
        torch.cuda.empty_cache()

    # (b) Policy evaluation at 64- and 128-lane blocks.
    for env_id in S12_POLICY_IDS:
        env = make(env_id)
        cfg = env.config
        model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        step = pr.build_policy_eval_rollout(env, model, S12_T, mode="regen", as_carry=True, regen_chunk=S12_CHUNK)
        state = {"carry": fr.packed_init(env, env.reset_batch(key(0, device=dev), S12_B)[0], "regen")}

        def eval_call(i, mark, step=step, state=state):
            state["carry"], m = step(key(1750 + i, device=dev), state["carry"], mark=mark)
            return m

        res, counts, seconds, pieces, peak = _mark_window("b", eval_call, 1, dev, ("policy_kernel",), phase="18")
        bt = pr.policy_lane_block(cfg)
        _report_window("b", f"{env_id} policy evaluation, chunk {S12_CHUNK}, {bt}-lane blocks", res, counts, seconds,
                       pieces, peak, S12_T, card, b=S12_B, phase="18")
        ew = pr.eval_weights_from_params(dyadic_flax_params(14), cfg.agent_view_size, device=dev)
        b2 = _time_pass("18b", cfg, state["carry"], S12_T, dev, card, env.transition, "eval", ew)
        carry = state["carry"]
        args = (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs)
        seed_row = pr._seeds_for(key(1760, device=dev), 1, S12_B)
        weights = pr.eval_weights_from_params(model, cfg.agent_view_size)
        lanes = compare_lanes(pr.run_policy_kernel(*args, seed_row, weights, cfg),
                              pr.plain_policy_rollout(*args, seed_row, weights, cfg))
        print(f"phase 18b: {env_id} ActorCritic weights, T=1, B={S12_B}: {lanes} lanes differ (limit "
              f"{FLAX_T1_MAX_SHARE * S12_B:.2f}) [{card}]", flush=True)
        if lanes > FLAX_T1_MAX_SHARE * S12_B:
            raise RuntimeError(f"phase 18b: {lanes} of {S12_B} lanes differ after one step at {env_id}")
        rows[f"policy_kernel_{_row_name(env_id)}"] = [counts["policy_kernel"], b2[0], b2[1], b2[2], b2[3],
                                                      POLICY_SOURCE]
        del state, step
        torch.cuda.empty_cache()

    # (c) Config 5 at full width: the three mixed surfaces.
    envs = [make(e) for e in MIXED_IDS]
    states = [e.reset_batch(key(10 + i, device=dev), MIXED_B)[0] for i, e in enumerate(envs)]
    models = [ActorCritic(e.config.num_actions, generator=torch.Generator(device=dev).manual_seed(i))
              for i, e in enumerate(envs)]
    dyadic = [dyadic_flax_params(15 + i) for i in range(len(envs))]
    surfaces = (
        ("cached", "random policy, cached", "rollout_kernel",
         mixed.build_packed_mixed_rollout(MIXED_IDS, MIXED_T, mode="cached", as_carry=True),
         lambda t: mixed.build_packed_mixed_rollout(MIXED_IDS, t, mode="cached", as_carry=True),
         lambda t: mixed.build_packed_mixed_plain_rollout(MIXED_IDS, t, mode="cached", as_carry=True)),
        ("regen", f"random policy, regen chunk {MIXED_CHUNK}", "rollout_kernel",
         mixed.build_packed_mixed_rollout(MIXED_IDS, MIXED_T, mode="regen", as_carry=True),
         lambda t: mixed.build_packed_mixed_rollout(MIXED_IDS, t, mode="regen", as_carry=True),
         lambda t: mixed.build_packed_mixed_plain_rollout(MIXED_IDS, t, mode="regen", as_carry=True)),
        ("policy", f"policy evaluation, regen chunk {MIXED_CHUNK}", "policy_kernel",
         mixed.build_mixed_policy_eval(MIXED_IDS, models, MIXED_T, mode="regen", regen_chunk=MIXED_CHUNK),
         lambda t: mixed.build_mixed_policy_eval(MIXED_IDS, dyadic, t, mode="regen", regen_chunk=MIXED_CHUNK),
         lambda t: mixed.build_mixed_policy_eval_plain(MIXED_IDS, dyadic, t, mode="regen",
                                                       regen_chunk=MIXED_CHUNK)),
    )
    for name, what, kernel, step, build_kernel, build_plain in surfaces:
        mode = "cached" if name == "cached" else "regen"
        carries = tuple(fr.packed_init(e, st, mode) for e, st in zip(envs, states))
        warm, _, member_launches = _mixed_window("c", f"{' + '.join(MIXED_IDS)} {what}", step, carries, dev, card,
                                                 kernel)
        # A slice of the warm carries through the kernels and the plain twins.
        part = tuple(_slice_carry(c, MIXED_CHECK_B) for c in warm)
        src = key(1950, device=dev)
        got = build_kernel(MIXED_CHECK_T)(src, part)
        want = build_plain(MIXED_CHECK_T)(src, part)
        bad, reward_diff = _same_mixed(got, want)
        print(f"phase 18c: {what}, {MIXED_CHECK_B} lanes a member, T={MIXED_CHECK_T}, kernels against plain "
              f"twins: mismatches {bad or 'none'}; episodes {int(want[1].episodes)}, reset_overlaps "
              f"{int(want[1].reset_overlaps)}; |total_reward difference| {reward_diff} [{card}]", flush=True)
        if bad or int(want[1].episodes) == 0 or reward_diff > 1e-6 * max(1.0, abs(float(want[1].total_reward))):
            raise RuntimeError(f"phase 18c: the {name} slice differs from its plain twin: {bad}, {reward_diff}")
        # Each member's kernel alone at its shape.
        for i, (env, carry) in enumerate(zip(envs, warm)):
            cfg = env.config
            if name == "policy":
                ew = pr.eval_weights_from_params(dyadic[i], cfg.agent_view_size, device=dev)
                res = _time_pass("18c", cfg, carry, MIXED_CHUNK, dev, card, env.transition, "eval", ew)
            elif name == "regen":
                res = _time_pass("18c", cfg, carry, MIXED_CHUNK, dev, card, env.transition, "random")
            else:  # a cached call is one launch of all its steps
                res = _time_pass("18c", cfg, carry, MIXED_T, dev, card, env.transition, "random", ctl=False)
                _time_action_sources(cfg, dev, card)
            rows[f"{kernel}_config5_{name}_{_row_name(MIXED_IDS[i])}"] = [
                member_launches[i], res[0], res[1], res[2], res[3], KERNEL_SOURCE if kernel == "rollout_kernel"
                else POLICY_SOURCE]
        del warm, part, got, want, carries
        torch.cuda.empty_cache()
    return rows


def _near_the_end(step_count, max_steps, span, dev, seed):
    """Step counts drawn in `[max_steps - span, max_steps)` (a tensor of
    `max_steps` per lane, or an int), so that about `T / span` of the lanes
    reset within `T` steps."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    back = torch.randint(1, span + 1, step_count.shape, generator=g, device=dev, dtype=torch.int32)
    return (torch.as_tensor(max_steps, device=dev) - back).clamp(min=0).to(torch.int32)


def _om_carry(env, b, dev, seed, span):
    """`packed_init` of `reset_batch(key(seed))` with every step count
    within `span` of `max_steps` (the carry's step-count row): a window of
    a warm-up and a timed call of T steps each, at `span = 4·T`, resets
    about a quarter of the lanes in each call."""
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops.packing import R_SC

    carry = fr.packed_init(env, env.reset_batch(key(seed, device=dev), b)[0], "regen")
    carry.regs[R_SC] = _near_the_end(carry.regs[R_SC], env.config.max_steps, span, dev, seed)
    return carry


def _engine_cell(env_id, mode, dev, card):
    """Phase 19d: the per-env `build_rollout` against `build_fused_rollout`
    at one cell. Returns the B1 row."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.rollout import build_rollout
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    env = make(env_id)
    states, _ = env.reset_batch(key(0, device=dev), ENGINE_B)
    states = states.replace(step_count=_near_the_end(states.step_count, env.config.max_steps, 2 * ENGINE_T, dev, 19))
    per_env = build_rollout(env, ENGINE_T, autoreset_mode=mode)
    fused = fr.build_fused_rollout(env, ENGINE_T, mode=mode)
    src = key(1990, device=dev)
    fused(src, states)  # warm-up: the plan and the first launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_env, m_env = per_env(src, states)
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    s_b1, m_b1 = fused(src, states)
    torch.cuda.synchronize()
    b1_s = time.perf_counter() - t0
    counts = _counts()
    kernels = {n: c for n, c in counts.items() if n.endswith("_kernel") and c}
    a, b = state_to_numpy(s_env), state_to_numpy(s_b1)
    bad = [n for n in a if not (a[n] == b[n]).all()]
    bad += [n for n in ("episodes", "total_steps", "obs_checksum") if int(getattr(m_env, n)) != int(getattr(m_b1, n))]
    r_env, r_b1 = float(m_env.total_reward), float(m_b1.total_reward)
    steps = ENGINE_B * ENGINE_T
    print(f"phase 19d: {env_id} {mode} B={ENGINE_B} T={ENGINE_T}: per-env build_rollout {env_s:.4f} s, "
          f"{steps / env_s:.6e} env-steps/s; build_fused_rollout {b1_s:.4f} s, {steps / b1_s:.6e} env-steps/s; "
          f"episodes {int(m_env.episodes)} and {int(m_b1.episodes)}, obs_checksum {int(m_env.obs_checksum)} and "
          f"{int(m_b1.obs_checksum)}, reward {r_env:.6f} and {r_b1:.6f}; launches {kernels}; differing "
          f"{bad or 'none'} [{card}]", flush=True)
    if bad or kernels.keys() != {"rollout_kernel"} or int(m_b1.episodes) == 0 or abs(r_env - r_b1) > 1e-5 * abs(r_env):
        raise RuntimeError(f"phase 19d: {env_id} {mode}: the per-env engine and B1 differ: {bad}, {kernels}, "
                           f"{r_env} vs {r_b1}")
    carry = fr.packed_init(env, s_b1, mode)
    t = ENGINE_T if mode == "cached" else 32
    b1 = _time_pass("19d", env.config, carry, t, dev, card, env.transition, "random", ctl=mode == "regen")
    return [counts["rollout_kernel"], b1[0], b1[1], b1[2], b1[3], KERNEL_SOURCE]


def _engine_mixed(dev, card):
    """Phase 19e: `build_mixed_rollout` on the card against the CPU."""
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.state import EnvState
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    menv = mixed.MixedEnv.create(MIXED_IDS)
    ids = torch.arange(ENGINE_MIXED_B, device=dev) % len(MIXED_IDS)
    states, _ = menv.reset_batch(key(20, device=dev), ids)
    max_steps = torch.tensor([m.config.max_steps for m in menv.members], device=dev)[ids]
    states = states.replace(step_count=_near_the_end(states.step_count, max_steps, ENGINE_MIXED_T, dev, 20))
    rollout = mixed.build_mixed_rollout(menv, ENGINE_MIXED_T)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_gpu, m_gpu = rollout(key(21, device=dev), states)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launched = {n: c for n, c in _counts().items() if n.endswith("_kernel") and c}
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    s_cpu, m_cpu = rollout(key(21, device=cpu), EnvState(**{k: v.to(cpu) for k, v in vars(states).items()}))
    cpu_s = time.perf_counter() - t0
    a, b = state_to_numpy(s_gpu), state_to_numpy(s_cpu)
    bad = [n for n in a if not (a[n] == b[n]).all()]
    bad += [n for n in ("episodes", "total_steps", "obs_checksum") if int(getattr(m_gpu, n)) != int(getattr(m_cpu, n))]
    r_gpu, r_cpu = float(m_gpu.total_reward), float(m_cpu.total_reward)
    steps = ENGINE_MIXED_B * ENGINE_MIXED_T
    print(f"phase 19e: MixedEnv {' + '.join(MIXED_IDS)} build_mixed_rollout B={ENGINE_MIXED_B} T={ENGINE_MIXED_T}: "
          f"card {gpu_s:.4f} s, {steps / gpu_s:.6e} env-steps/s; CPU {cpu_s:.4f} s; episodes {int(m_gpu.episodes)}, "
          f"obs_checksum {int(m_gpu.obs_checksum)}, reward {r_gpu:.6f} (CPU {r_cpu:.6f}); kernels launched "
          f"{launched or 'none'}; differing {bad or 'none'} [{card}]", flush=True)
    if bad or launched or int(m_gpu.episodes) < ENGINE_MIXED_B or abs(r_gpu - r_cpu) > 1e-5 * max(abs(r_cpu), 1.0):
        raise RuntimeError(f"phase 19e: the card's mixed rollout differs from the CPU's: {bad}, {r_gpu} vs {r_cpu}")


def phase_slice13(dev, card):
    """Phase 19 (module docstring): ObstructedMaze through B1, B2 and B3,
    and the per-env engine. Returns `{row name: [launches, max_abs_err, ms,
    plain_ms, bound, source]}`."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    rows = {}

    # (a) Each id's regen main path under the key-drawn random policy.
    for env_id in OM_IDS:
        env = make(env_id)
        step = fr.build_fused_rollout(env, OM_T, mode="regen", as_carry=True, regen_chunk=OM_CHUNK)
        state = {"carry": _om_carry(env, OM_B, dev, 0, 4 * OM_T)}

        def om_call(i, mark, step=step, state=state):
            state["carry"], m = step(key(1800 + i, device=dev), state["carry"], mark=mark)
            return m

        res, counts, seconds, pieces, peak = _mark_window("a", om_call, 1, dev, ("rollout_kernel",), phase="19")
        _report_window("a", f"{env_id} random policy (key), chunk {OM_CHUNK}", res, counts, seconds, pieces, peak,
                       OM_T, card, b=OM_B, phase="19")
        share = pieces.get("refresh", 0.0) / max(sum(pieces.values()), 1e-9)
        print(f"phase 19a: {env_id}: the template refresh takes {pieces.get('refresh', 0.0):.4f} ms of "
              f"{sum(pieces.values()):.4f} ms a call ({share:.4f}) [{card}]", flush=True)
        if int(res[0].episodes) == 0:
            raise RuntimeError(f"phase 19a: no episode ended at {env_id}")
        part = _om_carry(env, OM_CHECK_B, dev, 3, 2 * OM_T)
        src = key(1850, device=dev)
        got = fr.build_fused_rollout(env, OM_T, mode="regen", as_carry=True, regen_chunk=OM_CHUNK)(src, part)
        want = fr.build_packed_plain_rollout(env, OM_T, mode="regen", as_carry=True, regen_chunk=OM_CHUNK)(src, part)
        bad = _same_carry_and_metrics(got, want)
        print(f"phase 19a: {env_id}: {OM_CHECK_B} lanes, T={OM_T}, build_fused_rollout against "
              f"build_packed_plain_rollout: differing {bad or 'none'}; episodes {int(want[1].episodes)} "
              f"[{card}]", flush=True)
        if bad or int(want[1].episodes) == 0:
            raise RuntimeError(f"phase 19a: {env_id}: the fused step differs from its plain twin: {bad}")
        fresh = _om_carry(env, OM_B, dev, 4, 2 * OM_CHUNK)
        b1 = _time_pass("19a", env.config, fresh, OM_CHUNK, dev, card, env.transition, "random", repeats=5)
        rows[f"rollout_kernel_{_row_name(env_id)}"] = [counts["rollout_kernel"], b1[0], b1[1], b1[2], b1[3],
                                                       KERNEL_SOURCE]
        del state, step, part, got, want, fresh
        torch.cuda.empty_cache()

    # (b) Policy evaluation with the pickup-target hook under the control rows.
    for env_id in OM_POLICY_IDS:
        env = make(env_id)
        cfg = env.config
        model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        step = pr.build_policy_eval_rollout(env, model, OM_POLICY_T, mode="regen", as_carry=True,
                                            regen_chunk=OM_CHUNK)
        state = {"carry": _om_carry(env, OM_B, dev, 1, 4 * OM_POLICY_T)}

        def eval_call(i, mark, step=step, state=state):
            state["carry"], m = step(key(1860 + i, device=dev), state["carry"], mark=mark)
            return m

        res, counts, seconds, pieces, peak = _mark_window("b", eval_call, 1, dev, ("policy_kernel",), phase="19")
        _report_window("b", f"{env_id} policy evaluation, chunk {OM_CHUNK}, {pr.policy_lane_block(cfg)}-lane blocks",
                       res, counts, seconds, pieces, peak, OM_POLICY_T, card, b=OM_B, phase="19")
        ew = pr.eval_weights_from_params(dyadic_flax_params(17), cfg.agent_view_size, device=dev)
        b2 = _time_pass("19b", cfg, state["carry"], OM_POLICY_T, dev, card, env.transition, "eval", ew)
        carry = state["carry"]
        args = (carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs)
        seed_row = pr._seeds_for(key(1870, device=dev), 1, OM_B)
        weights = pr.eval_weights_from_params(model, cfg.agent_view_size)
        kw = dict(transition=env.transition)
        lanes = compare_lanes(pr.run_policy_kernel(*args, seed_row, weights, cfg, **kw),
                              pr.plain_policy_rollout(*args, seed_row, weights, cfg, **kw))
        print(f"phase 19b: {env_id} ActorCritic weights, T=1, B={OM_B}: {lanes} lanes differ (limit "
              f"{FLAX_T1_MAX_SHARE * OM_B:.2f}) [{card}]", flush=True)
        if lanes > FLAX_T1_MAX_SHARE * OM_B:
            raise RuntimeError(f"phase 19b: {lanes} of {OM_B} lanes differ after one step at {env_id}")
        rows[f"policy_kernel_{_row_name(env_id)}"] = [counts["policy_kernel"], b2[0], b2[1], b2[2], b2[3],
                                                      POLICY_SOURCE]
        del state, step
        torch.cuda.empty_cache()

    # (c) One fused train step at 2Dlhb.
    env = make(OM_TRAIN_ID)
    cfg = env.config
    ts0 = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(0))
    train = tr.build_fused_train_step(env, OM_TRAIN_T, mode="regen", regen_chunk=OM_CHUNK)
    p0 = tr.flatten_params(ts0.params.flax_params())
    state = {"ts": ts0, "carry": _om_carry(env, OM_B, dev, 2, 4 * OM_TRAIN_T)}

    def train_call(i, mark):
        state["ts"], state["carry"], m = train(state["ts"], state["carry"], key(1880 + i, device=dev), mark=mark)
        return m

    res, counts, seconds, pieces, peak = _mark_window("c", train_call, 1, dev, ("policy_kernel", "grad_kernel"),
                                                      phase="19")
    loss = float(res[0]["loss"])
    moved = float((tr.flatten_params(state["ts"].params.flax_params()) - p0).abs().max())
    print(f"phase 19c: {OM_TRAIN_ID} fused train step, regen B={OM_B} T={OM_TRAIN_T} chunk {OM_CHUNK}: "
          f"{seconds:.4f} s, {OM_B * OM_TRAIN_T / seconds:.6e} env-steps/s; loss {loss}; episodes "
          f"{float(res[0]['episodes'])}; params moved by up to {moved:.6e}; launches {_per_call(counts, 1)}; pieces "
          f"ms { {k: round(v, 4) for k, v in pieces.items()} }; peak memory {peak} B [{card}]", flush=True)
    if not math.isfinite(loss) or not moved > 0 or int(res[0]["env_steps"]) != OM_B * OM_TRAIN_T:
        raise RuntimeError(f"phase 19c: loss {loss}, params moved by {moved}, or env_steps != B*T")
    tw = pr.train_weights_from_params(dyadic_flax_params(18), cfg.agent_view_size, device=dev)
    b2c = _time_pass("19c", cfg, state["carry"], OM_CHUNK, dev, card, env.transition, "collect", tw, reps=1)
    weights = pr.train_weights_from_params(state["ts"].params, cfg.agent_view_size)
    roll = pr.build_fused_train_rollout(env, OM_TRAIN_T, mode="regen", regen_chunk=OM_CHUNK)
    _, traj, _ = roll(weights, key(1890, device=dev), state["carry"])
    b3 = _grad_vs_plain("19c", cfg, weights, traj, card)
    rows[f"policy_kernel_collect_{_row_name(OM_TRAIN_ID)}"] = [counts["policy_kernel"], b2c[0], b2c[1], b2c[2],
                                                               b2c[3], POLICY_SOURCE]
    rows[f"grad_kernel_{_row_name(OM_TRAIN_ID)}"] = [counts["grad_kernel"], b3[0], b3[1], b3[2], b3[3], GRAD_SOURCE]
    del state, traj, roll, train
    torch.cuda.empty_cache()

    # (d) The per-env engine against B1; (e) the mixed batch, card and CPU.
    for env_id, mode in ENGINE_CELLS:
        rows[f"rollout_kernel_engine_{_row_name(env_id)}_{mode}"] = _engine_cell(env_id, mode, dev, card)
        torch.cuda.empty_cache()
    _engine_mixed(dev, card)
    return rows


def _p20_timed(fn):
    """`fn()` between two synchronizes: (seconds, result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _p20_launched(what, path_kernels):
    """The kernels' launches since the counts were last set to 0; raises
    unless each of `path_kernels` and no other kernel launched (but the
    probe kernel, which the first use of a card launches once)."""
    kernels = {n: c for n, c in _counts().items() if n.endswith("_kernel")}
    path = set(path_kernels) | {"probe_kernel"}
    if any(kernels[n] == 0 for n in path_kernels) or any(c for n, c in kernels.items() if n not in path):
        raise RuntimeError(f"phase {what}: launches {kernels}; the path runs {path_kernels} and no other kernel")
    return kernels


def _p20_metrics_differ(got, want):
    """Names of the metrics that differ (the f32 sum bit for bit)."""
    import torch

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    return [n for n, a, b in zip(got._fields, got, want) if not torch.equal(bits(a), bits(b))]


def _p20_moment_gaps(ts, ref, tol):
    """`testing.moment_gaps(ts, ref)` and the leaves above `tol[layer]`."""
    from minigrid_tpu_torch.testing import moment_gaps

    gaps = moment_gaps(ts, ref)
    return gaps, [leaf for leaf, g in gaps.items() if max(g) > tol[leaf.split("/")[0]]]


def _p20_meshes(dev):
    """M1: every visible card; M2: two shards of `dev`."""
    from minigrid_tpu_torch.parallel.sharding import make_env_mesh

    return {"M1": make_env_mesh(), "M2": make_env_mesh([dev, dev])}


def _p20_replay_window(tag, what, one, sharded, carry, meshes, b, card, path_kernel, k):
    """Phases 20a and 20b: the unsharded `one(k, carry)` timed after a
    warm-up, then over each mesh one `sharded(mesh)(k, shards)` call timed
    with every count set to 0 just before it, held byte for byte (the
    metrics' f32 sum bit for bit) to the per-shard replay `one(fold_in(k,
    i), shard_i)`. Returns (launches over the meshes' calls, M2's shards)."""
    import torch

    from minigrid_tpu_torch.core.prng import fold_in
    from minigrid_tpu_torch.parallel import packed as pk

    one(k, carry)
    secs, _ = _p20_timed(lambda: one(k, carry))
    unsharded = b * P20_T / secs
    launches, shards = 0, None
    for name, mesh in meshes.items():
        shards = pk.shard_carry(carry, mesh)
        step = sharded(mesh)
        _zero_counts()
        secs, (got, total) = _p20_timed(lambda: step(k, shards))
        launches += _p20_launched(f"20{tag} ({name})", (path_kernel,))[path_kernel]
        replay = [one(fold_in(k, i), s) for i, s in enumerate(shards)]
        bad = [f"shard {i} {n}" for i, (c, _) in enumerate(replay)
               for n, x, y in zip(c._fields, c, got[i]) if not torch.equal(x, y)]
        bad += _p20_metrics_differ(total, pk.sum_metrics([m for _, m in replay]))
        print(f"phase 20{tag}: {what} over {name} ({[str(d) for d in mesh.shard_devices]}): {secs:.4f} s, "
              f"{b * P20_T / secs:.6e} env-steps/s (the unsharded call {unsharded:.6e}); episodes "
              f"{int(total.episodes)}, reset_overlaps {int(total.reset_overlaps)}; against the per-shard replay "
              f"under fold_in(key, i): differing {bad or 'none'} [{card}]", flush=True)
        if bad or int(total.total_steps) != b * P20_T or int(total.obs_checksum) == 0:
            raise RuntimeError(f"phase 20{tag}: {name} differs from its per-shard replay: {bad}")
        del replay, got
    return launches, shards


def _p20_rollout_and_eval(dev, card, meshes):
    """20a and 20b. Returns their kernel rows."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.testing import dyadic_flax_params

    env = make(ENV_ID)
    cfg = env.config
    rows = {}
    carry = fr.packed_init(env, env.reset_batch(key(0, device=dev), P20_B)[0], "regen")
    launches, shards = _p20_replay_window(
        "a", f"build_sharded_rollout, {ENV_ID} regen, carry surface, B={P20_B} T={P20_T}",
        fr.build_fused_rollout(env, P20_T, mode="regen", as_carry=True),
        lambda mesh: pk.build_sharded_rollout(env, P20_T, mesh, mode="regen", as_carry=True), carry, meshes, P20_B,
        card, "rollout_kernel", key(2000, device=dev))
    b1 = _time_pass("20a", cfg, _slice_carry(shards[0], P20_CHECK_B), P20_T, dev, card, env.transition, "random",
                    ctl=False)
    rows["rollout_kernel_sharded"] = [launches, b1[0], b1[1], b1[2], b1[3], KERNEL_SOURCE]
    del carry, shards
    torch.cuda.empty_cache()

    carry = fr.packed_init(env, env.reset_batch(key(1, device=dev), P20_B)[0], "cached")
    model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
    launches, shards = _p20_replay_window(
        "b", f"build_sharded_policy_eval, {ENV_ID} cached, B={P20_B} T={P20_T}",
        pr.build_policy_eval_rollout(env, model, P20_T, mode="cached", as_carry=True),
        lambda mesh: pk.build_sharded_policy_eval(env, model, P20_T, mesh, mode="cached", as_carry=True), carry,
        meshes, P20_B, card, "policy_kernel", key(2001, device=dev))
    ew = pr.eval_weights_from_params(dyadic_flax_params(20), cfg.agent_view_size, device=dev)
    b2 = _time_pass("20b", cfg, _slice_carry(shards[0], P20_CHECK_B), P20_CHECK_T, dev, card, env.transition, "eval",
                    ew, ctl=False)
    rows["policy_kernel_sharded"] = [launches, b2[0], b2[1], b2[2], b2[3], POLICY_SOURCE]
    del carry, shards
    torch.cuda.empty_cache()
    return rows


def _p20_connect_row(cfg, b, dev, card):
    """B4 on KeyCorridor's generator plan at `b` lanes against its plain
    version, timed: (max_abs_err, ms, plain_ms, bound)."""
    from minigrid_tpu_torch.ops import gen_kernel as gk

    args = kc_connect_inputs(cfg, b, dev)
    got, want = gk.run_connect_kernel(*args), gk.plain_connect_plan(*args)
    bad = {n: int((g != w).sum()) for n, g, w in zip(("doors", "colors", "draws"), got, want)}
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    ms, _ = time_events(lambda: gk.run_connect_kernel(*args), KC_TIMED)
    plain_ms, _ = time_events(lambda: gk.plain_connect_plan(*args), 1)
    rows, cols = cfg.num_rows, cfg.num_cols
    ops = (CONNECT_OPS_PER_DRAW_BASE + CONNECT_OPS_PER_FLOOD_STEP * rows * cols) * float(want[2].double().sum())
    bnd = bound(4 * (2 + 3 + 4) * b + 4 * (4 + rows * cols * 4 + 1) * b, ops, int_issue_rate(dev))
    print(f"phase 20c: connect kernel on the generator plan at a shard's B={b}: {ms:.6f} ms/call (mean of "
          f"{KC_TIMED}), plain {plain_ms:.4f} ms; mismatches {bad}; bound {bnd} [{card}]", flush=True)
    if any(bad.values()):
        raise RuntimeError(f"phase 20c: the connect kernel differs from its plain version: {bad}")
    return err, ms, plain_ms, bnd


def _p20_collect_and_grads(env, model, carry, t, chunk, mesh, dev, card):
    """20c's collection and gradient pass: the collecting rollout on the
    whole batch and on each shard (its columns of the whole batch's seed
    stream), byte for byte; the shards' gradient-kernel sums, added in shard
    order, against the unsharded pass within phase 7's bounds. Returns
    (max_abs_err, the first shard's carry and trajectory)."""
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.parallel import train as tr

    cfg = env.config
    b = carry.words.shape[1]
    tw = tr._train_weights(model, cfg.agent_view_size, dev)
    w = pr.EvalWeights(*(x.detach() for x in tw.w))
    roll = pr.build_fused_train_rollout(env, t, mode="regen", regen_chunk=chunk)
    k = key(2100, device=dev)
    part = b // mesh.n_env
    c_un, traj_un, _ = roll(w, k, carry)
    outs = [roll(w, k, s, lane0=i * part, total=b) for i, s in enumerate(pk.shard_carry(carry, mesh))]
    bad = [f"carry {n}" for n, x, y in zip(c_un._fields, c_un, pk.gather_carry([o[0] for o in outs]))
           if not torch.equal(x, y)]
    bad += [f"trajectory {n}" for j, n in enumerate(("obs_words", "actions", "logp", "value", "reward", "done"))
            if not torch.equal(traj_un[j], torch.cat([o[1][j] for o in outs], dim=-1))]
    print(f"phase 20c: {env.env_id} regen B={b} T={t} chunk {chunk}: the collecting rollout over M2 against the "
          f"unsharded one: differing {bad or 'none'} [{card}]", flush=True)
    if bad:
        raise RuntimeError(f"phase 20c: {env.env_id}: the sharded collection differs: {bad}")
    denom = float(t * b)
    gw, sums = tr._kernel_grad_sums(w, traj_un, cfg.num_actions, denom)[:2]
    parts = [tr._kernel_grad_sums(w, o[1], cfg.num_actions, denom)[:2] for o in outs]
    got_gw, got_sums = tr._add_in_order([p[0] for p in parts], dev), tr._add_in_order([p[1] for p in parts], dev)
    rel = {n: float((g - x).abs().max() / (x.abs().max() + 1e-9))
           for n, g, x in zip(pr.EvalWeights._fields, got_gw, gw)}
    sums_rel = float(((got_sums - sums).abs() / sums.abs()).max())
    err = max(float((g.double() - x.double()).abs().max()) for g, x in zip((*got_gw, got_sums), (*gw, sums)))
    print(f"phase 20c: the shards' gradient-kernel sums against the unsharded pass: rel-to-max {rel}, loss sums rel "
          f"{sums_rel:.3e} [{card}]", flush=True)
    if not _grad_within_bounds(rel, sums_rel, True, got_sums):
        raise RuntimeError(f"phase 20c: {env.env_id}: the sharded gradients are outside phase 7's bounds")
    return err, outs[0]


def _p20_chained_steps(env, model, carry, t, chunk, meshes, dev, card, kernels):
    """20c's two chained train steps, unsharded, over M1 and over M2, from
    the same carry, weights and keys: the carry after step 1 byte for byte,
    Adam's moments after each step to `P20_FUSED_MOMENT_TOL` of the
    unsharded ones per leaf, the params within 2·lr a step. Returns M2's
    launches."""
    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.parallel import train as tr

    b = carry.words.shape[1]
    opt0 = tr.make_optimizer().init(tr.flatten_params(model.flax_params()))
    tr.build_fused_train_step(env, t, mode="regen", regen_chunk=chunk)(tr.TrainState(model, opt0), carry,
                                                                       key(2109, device=dev))  # warm-up
    runs = {}
    for name, mesh in (("unsharded", None), ("M1", meshes["M1"]), ("M2", meshes["M2"])):
        step = tr.build_fused_train_step(env, t, mode="regen", regen_chunk=chunk, mesh=mesh)
        ts, value = tr.TrainState(model, opt0), carry if mesh is None else pk.shard_carry(carry, mesh)
        seconds, first, params, states = 0.0, None, [], []
        _zero_counts()
        for s in range(2):
            secs, (ts, value, metrics) = _p20_timed(lambda: step(ts, value, key(2110 + s, device=dev)))
            seconds += secs
            if s == 0:
                first = value if mesh is None else pk.gather_carry(value)
            params.append(tr.flatten_params(ts.params.flax_params()))
            states.append(ts)
            if int(metrics["env_steps"]) != b * t or not math.isfinite(float(metrics["loss"])):
                raise RuntimeError(f"phase 20c: {name}: env_steps {int(metrics['env_steps'])}, loss "
                                   f"{float(metrics['loss'])}")
        runs[name] = (first, params, _p20_launched(f"20c ({name})", kernels), 2 * b * t / seconds, states)
        del ts, value
        torch.cuda.empty_cache()
    base_c, base_p, _, base_rate, base_s = runs["unsharded"]
    for name in ("M1", "M2"):
        c, p, launched, rate, states = runs[name]
        same = all(torch.equal(x, y) for x, y in zip(c, base_c))
        gap = [float((x - y).abs().max()) for x, y in zip(p, base_p)]
        moments = [_p20_moment_gaps(x, y, P20_FUSED_MOMENT_TOL) for x, y in zip(states, base_s)]
        print(f"phase 20c: {env.env_id} fused train step over {name}, 2 steps B={b} T={t}: {rate:.6e} env-steps/s "
              f"(unsharded {base_rate:.6e}); launches {launched}; carry after step 1 equal: {same}; Adam's "
              f"[mu, nu] per leaf against the unsharded step's, rel to the leaf's max, after steps 1 and 2: "
              f"{[g for g, _ in moments]} (bounds {P20_FUSED_MOMENT_TOL}); the params' largest gap: {gap} (bound "
              f"2·lr a step) [{card}]", flush=True)
        outside = [m for _, m in moments]
        if not same or any(outside) or any(g > 2 * tr.LR * (s + 1) * (1 + 1e-3) for s, g in enumerate(gap)):
            raise RuntimeError(f"phase 20c: {env.env_id}: the step over {name} differs from the unsharded step: "
                               f"carry equal {same}, moments outside their bounds {outside}, params {gap}")
    return runs["M2"][2]


def _p20_train(dev, card, meshes):
    """20c: the sharded fused train step over M2 against the unsharded step
    at two cells. Returns the kernel rows."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.testing import dyadic_flax_params

    rows = {}
    for env_id, b, t, chunk in P20_TRAIN_CELLS:
        env = make(env_id)
        cfg = env.config
        hooked = env_id == KC_ENV_ID
        states = env.reset_batch(key(0, device=dev), b)[0]
        states = states.replace(step_count=_near_the_end(states.step_count, cfg.max_steps, 2 * t, dev, 21))
        carry = fr.packed_init(env, states, "regen")
        model = ActorCritic(cfg.num_actions, generator=torch.Generator(device=dev).manual_seed(0))
        grad_err, (c0, traj0, _) = _p20_collect_and_grads(env, model, carry, t, chunk, meshes["M2"], dev, card)
        wd = pr.train_weights_from_params(dyadic_flax_params(21), cfg.agent_view_size, device=dev)
        b2 = _time_pass("20c", cfg, c0, chunk, dev, card, env.transition, "collect", wd, ctl=hooked)
        w = pr.EvalWeights(*(x.detach() for x in tr._train_weights(model, cfg.agent_view_size, dev).w))
        b3 = _grad_vs_plain("20c", cfg, w, traj0, card)
        del c0, traj0
        torch.cuda.empty_cache()
        kernels = ("policy_kernel", "grad_kernel") + (("connect_kernel",) if hooked else ())
        launched = _p20_chained_steps(env, model, carry, t, chunk, meshes, dev, card, kernels)
        row = _row_name(env_id)
        rows[f"policy_kernel_collect_sharded_{row}"] = [launched["policy_kernel"], b2[0], b2[1], b2[2], b2[3],
                                                        POLICY_SOURCE]
        rows[f"grad_kernel_sharded_{row}"] = [launched["grad_kernel"], max(b3[0], grad_err), b3[1], b3[2], b3[3],
                                              GRAD_SOURCE]
        if hooked:
            c4 = _p20_connect_row(cfg, b // meshes["M2"].n_env, dev, card)
            rows[f"connect_kernel_sharded_{row}"] = [launched["connect_kernel"], c4[0], c4[1], c4[2], c4[3],
                                                     GEN_SOURCE]
        del carry
        torch.cuda.empty_cache()
    return rows


def _p20_steps(dev, card, meshes):
    """20d: `build_train_step` and `build_packed_train_step` over M2 against
    one shard, equal on every integer, Adam's moments per leaf to
    `P20_AUTOGRAD_MOMENT_TOL`; the two steps' updates equal on Empty-8x8."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.parallel.sharding import gather_states, make_env_mesh, shard_states
    from minigrid_tpu_torch.testing import dyadic_flax_params

    one_shard = make_env_mesh([dev])
    steps = P20_STEP_B * P20_STEP_T
    for env_id, mode in P20_STEP_CELLS:
        env = make(env_id)
        states = env.reset_batch(key(0, device=dev), P20_STEP_B)[0]
        states = states.replace(step_count=_near_the_end(states.step_count, env.config.max_steps, 2 * P20_STEP_T,
                                                         dev, 20))
        model = ActorCritic.from_flax(dyadic_flax_params(22), device=dev)
        ts0 = tr.TrainState(model, tr.make_optimizer().init(tr.flatten_params(model.flax_params())))
        k = key(2200, device=dev)
        params = {}
        for build in (tr.build_train_step, tr.build_packed_train_step):
            outs = {}
            for name, mesh in (("one shard", one_shard), ("M2", meshes["M2"])):
                step = build(env, P20_STEP_T, mesh=mesh, mode=mode)
                shards = shard_states(states, mesh)
                _zero_counts()
                secs, (ts, st, m) = _p20_timed(lambda: step(ts0, shards, k))
                launched = {n: c for n, c in _counts().items() if n.endswith("_kernel") and c}
                outs[name] = (gather_states(st), m, tr.flatten_params(ts.params.flax_params()), secs, launched, ts)
            (a, ma, pa, sa, la, ta), (b, mb, pb, sb, lb, tb) = outs["one shard"], outs["M2"]
            bad = [f.name for f in dataclasses.fields(a) if not torch.equal(getattr(a, f.name), getattr(b, f.name))]
            bad += [] if torch.equal(ma["episodes"], mb["episodes"]) else ["episodes"]
            gap = float((pa - pb).abs().max())
            moments, outside = _p20_moment_gaps(tb, ta, P20_AUTOGRAD_MOMENT_TOL)
            print(f"phase 20d: {build.__name__}, {env_id} {mode} B={P20_STEP_B} T={P20_STEP_T}: one shard "
                  f"{sa:.4f} s, {steps / sa:.6e} env-steps/s; M2 {sb:.4f} s, {steps / sb:.6e} env-steps/s; loss "
                  f"{float(mb['loss']):.6f}, episodes {float(mb['episodes'])}; differing {bad or 'none'}; Adam's "
                  f"[mu, nu] per leaf against one shard's, rel to the leaf's max: {moments} (bounds "
                  f"{P20_AUTOGRAD_MOMENT_TOL}); the params' largest gap {gap:.3e}; kernels launched {la or 'none'} "
                  f"and {lb or 'none'} (plain PyTorch by design: the JAX package's step is plain XLA) [{card}]",
                  flush=True)
            if bad or outside or gap > 2 * tr.LR or float(mb["episodes"]) == 0:
                raise RuntimeError(f"phase 20d: {build.__name__} at {env_id}: M2 differs from one shard: {bad}, "
                                   f"moments outside their bounds {outside}, params {gap}")
            params[build.__name__] = pa
        if env_id == ENV_ID:
            gap = float((params["build_train_step"] - params["build_packed_train_step"]).abs().max())
            print(f"phase 20d: {env_id}: build_train_step's and build_packed_train_step's updates differ by "
                  f"{gap:.3e} at most [{card}]", flush=True)
            if gap > 1e-6:
                raise RuntimeError(f"phase 20d: the per-env and packed train steps' updates differ by {gap}")
        torch.cuda.empty_cache()


def _p20_mixed(dev, card, meshes):
    """20e: config 5's mixed surfaces over M1 and M2 against the per-member
    sharded replay. Returns the kernel rows, one per member and surface,
    each with the member's launches in M2's call."""
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import fold_in, key
    from minigrid_tpu_torch.models.policy import ActorCritic
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import policy_rollout as pr
    from minigrid_tpu_torch.parallel import mixed
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.testing import dyadic_flax_params

    envs = [make(e) for e in MIXED_IDS]
    models = [ActorCritic(e.config.num_actions, generator=torch.Generator(device=dev).manual_seed(i))
              for i, e in enumerate(envs)]
    rows = {}
    b, t = P20_MIXED_B * len(envs), MIXED_T
    for surface, mode, kernel in (("random", "cached", "rollout_kernel"), ("random", "regen", "rollout_kernel"),
                                  ("policy", "regen", "policy_kernel")):
        carries = tuple(fr.packed_init(e, e.reset_batch(key(30 + i, device=dev), P20_MIXED_B)[0], mode)
                        for i, e in enumerate(envs))
        if surface == "random":
            build = lambda mesh: mixed.build_packed_mixed_rollout(MIXED_IDS, t, mode=mode, as_carry=True, mesh=mesh)  # noqa: E731
            members = [fr.build_fused_rollout(e, t, mode=mode, as_carry=True) for e in envs]
        else:
            build = lambda mesh: mixed.build_mixed_policy_eval(MIXED_IDS, models, t, mode=mode,  # noqa: E731
                                                               regen_chunk=MIXED_CHUNK, mesh=mesh)
            members = [pr.build_policy_eval_rollout(e, m, t, mode=mode, as_carry=True, regen_chunk=MIXED_CHUNK)
                       for e, m in zip(envs, models)]
        k = key(2300, device=dev)
        one = build(None)
        one(k, carries)
        secs, _ = _p20_timed(lambda: one(k, carries))
        unsharded = b * t / secs
        for name, mesh in meshes.items():
            sharded = tuple(pk.shard_carry(c, mesh) for c in carries)
            _zero_counts()
            secs, (got, total) = _p20_timed(lambda: build(mesh)(k, sharded))
            window = _p20_launched(f"20e ({name})", (kernel,))[kernel]
            bad, metrics, member_launches = [], [], []
            for i, inner in enumerate(members):
                _zero_counts()
                replay = [inner(fold_in(fold_in(k, i), j), s) for j, s in enumerate(sharded[i])]
                member_launches.append(_counts()[kernel])
                metrics.append(pk.sum_metrics([m for _, m in replay]))
                bad += [f"member {i} shard {j} {n}" for j, (c, _) in enumerate(replay)
                        for n, x, y in zip(c._fields, c, got[i][j]) if not torch.equal(x, y)]
            bad += _p20_metrics_differ(total, pk.sum_metrics(metrics))
            print(f"phase 20e: config 5 {surface} {mode} over {name}, B={b} T={t}: {secs:.4f} s, {b * t / secs:.6e} "
                  f"env-steps/s (the unsharded call {unsharded:.6e}); episodes {int(total.episodes)}, reset_overlaps "
                  f"{int(total.reset_overlaps)}; {kernel} launches {window} (the members' replays "
                  f"{member_launches}); against the per-member sharded replay: differing {bad or 'none'} [{card}]",
                  flush=True)
            if bad or int(total.episodes) == 0 or sum(member_launches) != window:
                raise RuntimeError(f"phase 20e: {surface} {mode} over {name} differs from its replay: {bad}, "
                                   f"{window} vs {member_launches}")
        # Each member's kernel against its plain version at a shard's lanes.
        for i, e in enumerate(envs):
            part = pk.shard_carry(carries[i], meshes["M2"])[0]
            if surface == "random":
                res = _time_pass("20e", e.config, part, MIXED_CHECK_T, dev, card, e.transition, "random",
                                 ctl=mode == "regen")
            else:
                wd = pr.eval_weights_from_params(dyadic_flax_params(23 + i), e.config.agent_view_size, device=dev)
                res = _time_pass("20e", e.config, part, MIXED_CHECK_T, dev, card, e.transition, "eval", wd)
            rows[f"{kernel}_mixed_sharded_{mode}_{_row_name(MIXED_IDS[i])}"] = [
                member_launches[i], res[0], res[1], res[2], res[3],
                KERNEL_SOURCE if kernel == "rollout_kernel" else POLICY_SOURCE]
        del carries
        torch.cuda.empty_cache()
    return rows


def phase20_distributed_child() -> None:
    """Phase 20f's own process: one NCCL process group of world size 1 on
    the card (`distributed.initialize`), `make_global_batch` over two
    shards of it (`global_env_mesh`), the sharded rollout and
    `psum_metrics` through `all_reduce`. Prints one `P20F` JSON line: the
    metrics, the kernels' launches in this process (its first library
    load launches the probe kernel, which `load_library` holds against
    `x + 1`), and after them `phase_probe`'s reading in this process."""
    import socket

    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.parallel import distributed, packed

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, timeout_s=120)
    try:
        mesh = distributed.global_env_mesh([dev, dev])
        env = make(ENV_ID)
        _zero_counts()
        states, _ = distributed.make_global_batch(env, key(2400, device=dev), P20_DIST_B, mesh)
        _, m = packed.build_sharded_rollout(env, P20_T, mesh, mode="regen")(key(2401, device=dev), states)
        m = distributed.psum_metrics(m, mesh)
        torch.cuda.synchronize()
        counts = {n: c for n, c in _counts().items() if n.endswith("_kernel")}
        info = distributed.process_info(mesh)
    finally:
        torch.distributed.destroy_process_group()
    probe = phase_probe(dev, "this process", phase="20f")
    print("P20F " + json.dumps({"metrics": [int(m.episodes), int(m.total_steps), int(m.obs_checksum),
                                            int(m.reset_overlaps), float(m.total_reward)],
                                "reward_bits": int(m.total_reward.view(torch.int32)), "counts": counts,
                                "info": info, "probe": list(probe)}), flush=True)


def _p20_distributed(dev, card, meshes):
    """20f: the child process's run against 20a's path (the sharded rollout
    over M2 from `reset_batch` of the same key) at `P20_DIST_B`. Returns
    the child's launch counts and its probe reading (error, ms, plain ms,
    `torch.add`'s ms)."""
    import os

    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.parallel import packed as pk
    from minigrid_tpu_torch.parallel.sharding import shard_states

    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.phase20_distributed_child()"],
                         capture_output=True, text=True, timeout=P20_DIST_TIMEOUT, cwd=here,
                         env={**os.environ, "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")})
    lines = [x for x in res.stdout.splitlines() if x.startswith("P20F ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"phase 20f: the process-group run failed ({res.returncode}):\n{res.stderr[-3000:]}")
    child = json.loads(lines[-1][5:])
    env = make(ENV_ID)
    states = shard_states(env.reset_batch(key(2400, device=dev), P20_DIST_B)[0], meshes["M2"])
    _, m = pk.build_sharded_rollout(env, P20_T, meshes["M2"], mode="regen")(key(2401, device=dev), states)
    want = [int(m.episodes), int(m.total_steps), int(m.obs_checksum), int(m.reset_overlaps), float(m.total_reward)]
    same = child["metrics"] == want and child["reward_bits"] == int(m.total_reward.view(torch.int32))
    print(f"phase 20f: one NCCL process group of world size 1 ({child['info']}): make_global_batch, "
          f"build_sharded_rollout over two shards and psum_metrics (all_reduce), B={P20_DIST_B} T={P20_T}: metrics "
          f"{child['metrics']}, launches in that process {child['counts']}; 20a's path in this one {want}: equal "
          f"{same}; that process's probe kernel against x + 1 (error, ms, plain ms, torch.add ms): "
          f"{child['probe']} [{card}]", flush=True)
    if not same or child["counts"]["rollout_kernel"] != 2 or child["counts"]["probe_kernel"] != 1:
        raise RuntimeError(f"phase 20f: the distributed run differs from 20a's path or launched {child['counts']}")
    return child["counts"], child["probe"]


def phase_slice14(dev, card):
    """Phase 20 (module docstring): `parallel/` over two meshes. Returns
    (`{row name: [launches, max_abs_err, ms, plain_ms, bound, source]}`,
    `{probe row name: [launches, max_abs_err, ms, plain_ms, library_ms]}`:
    the probe in 20f's process, and on a machine with more than one card
    on the cards the meshes used first, each measured where it launched)."""
    import torch

    from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip

    from minigrid_tpu_torch.ops import _build

    meshes = _p20_meshes(dev)
    checked = set(_build._checked_devices)
    print(f"phase 20: M1 {[str(d) for d in meshes['M1'].shard_devices]}, M2 "
          f"{[str(d) for d in meshes['M2'].shard_devices]} [{card}]", flush=True)
    rows = _p20_rollout_and_eval(dev, card, meshes)
    rows.update(_p20_train(dev, card, meshes))
    _p20_steps(dev, card, meshes)
    rows.update(_p20_mixed(dev, card, meshes))
    child, child_probe = _p20_distributed(dev, card, meshes)
    rows["rollout_kernel_sharded"][0] += child["rollout_kernel"]
    _zero_counts()
    out = dryrun_multichip(torch.cuda.device_count())
    launched = {n: c for n, c in _counts().items() if n.endswith("_kernel") and c}
    print(f"phase 20g: dryrun_multichip over M1 ({torch.cuda.device_count()} card(s)): {out}; launches {launched} "
          f"[{card}]", flush=True)
    if not {"rollout_kernel", "policy_kernel", "grad_kernel"} <= launched.keys():
        raise RuntimeError(f"phase 20g: the dry run launched {launched}")
    # The probe: once in 20f's process, and once here on each card the
    # meshes first used (every card of M1 but the first, on a machine
    # with more than one), each row read where its launches ran.
    probes = {"probe_kernel_distributed": [child["probe_kernel"], *child_probe]}
    cards = sorted(set(_build._checked_devices) - checked)
    if cards:
        readings = [phase_probe(torch.device("cuda", i), card, phase="20") for i in cards]
        probes["probe_kernel_mesh_cards"] = [len(cards), *(max(r[j] for r in readings) for j in range(4))]
    return rows, probes


def _p21_golden(dev, card):
    """21a: every trajectory fixture through `Env.step` on the card."""
    import glob

    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.compat.exact import CompatEnv, dynobst_step, state_to_device

    fixtures = sorted(f for f in glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))
                      if not os.path.basename(f).startswith("wrappers_"))
    families, steps, bad = set(), 0, []
    t0 = time.perf_counter()
    for path in fixtures:
        env_id, seed = os.path.basename(path)[: -len(".npz")].rsplit("_s", 1)
        data = np.load(path)
        env = make(env_id)
        families.add(env.config.family)
        ce = CompatEnv(env_id, seed=int(seed))
        layout = ce.reset()
        if not (np.array_equal(layout["grid"], data["grid"]) and np.array_equal(layout["agent_pos"], data["agent_pos"])):
            bad.append(f"{env_id} layout")
            continue
        state = state_to_device(layout, env.config, device=dev)
        actions = torch.from_numpy(data["actions"].astype(np.int32)).to(dev)  # one copy: no sync a step
        images, outs = [env.observe(state, env.config)["image"][0]], []
        for t in range(len(actions)):
            if env.config.family == "dynamicobstacles":
                state, obs, r, te, tr = dynobst_step(ce, env, state, int(data["actions"][t]))
            else:
                state, obs, r, te, tr = env.step(state, actions[t : t + 1])
            images.append(obs["image"][0])
            outs.append(torch.stack([r[0], te[0].float(), tr[0].float()]))
        # Read back once a trajectory; the first differing step names it.
        images = torch.stack(images).cpu().numpy()
        r, te, tr = torch.stack(outs).cpu().numpy().T
        want_r = data["rewards"].astype(np.float32)
        ok = ((images == data["images"]).reshape(len(images), -1).all(axis=1)[1:]
              & (np.abs(r - want_r) <= 1e-6 * np.abs(want_r))
              & (te.astype(bool) == data["terminated"].astype(bool)) & (tr.astype(bool) == data["truncated"].astype(bool)))
        if not (images[0] == data["images"][0]).all() or not ok.all():
            bad.append(f"{env_id} s{seed} step {int(np.argmin(ok)) if not ok.all() else 'start'}")
        steps += len(actions)
    seconds = time.perf_counter() - t0
    print(f"phase 21a: {len(fixtures)} golden trajectories ({len(families)} families, DynamicObstacles through "
          f"dynobst_step), {steps} steps through Env.step on {dev}: {seconds:.4f} s, {steps / seconds:.4f} steps/s; "
          f"differing {bad or 'none'} [{card}]", flush=True)
    if bad or len(fixtures) < 63 or len(families) != 21:
        raise RuntimeError(f"phase 21a: {len(fixtures)} fixtures, {len(families)} families; differing {bad}")


def _p21_wrapper_golden(dev, card):
    """21b: the wrapper fixtures on the card."""
    import glob

    import numpy as np
    import torch

    from minigrid_tpu_torch import make, wrappers
    from minigrid_tpu_torch.compat.exact import CompatEnv, state_to_device
    from minigrid_tpu_torch.compat.host_env import HostEnv, flat_obs
    from minigrid_tpu_torch.render.render import render_obs_image, render_state

    fixtures = sorted(glob.glob(os.path.join(GOLDEN_DIR, "wrappers_*.npz")))
    bad = []
    for path in fixtures:
        env_id, seed = os.path.basename(path)[len("wrappers_"): -len(".npz")].rsplit("_s", 1)
        data = np.load(path)
        env = make(env_id)
        state = state_to_device(CompatEnv(env_id, seed=int(seed)).reset(), env.config, device=dev)
        for a in data["actions"]:
            state, obs, *_ = env.step(state, torch.tensor([int(a)], dtype=torch.int32, device=dev))
        got = {
            "fullobs_image": wrappers.full_obs(env).observe(state, env.config)["image"],
            "onehot_image": wrappers.one_hot_partial_obs(env).observe(state, env.config)["image"],
            "rgb_full": render_state(state, env.config, tile_size=8, highlight=False),
            "rgb_partial": render_obs_image(obs["image"], tile_size=8),
        }
        host = HostEnv(env, device=dev)
        host_obs, _ = host.reset(seed=int(seed))
        for a in data["actions"]:
            host_obs = host.step(int(a))[0]
        bad += [f"{env_id} {k}" for k, v in got.items() if v.device != dev or not np.array_equal(v[0].cpu().numpy(), data[k])]
        if not np.array_equal(flat_obs(host_obs), data["flat_vec"]):
            bad.append(f"{env_id} flat_vec")
    print(f"phase 21b: {len(fixtures)} wrapper fixtures on {dev} (full obs, one-hot, render_state tile 8, "
          f"render_obs_image; flat vector through the adapter's path): differing {bad or 'none'} [{card}]", flush=True)
    if bad or len(fixtures) != 3:
        raise RuntimeError(f"phase 21b: the wrapper fixtures differ: {bad}")


def _p21_surfaces(dev, card):
    """21c: B1 to the final states of a regen carry, then every surface on
    them against the CPU. Returns (env, the carry, the final states, the
    B1 row)."""
    import torch

    from minigrid_tpu_torch import make, wrappers
    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.core.state import EnvState
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.render.render import render_state

    env = make(SURF_ENV_ID)
    cfg = env.config
    carry = _om_carry(env, SURF_B, dev, 21, 4 * SURF_T)  # about a quarter of the lanes reset in each call
    step = fr.build_fused_rollout(env, SURF_T, mode="regen", as_carry=True, regen_chunk=SURF_CHUNK)
    step(key(2100, device=dev), carry)  # warm-up: the plan and the first launch
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    carry, metrics = step(key(2101, device=dev), carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    states = fr.packed_finish(env, carry)
    launched = {n: c for n, c in counts.items() if n.endswith("_kernel") and c}
    print(f"phase 21c: {SURF_ENV_ID} regen B={SURF_B} T={SURF_T} chunk {SURF_CHUNK}: {seconds:.4f} s, "
          f"{SURF_B * SURF_T / seconds:.6e} env-steps/s; episodes {int(metrics.episodes)}; launches {launched} "
          f"[{card}]", flush=True)
    if launched.keys() != {"rollout_kernel"} or int(metrics.total_steps) != SURF_B * SURF_T or not int(metrics.episodes):
        raise RuntimeError(f"phase 21c: launches {launched}; the path runs B1 and no other kernel")
    cpu = torch.device("cpu")
    host = EnvState(**{k: v.cpu() for k, v in vars(states).items()})
    surfaces = {
        "full_obs": lambda s: wrappers.full_obs(env).observe(s, cfg)["image"],
        "one_hot_partial_obs": lambda s: wrappers.one_hot_partial_obs(env).observe(s, cfg)["image"],
        "rgb_img_partial_obs": lambda s: wrappers.rgb_img_partial_obs(env, SURF_TILE).observe(s, cfg)["image"],
        "rgb_img_obs": lambda s: wrappers.rgb_img_obs(env, SURF_TILE).observe(s, cfg)["image"],
        "render_state_highlight": lambda s: render_state(s, cfg, SURF_TILE, highlight=True),
    }
    bad = []
    for name, fn in surfaces.items():
        fn(states)  # warm: the atlas on the card
        ms, got = time_events(lambda: fn(states), SURF_REPS)
        t0 = time.perf_counter()
        want = fn(host)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same = got.device == dev and want.device == cpu and torch.equal(got.cpu(), want)
        print(f"phase 21c: {name} on {SURF_B} lanes, {tuple(got.shape[1:])} {got.dtype} a lane ({got.numel()} B in "
              f"all): card {ms:.4f} ms/call (mean of {SURF_REPS}), {SURF_B / ms * 1e3:.6e} frames/s; CPU {cpu_ms:.4f} "
              f"ms; every lane equal: {same} [{card}]", flush=True)
        if not same:
            bad.append(name)
        del got, want
    if bad:
        raise RuntimeError(f"phase 21c: the card's surfaces differ from the CPU's: {bad}")
    b1 = _time_pass("21c", cfg, fr.packed_init(env, states, "regen"), SURF_CHUNK, dev, card, env.transition, "random")
    return env, carry, states, [counts["rollout_kernel"], *b1, KERNEL_SOURCE]


def _p21_bonus(dev, card, env, states):
    """21d: both count-bonus wrappers on the card against the CPU."""
    import torch

    from minigrid_tpu_torch import wrappers
    from minigrid_tpu_torch.core.state import EnvState

    cpu = torch.device("cpu")
    g = torch.Generator(device=cpu).manual_seed(21)
    actions = torch.randint(0, env.config.num_actions, (BONUS_T, SURF_B), dtype=torch.int32, generator=g)
    for cenv in (wrappers.state_bonus(env), wrappers.action_bonus(env)):
        runs = {}
        for where, d, s in (("card", dev, states), ("cpu", cpu, EnvState(**{k: v.cpu() for k, v in vars(states).items()}))):
            counts, rewards = cenv.init_counts(SURF_B, device=d), []
            t0 = time.perf_counter()
            for t in range(BONUS_T):
                counts, s, _, r, _, _ = cenv.step(counts, s, actions[t].to(d))
                rewards.append(r)
            if d.type == "cuda":
                torch.cuda.synchronize(d)
            runs[where] = (counts.cpu(), torch.stack(rewards).cpu(), time.perf_counter() - t0)
        (c1, r1, s1), (c2, r2, s2) = runs["card"], runs["cpu"]
        same = torch.equal(c1, c2) and torch.equal(r1.view(torch.int32), r2.view(torch.int32))
        kind = "action_bonus" if cenv.keyed_on_action else "state_bonus"
        print(f"phase 21d: {kind} over {SURF_B} lanes × {BONUS_T} steps ({cenv.size} counts a lane): card "
              f"{s1:.4f} s ({SURF_B * BONUS_T / s1:.6e} env-steps/s), CPU {s2:.4f} s; counts sum {int(c1.sum())}, "
              f"reward sum {float(r1.sum()):.6f}; counts equal and rewards bit for bit: {same} [{card}]", flush=True)
        if not same or int(c1.sum()) != SURF_B * BONUS_T:
            raise RuntimeError(f"phase 21d: {kind} on the card differs from the CPU")


def _p21_checkpoint(dev, card, env, carry):
    """21e: checkpoint round trips on the card; each restored carry takes
    one B1 call to the original's carry."""
    import tempfile

    import torch

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.parallel import train as tr
    from minigrid_tpu_torch.parallel.packed import shard_carry
    from minigrid_tpu_torch.parallel.sharding import make_env_mesh
    from minigrid_tpu_torch.utils import checkpoint as ck

    step = fr.build_fused_rollout(env, SURF_CHUNK, mode="regen", as_carry=True, regen_chunk=SURF_CHUNK)
    ts = tr.init_train_state(env, generator=torch.Generator(device=dev).manual_seed(21))
    shards = shard_carry(carry, make_env_mesh([dev, dev]))  # M2: two shards of the card
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, value in (("carry", carry), ("train_state", ts), ("m2_shards", shards)):
            path = os.path.join(tmp, name)
            t0 = time.perf_counter()
            (ck.save_sharded if name == "m2_shards" else ck.save_pytree)(path, value)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = ck.load_sharded(path, value) if name == "m2_shards" else ck.load_pytree(path, value)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            size = (sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) if os.path.isdir(path)
                    else os.path.getsize(path))
            pairs = list(zip(value, back)) if name == "m2_shards" else [(value, back)]
            bad = []
            if name == "train_state":
                got, want = tr.flatten_params(back.params.flax_params()), tr.flatten_params(ts.params.flax_params())
                bad += [] if torch.equal(got.view(torch.int32), want.view(torch.int32)) else ["params"]
                bad += [f for f, a, b in zip(ts.opt_state._fields, ts.opt_state, back.opt_state) if not torch.equal(a, b)]
                bad += [] if next(back.params.parameters()).device == dev else ["device"]
            else:
                for i, (a, b) in enumerate(pairs):
                    bad += [f"{i}.{f}" for f, x, y in zip(a._fields, a, b) if x.device != y.device or not torch.equal(x, y)]
                    k = key(2150 + i, device=dev)
                    _zero_counts()
                    restored = step(k, b)
                    launches += _counts()["rollout_kernel"]
                    bad += [f"{i}.step.{f}" for f in _same_carry_and_metrics(restored, step(k, a))]
            print(f"phase 21e: {name}: {size} B on disk, save {save_s:.4f} s, load {load_s:.4f} s; restored byte for "
                  f"byte{', and one B1 call from it equal to one from the original' if name != 'train_state' else ''}: "
                  f"differing {bad or 'none'} [{card}]", flush=True)
            if bad:
                raise RuntimeError(f"phase 21e: {name} does not round-trip: {bad}")
    if launches == 0:
        raise RuntimeError("phase 21e: the restored carries' calls launched no B1")
    return launches


def _p21_adapter(dev, card):
    """21f: one env through the adapter's per-step path, card and CPU."""
    import numpy as np
    import torch

    from minigrid_tpu_torch import make
    from minigrid_tpu_torch.compat.host_env import HostEnv

    g = np.random.default_rng(21)
    actions = g.integers(0, 7, size=ADAPTER_STEPS)
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        host = HostEnv(make(ADAPTER_ENV_ID), device=d)
        t0 = time.perf_counter()
        out = [host.reset(seed=1337)[0]["image"]]
        reset_s = time.perf_counter() - t0
        out.append(host.render(tile_size=32))  # warm: the tile-32 atlas
        step_s = surf_s = 0.0
        for a in actions:
            t0 = time.perf_counter()
            obs, r, te, tr, _ = host.step(int(a))
            t1 = time.perf_counter()
            frame, text, digest = host.render(tile_size=32), str(host), host.hash()
            t2 = time.perf_counter()
            step_s, surf_s = step_s + t1 - t0, surf_s + t2 - t1
            out += [obs["image"], obs["mission"], r, te, tr, frame, text, digest]
            if te or tr:
                host.reset()
        runs[where] = (out, reset_s, step_s, surf_s)
    (a, reset_card, step_card, surf_card), (b, reset_cpu, step_cpu, surf_cpu) = runs["card"], runs["cpu"]
    same = len(a) == len(b) and all(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y for x, y in zip(a, b))
    n = ADAPTER_STEPS
    print(f"phase 21f: {ADAPTER_ENV_ID} through HostEnv ({n} steps of one env, each followed by render_state at tile "
          f"32, render_ascii and the hash): card reset {reset_card * 1e3:.4f} ms, Env.step {n / step_card:.4f} "
          f"steps/s, with the three surfaces {n / (step_card + surf_card):.4f} steps/s; CPU reset "
          f"{reset_cpu * 1e3:.4f} ms, Env.step {n / step_cpu:.4f} steps/s, with the surfaces "
          f"{n / (step_cpu + surf_cpu):.4f} steps/s; card and CPU equal at every step: {same} [{card}]", flush=True)
    if not same:
        raise RuntimeError("phase 21f: the adapter's path on the card differs from the CPU's")


def _p21_trace(dev, card, env, carry):
    """21g: `tools.profile.trace` around one B1 call."""
    import tempfile

    from minigrid_tpu_torch.core.prng import key
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.tools import profile

    step = fr.build_fused_rollout(env, SURF_CHUNK, mode="regen", as_carry=True, regen_chunk=SURF_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts()
        with profile.trace(tmp):
            with profile.annotate("mg_b1_call"):
                step(key(2170, device=dev), carry)
        launches = _counts()["rollout_kernel"]
        path = os.path.join(tmp, profile.TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel" and "rollout" in e.get("name", "")})
    annotated = any(e.get("name") == "mg_b1_call" for e in events)
    print(f"phase 21g: trace of one B1 call: {size} B, {len(events)} events, the annotation present: {annotated}; "
          f"kernel events naming B1 ({launches} launches): {kernels} [{card}]", flush=True)
    if not kernels or not annotated or launches == 0:
        raise RuntimeError(f"phase 21g: the trace names no B1 kernel ({kernels}) or lacks the annotation")
    return launches


def phase_slice15(dev, card):
    """Phase 21 (module docstring): the user-facing surfaces. Returns
    `{row name: [launches, max_abs_err, ms, plain_ms, bound, source]}`:
    B1 making the states the surfaces render, its launches those of 21c's
    call, 21e's restored carries and 21g's traced call."""
    import torch

    _p21_golden(dev, card)
    _p21_wrapper_golden(dev, card)
    env, carry, states, row = _p21_surfaces(dev, card)
    _p21_bonus(dev, card, env, states)
    del states
    torch.cuda.empty_cache()
    row[0] += _p21_checkpoint(dev, card, env, carry)
    _p21_adapter(dev, card)
    row[0] += _p21_trace(dev, card, env, carry)
    return {"rollout_kernel_surfaces": row}


@contextlib.contextmanager
def _caught_gen_calls(calls):
    """Inside the block, every call of the connect and room-chain kernels'
    wrappers (`ops/gen_kernel.py`, looked up in their module) appends its
    arguments to `calls[name]` and then runs."""
    from minigrid_tpu_torch.ops import gen_kernel as gk

    saved = gk.run_connect_kernel, gk.run_mr_chain_kernel

    def catch(name, run):
        return lambda *args: calls[name].append(args) or run(*args)

    gk.run_connect_kernel = catch("connect_kernel", saved[0])
    gk.run_mr_chain_kernel = catch("mr_chain_kernel", saved[1])
    try:
        yield
    finally:
        gk.run_connect_kernel, gk.run_mr_chain_kernel = saved


def _p22_launches(tag, calls, card):
    """The kernel counts just after a sub-phase, which must equal the calls
    caught at the wrappers."""
    counts = {k: v for k, v in _counts().items() if k.endswith("kernel")}
    print(f"phase {tag}: kernel launches {counts}; calls caught at the wrappers "
          f"{ {k: len(v) for k, v in calls.items()} } [{card}]", flush=True)
    if any(counts[k] != len(v) for k, v in calls.items()):
        raise RuntimeError(f"phase {tag}: the counts {counts} differ from the calls caught")
    return counts


def _p22_benchmark(dev, card):
    """22a: `tools.benchmark.main` on the card, then its batched rollout
    card against CPU."""
    import numpy as np

    from minigrid_tpu_torch.tools import benchmark
    from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_to_numpy

    calls = {"connect_kernel": [], "mr_chain_kernel": []}
    _zero_counts()
    t0 = time.perf_counter()
    with _caught_gen_calls(calls):
        res = benchmark.main(["--num_resets", str(P22_RESETS), "--num_frames", str(P22_FRAMES)])
    seconds = time.perf_counter() - t0
    _p22_launches("22a", calls, card)
    print(f"phase 22a: benchmark.main ({P22_RESETS} resets, {P22_FRAMES} frames, defaults otherwise) in "
          f"{seconds:.4f} s: reset {res.reset_ms:.6f} ms, single-env {res.frames_per_sec:.6f} steps/s, render "
          f"{res.render_fps:.6f} frames/s, batched {res.batched_fps:.6f} env-steps/s; episodes "
          f"{int(res.metrics.episodes)}, total_steps {int(res.metrics.total_steps)} [{card}]", flush=True)
    if res.states.grid.device != dev or not math.isfinite(float(res.metrics.total_reward)):
        raise RuntimeError(f"phase 22a: the batched states lie on {res.states.grid.device} or the reward sum is "
                           f"not finite")
    small = ["--num_resets", "10", "--num_frames", "100", "--batch-size", str(P22_CHECK_B), "--batched-steps",
             str(P22_CHECK_T)]
    runs = [benchmark.main(small + ["--device", d]) for d in (str(dev), "cpu")]
    got, want = (state_to_numpy(r.states) for r in runs)
    bad = [n for n in STATE_FIELDS if not np.array_equal(got[n], want[n])]
    bad += [n for n in ("episodes", "total_steps", "obs_checksum", "reset_overlaps")
            if int(getattr(runs[0].metrics, n)) != int(getattr(runs[1].metrics, n))]
    rewards = [float(r.metrics.total_reward) for r in runs]
    if not math.isclose(rewards[0], rewards[1], rel_tol=1e-6, abs_tol=0.0):
        bad.append("total_reward")
    print(f"phase 22a: the batched rollout at B={P22_CHECK_B}, T={P22_CHECK_T} on {dev} and on the CPU: episodes "
          f"{int(runs[0].metrics.episodes)} and {int(runs[1].metrics.episodes)}, reward sums {rewards[0]!r} and "
          f"{rewards[1]!r}; differing {bad or 'none'} [{card}]", flush=True)
    if bad or runs[0].states.grid.device.type != dev.type:
        raise RuntimeError(f"phase 22a: the card's batched rollout differs from the CPU's: {bad}")


def _p22_run_tests(dev, card):
    """22b: `tools.run_tests.main` over every id on the card. Returns the
    kernel counts and the calls caught."""
    import io

    from minigrid_tpu_torch.envs.registry import env_list
    from minigrid_tpu_torch.tools import run_tests

    calls = {"connect_kernel": [], "mr_chain_kernel": []}
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with _caught_gen_calls(calls), contextlib.redirect_stdout(out):
        run_tests.main(["--steps", str(P22_STEPS)])
    seconds = time.perf_counter() - t0
    counts = _p22_launches("22b", calls, card)
    lines = out.getvalue().splitlines()
    n = len(env_list)
    skipped = [line for line in lines if line.startswith("class wrappers skipped")]
    print(f"phase 22b: run_tests.main over {n} ids ({P22_STEPS} random steps each) in {seconds:.4f} s: ids "
          f"{lines[0]} ... {lines[n - 1]}; then {lines[n:]} [{card}]", flush=True)
    if lines[:n] != list(env_list) or lines[-1] != "all tests passed" or len(skipped) != 1:
        raise RuntimeError(f"phase 22b: run_tests printed {lines[n - 1:]}")
    if not counts["connect_kernel"] or not counts["mr_chain_kernel"]:
        raise RuntimeError(f"phase 22b: KeyCorridor's and MultiRoom's resets launched {counts}")
    return counts, calls


def _p22_manual_control(dev, card):
    """22c: `tools.manual_control.main` with a scripted window, card
    against CPU, with and without the agent's view. Returns the kernel
    counts of the card's runs and the calls caught."""
    import io

    import numpy as np

    from minigrid_tpu_torch.tools import manual_control
    from minigrid_tpu_torch.tools.window import ScriptedWindow

    calls = {"connect_kernel": [], "mr_chain_kernel": []}
    counts = dict.fromkeys(calls, 0)
    for view in ([], ["--agent_view"]):
        windows, outs, secs, envs = {}, {}, {}, {}
        for where in ("card", "cpu"):
            def factory(title, where=where):
                windows[where] = ScriptedWindow(title, P22_KEYS)
                return windows[where]

            caught = {k: [] for k in calls}
            out = io.StringIO()
            _zero_counts()
            t0 = time.perf_counter()
            with (_caught_gen_calls(caught) if where == "card" else contextlib.nullcontext()), \
                    contextlib.redirect_stdout(out):
                envs[where] = manual_control.main(view + ([] if where == "card" else ["--device", "cpu"]),
                                                  window_factory=factory)
            secs[where], outs[where] = time.perf_counter() - t0, out.getvalue()
            if where == "card":
                for k, v in _p22_launches("22c", caught, card).items():
                    if k in counts:
                        counts[k] += v
                        calls[k] += caught[k]
        a, b = windows["card"], windows["cpu"]
        same = (len(a.frames) == len(b.frames) == len(P22_KEYS) and a.captions == b.captions
                and all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames)) and outs["card"] == outs["cpu"])
        print(f"phase 22c: manual_control {' '.join(view) or '(full frame)'} on {envs['card'].fenv.env_id}: "
              f"{len(a.frames)} frames of {a.frames[0].shape}, {len(outs['card'].splitlines())} step lines, the "
              f"window closed: {a.closed}, card {secs['card']:.4f} s and CPU {secs['cpu']:.4f} s; equal: {same} "
              f"[{card}]", flush=True)
        if not same or not a.closed or envs["card"].device != dev:
            raise RuntimeError("phase 22c: the card's frames, captions or step lines differ from the CPU's")
    if not counts["mr_chain_kernel"]:
        raise RuntimeError("phase 22c: MultiRoom-N6's resets launched no room-chain kernel")
    return counts, calls


def _p22_replay(dev, card, calls, launches):
    """22d: every caught call again through the kernel and its plain
    version on the same inputs: the rows of the two kernels at phase 22's
    one-lane shapes."""
    from minigrid_tpu_torch.ops import gen_kernel as gk

    kernels = {"connect_kernel": (gk.run_connect_kernel, gk.plain_connect_plan),
               "mr_chain_kernel": (gk.run_mr_chain_kernel, gk.plain_mr_chain)}
    rows = {}
    for name, (run, plain) in kernels.items():
        args_list = calls[name]
        err, nbytes, ops, bad = 0.0, 0.0, 0.0, 0
        for args in args_list:
            got, want = run(*args), plain(*args)
            bad += sum(int((g != w).sum()) for g, w in zip(got, want))
            err = max([err] + [float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)])
            b = args[0].shape[1]
            if name == "connect_kernel":
                rc = args[5] * args[6]
                ops += (CONNECT_OPS_PER_DRAW_BASE + CONNECT_OPS_PER_FLOOD_STEP * rc) * float(want[2].double().sum())
                nbytes += 4 * (2 + 3 + 4) * b + 4 * (4 + rc * 4 + 1) * b
            else:
                att, rws = float(want[2].double().sum()), float(want[3].double().sum())
                ops += rws * MR_OPS_PER_ROW + (rws - 4 * att) / 5 * MR_OPS_PER_TRY + att * MR_OPS_PER_ATTEMPT
                nbytes += 4 * 3 * b + 4 * (6 * args[2].max_num_rooms + 3) * b
        n = len(args_list)
        ms, _ = time_events(lambda: [run(*a) for a in args_list], P22_TIMED)
        plain_ms, _ = time_events(lambda: [plain(*a) for a in args_list], 1)
        bnd = bound(nbytes / n, ops / n, int_issue_rate(dev))
        shapes = sorted({(a[0].shape[1],) + ((a[5], a[6]) if name == "connect_kernel" else (a[2].max_num_rooms,))
                         for a in args_list})
        print(f"phase 22d: {name} on the {n} calls caught on phase 22's path (lanes and room grid or most rooms: "
              f"{shapes}): {ms / n:.6f} ms a call, plain {plain_ms / n:.4f} ms; bound {bnd[0]:.6e} ms "
              f"({bnd[1]}); differing values {bad}, max_abs_err {err} [{card}]", flush=True)
        if bad:
            raise RuntimeError(f"phase 22d: {name} differs from its plain version on phase 22's inputs")
        rows[f"{name}_one_env"] = [launches[name], err, ms / n, plain_ms / n, bnd, GEN_SOURCE]
    return rows


def phase_slice16(dev, card):
    """Phase 22 (module docstring): the root scripts. Returns the rows of
    the connect and room-chain kernels at the path's one-lane shapes."""
    _p22_benchmark(dev, card)
    (counts_b, calls_b), (counts_c, calls_c) = _p22_run_tests(dev, card), _p22_manual_control(dev, card)
    names = ("connect_kernel", "mr_chain_kernel")
    launches = {k: counts_b[k] + counts_c[k] for k in names}
    return _p22_replay(dev, card, {k: calls_b[k] + calls_c[k] for k in names}, launches)


def run_phase(label, fn, *args):
    """`fn(*args)`, then the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: wall {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card", file=sys.stderr)
        return 2
    from minigrid_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds} s; library {_build.library_path().name})", flush=True)
    if _build.last_build_log:
        print(_build.last_build_log.strip(), flush=True)
        compiler_report(_build.last_build_log)
    else:
        print("phase 1: the library came from the build cache: no compiler report", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twins' f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    launches, err2, kernel_ms, plain_ms = run_phase("2", phase_main_path, dev, card)
    torch.cuda.empty_cache()
    err3 = run_phase("3 (rollout kernel)", phase_kernel_vs_plain, dev, card)
    probe_err, probe_ms, probe_plain_ms, probe_library_ms = run_phase("3 (probe)", phase_probe, dev, card)
    torch.cuda.empty_cache()
    env, model, warm_carry, policy_launches, _, _ = run_phase("4", phase_policy_main_path, dev, card)
    policy_err, policy_ms, policy_plain_ms, _ = run_phase("5", phase_policy_vs_plain, dev, card, env, model,
                                                           warm_carry)
    del env, model, warm_carry
    torch.cuda.empty_cache()
    env, ts, warm_carry, train_launches, _, _ = run_phase("6", phase_train_main_path, dev, card)
    torch.cuda.empty_cache()
    collect_err, collect_ms, collect_plain_ms, grad_err, grad_ms, grad_plain_ms, g2_library_ms = run_phase(
        "7", phase_train_vs_plain, dev, card, env, ts, warm_carry
    )
    del env, ts, warm_carry
    torch.cuda.empty_cache()
    env, warm_carry, reset_carry, kc_launches, _, _ = run_phase("8", phase_kc_main_path, dev, card)
    (b4_err, b4_ms, b4_plain_ms, b4_bound), (b1h_err, b1h_ms, b1h_plain_ms, b1h_bound) = run_phase(
        "9", phase_kc_vs_plain, dev, card, env, warm_carry, reset_carry
    )
    del env, warm_carry, reset_carry
    torch.cuda.empty_cache()
    env, _, rand, policy = run_phase("10", phase_mr_main_path, dev, card)
    mr_launches = {"a": rand[2], "b": policy[2]}
    chain, (b1c_err, b1c_ms, b1c_plain_ms, b1c_bound), (b2c_err, b2c_ms, b2c_plain_ms, b2c_bound) = run_phase(
        "11", phase_mr_vs_plain, dev, card, env, rand, policy)
    del env, rand, policy
    torch.cuda.empty_cache()
    kc, kc_model, rt_runs = run_phase("12", phase_regen_policy_main_path, dev, card)
    rt = run_phase("13", phase_regen_policy_vs_plain, dev, card, kc, kc_model, rt_runs)
    rt_launches = {
        "hook": rt_runs["kc_eval"][2]["policy_kernel"],
        "collect_ctl": rt_runs["train_b"][3]["policy_kernel"] + rt_runs["train_c"][3]["policy_kernel"],
    }
    del kc, kc_model, rt_runs
    torch.cuda.empty_cache()
    mosaic_launches, mosaic_err, mosaic_ms, mosaic_plain_ms, mosaic_bound = run_phase("14", phase_mosaic_probe, dev,
                                                                                       card)
    torch.cuda.empty_cache()
    dk_runs = run_phase("15 (a, b)", phase_doorkey_main_path, dev, card)
    (dk_err, dk_ms, dk_plain_ms, dk_bound), dk_rand = run_phase("15 (c-e)", phase_doorkey_vs_plain, dev, card, dk_runs)
    dk_launches = dk_runs["train"][2]["policy_kernel"]
    dk_rand_launches = dk_runs["rand"][2]["rollout_kernel"]
    del dk_runs
    torch.cuda.empty_cache()
    hook_rows = run_phase("16", phase_hooks, dev, card)
    torch.cuda.empty_cache()
    new_rows = run_phase("17", phase_new_hooks, dev, card)
    torch.cuda.empty_cache()
    new_rows.update(run_phase("18", phase_slice12, dev, card))
    torch.cuda.empty_cache()
    new_rows.update(run_phase("19", phase_slice13, dev, card))
    torch.cuda.empty_cache()
    rows20, probes20 = run_phase("20", phase_slice14, dev, card)
    new_rows.update(rows20)
    torch.cuda.empty_cache()
    new_rows.update(run_phase("21", phase_slice15, dev, card))
    torch.cuda.empty_cache()
    new_rows.update(run_phase("22", phase_slice16, dev, card))
    hook_kernels = []
    for transition, row in hook_rows.items():
        for kernel, (launches_, err_, ms_, plain_ms_, bnd_) in row.items():
            source, replaces = ((KERNEL_SOURCE, KERNEL_REPLACES) if kernel == "rollout"
                                else (POLICY_HOOK_SOURCES[transition], POLICY_REPLACES))
            hook_kernels.append({
                "name": f"{kernel}_kernel_{transition}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches_,
                "max_abs_err": err_,
                "ms": ms_,
                "plain_ms": plain_ms_,
                "bound_ms": bnd_[0],
                "bound_by": bnd_[1],
                "library_ms": None,
            })

    from minigrid_tpu_torch.ops import policy_rollout as pr

    from minigrid_tpu_torch import make

    main_cfg = make(ENV_ID).config  # Empty-8x8: no occlusion, no hook, no commit rows
    v2 = main_cfg.agent_view_size ** 2
    rollout_bound = b1_bound(main_cfg, MAIN_B, MAIN_T, dev, ctl=False, hook=False)
    policy_bound = b2_bound(main_cfg, MAIN_B, POLICY_T, collect=False, ctl=False)
    # The train path at its own shape: the collecting kernel adds its
    # spill's writes (`b2_bound`); the gradient kernel as `grad_bound`
    # counts it, and the dense count for comparison.
    spill_bytes = 4 * pr._spill_rows(v2) * TRAIN_B * TRAIN_T
    collect_bound = b2_bound(main_cfg, TRAIN_B, TRAIN_T, collect=True, ctl=False)
    h, k_dense = pr.HIDDEN, v2 * 20
    grad_flop_dense = (2 * k_dense * h + 2 * h * h + 2 * pr.HEAD_ROWS * h) + (
        4 * pr.HEAD_ROWS * h + 4 * h * h + 2 * k_dense * h
    )
    train_grad_bound = grad_bound(main_cfg.agent_view_size, TRAIN_B, TRAIN_T)
    grad_dense_ms = grad_flop_dense * TRAIN_B * TRAIN_T / BF16_FLOP_PER_S * 1e3
    print(f"bounds [{card}]: policy_kernel collect {collect_bound} (spill {spill_bytes} B), grad_kernel "
          f"{train_grad_bound} ({grad_flop(main_cfg.agent_view_size)} FLOP per sample with layer 1 by its active "
          f"rows; dense {grad_flop_dense} FLOP per sample, {grad_dense_ms:.4f} ms)", flush=True)
    probe_n = 8 * 128
    probe_bound = bound(2 * 4 * probe_n, probe_n, int_issue_rate(dev))
    print(f"bounds [{card}]: rollout_kernel {rollout_bound} ({rollout_instr(main_cfg, False)} instructions per "
          f"lane-step), policy_kernel {policy_bound} ({policy_flop(main_cfg.agent_view_size)} FLOP per lane-step), "
          f"probe_kernel {probe_bound}", flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "rollout_kernel",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches["rollout_kernel"],
            "max_abs_err": max(err2, err3),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": rollout_bound[0],
            "bound_by": rollout_bound[1],
            "library_ms": None,
        },
        {
            "name": "probe_kernel",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": PROBE_REPLACES,
            "launches": launches["probe_kernel"],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
            "bound_ms": probe_bound[0],
            "bound_by": probe_bound[1],
            "library_ms": probe_library_ms,
        },
        *({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": PROBE_REPLACES,
            "launches": launches_,
            "max_abs_err": err_,
            "ms": ms_,
            "plain_ms": plain_ms_,
            "bound_ms": probe_bound[0],
            "bound_by": probe_bound[1],
            "library_ms": library_ms_,
        } for name, (launches_, err_, ms_, plain_ms_, library_ms_) in probes20.items()),
        {
            "name": "policy_kernel",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": policy_launches,
            "max_abs_err": policy_err,
            "ms": policy_ms,
            "plain_ms": policy_plain_ms,
            "bound_ms": policy_bound[0],
            "bound_by": policy_bound[1],
            "library_ms": None,
        },
        {
            "name": "policy_kernel_collect",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": train_launches["policy_kernel"],
            "max_abs_err": collect_err,
            "ms": collect_ms,
            "plain_ms": collect_plain_ms,
            "bound_ms": collect_bound[0],
            "bound_by": collect_bound[1],
            "library_ms": None,
        },
        {
            "name": "grad_kernel",
            "route": "cuda",
            "source": GRAD_SOURCE,
            "replaces": GRAD_REPLACES,
            "launches": train_launches["grad_kernel"],
            "max_abs_err": grad_err,
            "ms": grad_ms,
            "plain_ms": grad_plain_ms,
            "bound_ms": train_grad_bound[0],
            "bound_by": train_grad_bound[1],
            "library_ms": g2_library_ms,
        },
        {
            "name": "rollout_kernel_hook_ctl",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": kc_launches["rollout_kernel"],
            "max_abs_err": b1h_err,
            "ms": b1h_ms,
            "plain_ms": b1h_plain_ms,
            "bound_ms": b1h_bound[0],
            "bound_by": b1h_bound[1],
            "library_ms": None,
        },
        {
            "name": "connect_kernel",
            "route": "cuda",
            "source": GEN_SOURCE,
            "replaces": GEN_REPLACES,
            "launches": kc_launches["connect_kernel"],
            "max_abs_err": b4_err,
            "ms": b4_ms,
            "plain_ms": b4_plain_ms,
            "bound_ms": b4_bound[0],
            "bound_by": b4_bound[1],
            "library_ms": None,
        },
        *({
            "name": name,
            "route": "cuda",
            "source": GEN_SOURCE,
            "replaces": MR_REPLACES,
            "launches": launches,
            "max_abs_err": chain[env_id][0],
            "ms": chain[env_id][1],
            "plain_ms": chain[env_id][2],
            "bound_ms": chain[env_id][3][0],
            "bound_by": chain[env_id][3][1],
            "library_ms": None,
        } for name, env_id, launches in zip(
            ("mr_chain_kernel", "mr_chain_kernel_n6"), MR_CHAIN_IDS,
            (mr_launches["a"]["mr_chain_kernel"] + mr_launches["b"]["mr_chain_kernel"], 0))),
        {
            "name": "rollout_kernel_ctl",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": mr_launches["a"]["rollout_kernel"],
            "max_abs_err": b1c_err,
            "ms": b1c_ms,
            "plain_ms": b1c_plain_ms,
            "bound_ms": b1c_bound[0],
            "bound_by": b1c_bound[1],
            "library_ms": None,
        },
        {
            "name": "policy_kernel_ctl",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": mr_launches["b"]["policy_kernel"],
            "max_abs_err": b2c_err,
            "ms": b2c_ms,
            "plain_ms": b2c_plain_ms,
            "bound_ms": b2c_bound[0],
            "bound_by": b2c_bound[1],
            "library_ms": None,
        },
        {
            "name": "policy_kernel_hook",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": rt_launches["hook"],
            "max_abs_err": rt["hook_ctl"][0],
            "ms": rt["hook_ctl"][1],
            "plain_ms": rt["hook_ctl"][2],
            "bound_ms": rt["hook_ctl"][3][0],
            "bound_by": rt["hook_ctl"][3][1],
            "library_ms": None,
        },
        {
            "name": "policy_kernel_collect_ctl",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": rt_launches["collect_ctl"],
            "max_abs_err": max(rt["collect_ctl"][0], rt["hook_collect_ctl"][0]),
            "ms": rt["collect_ctl"][1],
            "plain_ms": rt["collect_ctl"][2],
            "bound_ms": rt["collect_ctl"][3][0],
            "bound_by": rt["collect_ctl"][3][1],
            "library_ms": None,
        },
        {
            "name": "policy_kernel_collect_ctl_bt64",
            "route": "cuda",
            "source": POLICY_SOURCE,
            "replaces": POLICY_REPLACES,
            "launches": dk_launches,
            "max_abs_err": dk_err,
            "ms": dk_ms,
            "plain_ms": dk_plain_ms,
            "bound_ms": dk_bound[0],
            "bound_by": dk_bound[1],
            "library_ms": None,
        },
        {
            "name": "rollout_kernel_ctl_doorkey",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": dk_rand_launches,
            "max_abs_err": dk_rand[0],
            "ms": dk_rand[1],
            "plain_ms": dk_rand[2],
            "bound_ms": dk_rand[3][0],
            "bound_by": dk_rand[3][1],
            "library_ms": None,
        },
        *hook_kernels,
        *({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": GRAD_REPLACES if name.startswith("grad") else GEN_REPLACES if name.startswith("connect") else (
                MR_REPLACES if name.startswith("mr_chain") else
                KERNEL_REPLACES if name.startswith("rollout") else POLICY_REPLACES),
            "launches": launches_,
            "max_abs_err": err_,
            "ms": ms_,
            "plain_ms": plain_ms_,
            "bound_ms": bnd_[0],
            "bound_by": bnd_[1],
            "library_ms": None,
        } for name, (launches_, err_, ms_, plain_ms_, bnd_, source) in new_rows.items()),
        {
            "name": "mosaic_probe_kernel",
            "route": "cuda",
            "source": PROBE_MOSAIC_SOURCE,
            "replaces": PROBE_MOSAIC_REPLACES,
            "launches": mosaic_launches,
            "max_abs_err": mosaic_err,
            "ms": mosaic_ms,
            "plain_ms": mosaic_plain_ms,
            "bound_ms": mosaic_bound[0],
            "bound_by": mosaic_bound[1],
            "library_ms": None,
        },
    ]}), flush=True)
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s, the build included [{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
