// Per-lane packed-step code shared by the port's kernels (rollout_kernel.cu
// and policy_kernel.cu): the 7-action transition, the forward-cell
// write-back, the re-centring on a forward move, template auto-reset, and
// the V*V egocentric view read with out-of-bounds wall fill, the
// carried-object overlay and the occlusion flood, with every family hook
// of the JAX package (the nine post-hooks, the two action remaps and the
// DynamicObstacles pre-hook) and the chunked-regen commit rows. The JAX
// package's counterparts are `_step_core` and `_obs_core` in
// minigrid_tpu/ops/fused_rollout.py.
//
// One thread owns one lane. Its grid lives in shared memory as a column of
// a [HW][bt] int32 block: row r at g[r * bt]. The TPU kernel rolls the
// whole grid on every forward move only to make its addresses static; here
// the thread keeps a row offset instead (logical row s is physical row
// (s + shift) % HW), undone when the words are stored. Every modulo operand
// is non-negative (shift and table offsets lie in [0, HW)), so C++'s
// truncating % never meets a negative value.
//
// The reward 1 - 0.9 * (sc / max_steps) is computed with round-to-nearest
// intrinsics, one operation at a time, so nvcc cannot contract it into a
// fused multiply-add: per-lane sums match the plain version bit for bit.

#pragma once

#include <cstddef>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kEmpty = 1;
constexpr int kWall = 2;
constexpr int kFloor = 3;
constexpr int kDoor = 4;
constexpr int kKey = 5;
constexpr int kBall = 6;
constexpr int kBox = 7;
constexpr int kGoal = 8;
constexpr int kLava = 9;
constexpr int kStateOpen = 0;
constexpr int kStateLocked = 2;
constexpr int kGrey = 5;
constexpr int kWallWord = kWall | (kGrey << 4);
constexpr int kEmptyWord = kEmpty;
constexpr int kBlue = 2;
constexpr int kBallWord = kBall | (kBlue << 4);  // a DynamicObstacles obstacle
constexpr int kNumScalars = 8;  // x, y, dir, ct, cc, cct, ccc, step_count

// The static shape of a rollout: grid, view and episode length; the
// DynamicObstacles count, and the first of the two rng rows (num_regs - 2).
struct StepShape {
  int width, height, hw, view, max_steps, see_through_walls, n_obst, rng_row;
};

// A lane's scalar registers, its grid's row offset, and the aux rows the
// hooks read (those of the current episode): aux0 and aux1 always, aux2 and
// aux3 only under the hooks that read them (kReadsAux23), so that the
// other instantiations keep their register count. Under the
// DynamicObstacles hook, the episode's rng words and the lane's column of
// obstacle rows in shared memory (stride bt): rows 0..2n-1 hold the
// committed (x, y) of each obstacle, rows 2n..4n-1 the walk's new ones
// until the step commits.
struct Lane {
  int x, y, d, ct, cc, cct, ccc, sc;
  int shift;  // logical row s is physical row (s + shift) % hw
  int aux0, aux1, aux2, aux3;
  uint32_t k0, k1;
  int32_t* ob;
};

__device__ __forceinline__ int wrap_row(int p, int hw) { return p >= hw ? p - hw : p; }

// A lane's grid column in shared memory as int32 words, row r at g[r * bt]
// (the policy kernel's layout, and the rollout kernel's generic one). The
// step reads and writes the grid only through these members; the rollout
// kernel's 16-bit cells (rollout_kernel.cuh::Grid16) have the same ones.
struct GridI32 {
  int32_t* g;
  int bt;
  __device__ __forceinline__ int load(int r) const { return g[r * bt]; }
  __device__ __forceinline__ void store(int r, int w) { g[r * bt] = w; }
  // The physical row of the agent's cell (x, y) as loaded: the words are
  // kept as they come, centred on the agent.
  __device__ __forceinline__ int agent_row(int, int, const StepShape&) const { return 0; }
  // The rows of a template reset that this thread writes: all of them.
  __device__ __forceinline__ int first_row() const { return 0; }
  __device__ __forceinline__ int row_step() const { return 1; }
  // Between the step's reads and its first write (one thread a lane: none).
  __device__ __forceinline__ void sync() const {}
};

// Type + colour + state of a packed cell word: what the checksum counts.
__device__ __forceinline__ int tcs(int w) { return (w & 15) + ((w >> 4) & 15) + ((w >> 8) & 15); }

__device__ __forceinline__ bool transparent(int w) {
  const int t = w & 15;
  const int s = (w >> 8) & 15;
  return !(t == kWall || (t == kDoor && s != kStateOpen));
}

// Family hooks after the base transition (ops/packed_hooks.py; the JAX
// package's ops/packed_hooks.py). The id is a template parameter of the
// kernels, so the base step compiles without any hook code.
constexpr int kHookNone = 0;
constexpr int kHookPickupTarget = 1;  // _hook_pickup_target
constexpr int kHookFetch = 2;         // _hook_fetch
constexpr int kHookGoToDoor = 3;      // _hook_gotodoor
constexpr int kHookGoToObject = 4;    // _hook_gotoobject
constexpr int kHookPutNear = 5;       // _hook_putnear
constexpr int kHookRedBlueDoors = 6;  // _hook_redbluedoors
constexpr int kHookMemory = 7;        // _hook_memory, _remap_memory
constexpr int kHookUnlock = 8;        // _hook_unlock
constexpr int kHookDynamicObstacles = 9;  // _make_pre_dynamicobstacles, _hook_dynamicobstacles,
                                          // _remap_dynamicobstacles

template <int kHook>
constexpr bool kReadsAux23 = kHook == kHookPutNear || kHook == kHookRedBlueDoors || kHook == kHookMemory;

// The episode's rng words and obstacle rows from the (num_regs, B)
// registers `regs` (the live ones, or the template's on a reset).
__device__ __forceinline__ void load_obstacles(const int32_t* regs, size_t B, int lane, int bt,
                                               const StepShape& sh, Lane& s) {
  s.k0 = static_cast<uint32_t>(regs[sh.rng_row * B + lane]);
  s.k1 = static_cast<uint32_t>(regs[(sh.rng_row + 1) * B + lane]);
  for (int r = 0; r < 2 * sh.n_obst; ++r) s.ob[r * bt] = regs[(kNumScalars + r) * B + lane];
}

// Load lane `lane`'s scalars, aux rows and (under the DynamicObstacles hook,
// into the lane's obstacle column `s.ob`) obstacles from the (num_regs, B)
// registers.
template <int kHook>
__device__ __forceinline__ void load_regs(const int32_t* regs, size_t B, int lane, int bt, const StepShape& sh,
                                          Lane& s) {
  s.x = regs[0 * B + lane];
  s.y = regs[1 * B + lane];
  s.d = regs[2 * B + lane];
  s.ct = regs[3 * B + lane];
  s.cc = regs[4 * B + lane];
  s.cct = regs[5 * B + lane];
  s.ccc = regs[6 * B + lane];
  s.sc = regs[7 * B + lane];
  s.shift = 0;
  s.aux0 = regs[kNumScalars * B + lane];
  s.aux1 = regs[(kNumScalars + 1) * B + lane];
  if constexpr (kReadsAux23<kHook>) {
    s.aux2 = regs[(kNumScalars + 2) * B + lane];
    s.aux3 = regs[(kNumScalars + 3) * B + lane];
  }
  if constexpr (kHook == kHookDynamicObstacles) load_obstacles(regs, B, lane, bt, sh, s);
}

// Load lane `lane`'s grid column (g) and scalars from the (HW, B) words and
// (num_regs, B) registers. Under the DynamicObstacles hook `s.ob` must
// point at the lane's obstacle column already.
template <int kHook>
__device__ __forceinline__ void load_lane(int32_t* g, int bt, const int32_t* words,
                                          const int32_t* regs, size_t B, int lane,
                                          const StepShape& sh, Lane& s) {
  for (int r = 0; r < sh.hw; ++r) g[r * bt] = words[r * B + lane];
  load_regs<kHook>(regs, B, lane, bt, sh, s);
}

// int32 arithmetic that wraps as the reference's does (aux rows may hold
// any value): a - b, a + b, and |a| (the most negative value stays itself).
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<uint32_t>(a)) : a;
}

// The physical row of the absolute cell (ax, ay): logical row
// ((ay * W + ax) - base) mod HW (a floor modulo of the wrapped int32, as
// the reference's `_read_abs`), base the agent's pre-step cell, then the
// lane's row offset.
__device__ __forceinline__ int abs_row(const Lane& s, const StepShape& sh, int ax, int ay) {
  const int flat = wsub(static_cast<int>(static_cast<uint32_t>(ay) * static_cast<uint32_t>(sh.width) +
                                         static_cast<uint32_t>(ax)),
                        s.y * sh.width + s.x);
  int m = flat % sh.hw;
  if (m < 0) m += sh.hw;
  return wrap_row(m + s.shift, sh.hw);
}

__device__ __forceinline__ bool door_open(int w) {
  return (w & 15) == kDoor && ((w >> 8) & 15) == kStateOpen;
}

// The DynamicObstacles walk (the pre-hook), without a grid write: each
// obstacle i in turn draws hash_u31(k0, k1, sc * n + i) and moves to the
// draw's pick (u % count) among the valid cells of its 3x3 box in
// row-major (dy, dx) order, or stays when none is valid. A cell is valid if
// it is interior, not the goal (w - 2, h - 2), not the agent's, and no
// obstacle's current cell: those before i at their new cells, i and those
// after at their old ones (so staying is never a candidate). Validity comes
// from the registers, as in the reference. The new cells go to rows 2n..4n-1
// of the lane's obstacle column. Returns the forward word after the walk's
// writes, in their order (obstacle i empties its old cell, then fills its
// new one): `fw` is the word before them, `fp` the forward cell's physical
// row.
__device__ __forceinline__ int obstacle_walk(const Lane& s, const StepShape& sh, int bt, int fp, int fw) {
  const int n = sh.n_obst;
  const int32_t* cur = s.ob;
  int32_t* nxt = s.ob + 2 * n * bt;
  const uint32_t c0 = static_cast<uint32_t>(s.sc) * static_cast<uint32_t>(n);
  for (int i = 0; i < n; ++i) {
    const int u = hash_u31(s.k0, s.k1, c0 + static_cast<uint32_t>(i));
    const int ox = cur[2 * i * bt];
    const int oy = cur[(2 * i + 1) * bt];
    // Bit (dy + 1) * 3 + (dx + 1) stands for the cell (ox + dx, oy + dy).
    uint32_t valid = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int nx = wadd(ox, k % 3 - 1);
      const int ny = wadd(oy, k / 3 - 1);
      const bool ok = nx >= 1 && nx <= sh.width - 2 && ny >= 1 && ny <= sh.height - 2 &&
                      !(nx == sh.width - 2 && ny == sh.height - 2) && !(nx == s.x && ny == s.y);
      valid |= static_cast<uint32_t>(ok) << k;
    }
    for (int j = 0; j < n; ++j) {
      const int32_t* o = j < i ? nxt : cur;
      const int dx = wsub(o[2 * j * bt], ox);
      const int dy = wsub(o[(2 * j + 1) * bt], oy);
      if (dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1) valid &= ~(1u << ((dy + 1) * 3 + dx + 1));
    }
    int nx = ox;
    int ny = oy;
    const int count = __popc(valid);
    if (count > 0) {
      uint32_t m = valid;
      for (int r = u % count; r > 0; --r) m &= m - 1;  // drop the r lowest valid cells
      const int k = __ffs(m) - 1;
      nx = wadd(ox, k % 3 - 1);
      ny = wadd(oy, k / 3 - 1);
    }
    nxt[2 * i * bt] = nx;
    nxt[(2 * i + 1) * bt] = ny;
    if (abs_row(s, sh, ox, oy) == fp) fw = kEmptyWord;
    if (abs_row(s, sh, nx, ny) == fp) fw = kBallWord;
  }
  return fw;
}

// The walk's writes, once the step commits, in the reference's order: each
// obstacle empties its old cell and fills its new one; the new cells become
// the committed ones.
template <class Grid>
__device__ __forceinline__ void commit_walk(Grid& grid, int bt, const StepShape& sh, Lane& s) {
  const int n = sh.n_obst;
  for (int i = 0; i < n; ++i) {
    const int nx = s.ob[(2 * n + 2 * i) * bt];
    const int ny = s.ob[(2 * n + 2 * i + 1) * bt];
    grid.store(abs_row(s, sh, s.ob[2 * i * bt], s.ob[(2 * i + 1) * bt]), kEmptyWord);
    grid.store(abs_row(s, sh, nx, ny), kBallWord);
    s.ob[2 * i * bt] = nx;
    s.ob[(2 * i + 1) * bt] = ny;
  }
}

// A lane's exact-chunked-regen commit rows (ops/chunked_regen.py,
// invariants I2-I3): this launch's template used, steps committed toward
// the chunk, lane frozen for the rest of the launch.
struct Ctl {
  int consumed, steps_done, frozen;
};

// One transition under action `a` on the lane's grid `grid` (GridI32, or
// the rollout kernel's Grid16), the family hooks `kHook` (the action
// remap and the pre-hook before the base transition, the post-hook after
// it, which sees the original action), then template auto-reset; `bt` is
// the stride of the lane's obstacle rows. `tab` holds off_fwd (4 entries)
// then off_view (4 * V * V). Sets `reward` and `done` (terminated or
// truncated, so the lane was reset) and returns true if the step was
// committed. Every thread that runs a lane runs this step alike; the
// grid's writes come after `grid.sync()`, and a reset's rows are split
// over the lane's threads (`first_row`, `row_step`).
//
// With kCtl the step runs under the commit protocol: it is skipped once
// the lane has committed `chunk_len` steps or is frozen, and a step that
// ends an episode while this launch's template is already consumed
// freezes the lane and is discarded whole. So `done` is decided before the
// grid is written: nothing of a step that is not committed is left behind,
// and it adds 0 to reward, episodes and checksum. The pre-hook's walk is
// computed first and written only on commit, so it too leaves no trace.
template <int kHook, bool kCtl, class Grid>
__device__ __forceinline__ bool step_lane_grid(Grid& grid, int bt, const int32_t* tab,
                                               const int32_t* tmpl_words, const int32_t* tmpl_regs,
                                               size_t B, int lane, const StepShape& sh, int a,
                                               int chunk_len, Lane& s, Ctl& ctl, float& reward,
                                               bool& done) {
  reward = 0.0f;
  done = false;
  if (kCtl && (ctl.steps_done >= chunk_len || ctl.frozen != 0)) return false;
  const int hw = sh.hw;
  const int fp = wrap_row(s.shift + tab[s.d], hw);  // forward cell, physical row
  int fw = grid.load(fp);
  bool not_clear = false;  // the forward cell before the walk is blocked
  if constexpr (kHook == kHookDynamicObstacles) {
    not_clear = (fw & 15) != kEmpty && (fw & 15) != kGoal;
    fw = obstacle_walk(s, sh, bt, fp, fw);
  }
  // The remapped action drives the base transition; the hooks read `a_orig`.
  const int a_orig = a;
  if constexpr (kHook == kHookMemory) a = a == 3 ? 5 : a;
  if constexpr (kHook == kHookDynamicObstacles) a = a >= 3 ? 0 : a;
  const int ft = fw & 15;
  const int fc = (fw >> 4) & 15;
  const int fs = (fw >> 8) & 15;
  const int fct = (fw >> 12) & 15;
  const int fcc = (fw >> 16) & 15;

  const bool is_fwd = a == 2;
  const int d1 = a == 1 ? (s.d + 1) % 4 : (a == 0 ? (s.d + 3) % 4 : s.d);
  const bool can_overlap = ft == kEmpty || ft == kFloor || ft == kGoal || ft == kLava ||
                           (ft == kDoor && fs == kStateOpen);
  const bool moves = is_fwd && can_overlap;
  const int dirx = (s.d == 0) - (s.d == 2);
  const int diry = (s.d == 1) - (s.d == 3);

  const int sc1 = s.sc + 1;
  const bool hit_goal = is_fwd && ft == kGoal;
  bool terminated = hit_goal || (is_fwd && ft == kLava);
  const float success = __fsub_rn(
      1.0f, __fmul_rn(0.9f, __fdiv_rn(static_cast<float>(sc1), static_cast<float>(sh.max_steps))));
  float r = hit_goal ? success : 0.0f;

  const bool hands_empty = s.ct == 0;
  const bool do_pickup = a == 3 && (ft == kKey || ft == kBall || ft == kBox) && hands_empty;
  const bool do_drop = a == 4 && ft == kEmpty && !hands_empty;
  const bool is_toggle = a == 5;

  uint32_t new_fwd = static_cast<uint32_t>(fw);
  if (do_pickup) new_fwd = kEmptyWord;
  if (do_drop) {
    new_fwd = static_cast<uint32_t>(s.ct) | (static_cast<uint32_t>(s.cc) << 4) |
              (static_cast<uint32_t>(s.cct) << 12) | (static_cast<uint32_t>(s.ccc) << 16);
  }
  if (is_toggle && ft == kDoor) {
    const bool has_key = s.ct == kKey && s.cc == fc;
    const int state = fs == kStateLocked ? (has_key ? kStateOpen : kStateLocked) : 1 - fs;
    new_fwd = (static_cast<uint32_t>(fw) & ~(15u << 8)) | (static_cast<uint32_t>(state) << 8);
  }
  if (is_toggle && ft == kBox) {
    new_fwd = static_cast<uint32_t>(fct > 0 ? fct : kEmptyWord) | (static_cast<uint32_t>(fcc) << 4);
  }

  const int ct1 = do_pickup ? ft : (do_drop ? 0 : s.ct);
  const int cc1 = do_pickup ? fc : (do_drop ? 0 : s.cc);
  const int cct1 = do_pickup ? fct : (do_drop ? 0 : s.cct);
  const int ccc1 = do_pickup ? fcc : (do_drop ? 0 : s.ccc);

  if constexpr (kHook == kHookPickupTarget) {
    // A pickup that leaves the agent carrying the aux target succeeds.
    if (a_orig == 3 && ct1 == s.aux0 && cc1 == s.aux1) {
      r = success;
      terminated = true;
    }
  }
  if constexpr (kHook == kHookFetch) {
    // Any pickup ends the episode, rewarded iff it is the aux target.
    if (ct1 > 0) {
      r = ct1 == s.aux0 && cc1 == s.aux1 ? success : 0.0f;
      terminated = true;
    }
  }
  if constexpr (kHook == kHookGoToDoor || kHook == kHookGoToObject) {
    // `done` near the target (aux0, aux1) at the post-step position
    // rewards; `done` and `toggle` end the episode. GoToDoor's near is
    // cross-adjacent, GoToObject's within one cell.
    const int dx = wabs(wsub(moves ? s.x + dirx : s.x, s.aux0));
    const int dy = wabs(wsub(moves ? s.y + diry : s.y, s.aux1));
    const bool near = kHook == kHookGoToDoor ? (dx == 0 && dy == 1) || (dy == 0 && dx == 1)
                                             : dx <= 1 && dy <= 1;
    if (a_orig == 6 && near) r = success;
    terminated = terminated || a_orig == 6 || a_orig == 5;
  }
  if constexpr (kHook == kHookPutNear) {
    // A pickup action while holding anything but the aux object (aux0,
    // aux1) ends the episode; so does a drop after carrying, rewarded iff
    // it landed in the pre-step forward cell within one cell of the
    // target (aux2, aux3).
    const bool wrong = ct1 > 0 && (ct1 != s.aux0 || cc1 != s.aux1);
    const bool dropped = s.ct > 0 && a_orig == 4;
    const bool near = wabs(wsub(s.x + dirx, s.aux2)) <= 1 && wabs(wsub(s.y + diry, s.aux3)) <= 1;
    if (dropped && ct1 == 0 && near) r = success;
    terminated = terminated || (a_orig == 3 && wrong) || dropped;
  }
  if constexpr (kHook == kHookRedBlueDoors) {
    // The red door (aux0, aux1) and the blue door (aux2, aux3) before and
    // after this step's forward-cell write, which has not happened yet:
    // after it a cell reads the new forward word if it is the forward
    // cell, else its stored word.
    const int red_row = abs_row(s, sh, s.aux0, s.aux1);
    const int blue_row = abs_row(s, sh, s.aux2, s.aux3);
    const int red_w = grid.load(red_row);
    const int blue_w = grid.load(blue_row);
    const bool red_before = door_open(red_w);
    const bool blue_before = door_open(blue_w);
    const bool red_after = door_open(red_row == fp ? static_cast<int>(new_fwd) : red_w);
    const bool blue_after = door_open(blue_row == fp ? static_cast<int>(new_fwd) : blue_w);
    const bool win = blue_after && red_before;
    const bool fail = (blue_after && !red_before) || (!blue_after && red_after && blue_before);
    if (win) r = success;
    if (fail) r = 0.0f;
    terminated = terminated || win || fail;
  }
  if constexpr (kHook == kHookMemory) {
    // Stepping onto the success cell (aux0, aux1) rewards, onto the
    // failure cell (aux2, aux3) fails with 0; either ends the episode.
    const int x1 = moves ? s.x + dirx : s.x;
    const int y1 = moves ? s.y + diry : s.y;
    const bool on_success = x1 == s.aux0 && y1 == s.aux1;
    const bool on_failure = x1 == s.aux2 && y1 == s.aux3;
    if (on_success) r = success;
    if (on_failure) r = 0.0f;
    terminated = terminated || on_success || on_failure;
  }
  if constexpr (kHook == kHookUnlock) {
    // A toggle that leaves the door (aux0, aux1) open succeeds; the door
    // is read after this step's forward-cell write, which has not
    // happened yet.
    const int row = abs_row(s, sh, s.aux0, s.aux1);
    if (a_orig == 5 && door_open(row == fp ? static_cast<int>(new_fwd) : grid.load(row))) {
      r = success;
      terminated = true;
    }
  }
  if constexpr (kHook == kHookDynamicObstacles) {
    // A forward move (of the remapped action, as the reference's hook
    // remaps it again) into a cell blocked before the walk costs -1 and
    // ends the episode.
    if (a == 2 && not_clear) {
      r = -1.0f;
      terminated = true;
    }
  }
  const bool d = terminated || sc1 >= sh.max_steps;
  if (kCtl) {
    if (d && ctl.consumed == 1) {  // would reuse the consumed template: freeze
      ctl.frozen = 1;
      return false;
    }
    ctl.steps_done += 1;
    if (d) ctl.consumed = 1;
  }

  // A reset overwrites every row and the obstacles, so the step's own
  // writes (the walk, the forward cell) are made only when there is none:
  // no row is written twice in one step.
  grid.sync();
  if (d) {
    s.x = tmpl_regs[0 * B + lane];
    s.y = tmpl_regs[1 * B + lane];
    // The template's words are centred on its agent; the grid puts row 0 at
    // the physical row it keeps for the agent (GridI32: row 0).
    s.shift = grid.agent_row(s.x, s.y, sh);
    for (int row = grid.first_row(); row < hw; row += grid.row_step())
      grid.store(wrap_row(row + s.shift, hw), tmpl_words[row * B + lane]);
    s.d = tmpl_regs[2 * B + lane];
    s.ct = tmpl_regs[3 * B + lane];
    s.cc = tmpl_regs[4 * B + lane];
    s.cct = tmpl_regs[5 * B + lane];
    s.ccc = tmpl_regs[6 * B + lane];
    s.sc = 0;
    s.aux0 = tmpl_regs[kNumScalars * B + lane];  // the new episode's aux rows
    s.aux1 = tmpl_regs[(kNumScalars + 1) * B + lane];
    if constexpr (kReadsAux23<kHook>) {
      s.aux2 = tmpl_regs[(kNumScalars + 2) * B + lane];
      s.aux3 = tmpl_regs[(kNumScalars + 3) * B + lane];
    }
    if constexpr (kHook == kHookDynamicObstacles) load_obstacles(tmpl_regs, B, lane, bt, sh, s);
  } else {
    if constexpr (kHook == kHookDynamicObstacles) commit_walk(grid, bt, sh, s);
    grid.store(fp, static_cast<int32_t>(new_fwd));
    if (moves) s.shift = fp;  // re-centre: the forward cell becomes row 0
    s.x = moves ? s.x + dirx : s.x;
    s.y = moves ? s.y + diry : s.y;
    s.d = d1;
    s.ct = ct1;
    s.cc = cc1;
    s.cct = cct1;
    s.ccc = ccc1;
    s.sc = sc1;
  }
  reward = r;
  done = d;
  return true;
}

// step_lane_grid on a GridI32 column (g, stride bt).
template <int kHook, bool kCtl>
__device__ __forceinline__ bool step_lane_ex(int32_t* g, int bt, const int32_t* tab,
                                             const int32_t* tmpl_words, const int32_t* tmpl_regs,
                                             size_t B, int lane, const StepShape& sh, int a,
                                             int chunk_len, Lane& s, Ctl& ctl, float& reward,
                                             bool& done) {
  GridI32 grid{g, bt};
  return step_lane_grid<kHook, kCtl>(grid, bt, tab, tmpl_words, tmpl_regs, B, lane, sh, a, chunk_len, s, ctl,
                                     reward, done);
}

// The lane's egocentric view: calls visit(kv, word) with kv = j * V + i for
// view cell (row j, col i), the agent at (V - 1, V / 2). A visible cell
// passes its packed word (the agent's cell shows what it carries; cells off
// the map read as grey walls). A cell the occlusion flood hides passes 0 if
// kVisitHidden, and is skipped otherwise.
template <bool kVisitHidden, class Visit>
__device__ __forceinline__ void read_view(const int32_t* g, int bt, const int32_t* tab,
                                          const StepShape& sh, const Lane& s, Visit&& visit) {
  const int v = sh.view;
  const int v2 = v * v;
  const int half = v / 2;
  const int f0 = (s.d == 0) - (s.d == 2);
  const int f1 = (s.d == 1) - (s.d == 3);
  const int agent_word = s.ct > 0 ? (s.ct | (s.cc << 4)) : kEmptyWord;
  const int32_t* off_view = tab + 4 + s.d * v2;
  auto cell = [&](int j, int i) -> int {
    const int rd = v - 1 - j;
    const int co = i - half;
    if (rd == 0 && co == 0) return agent_word;
    const int wx = s.x + f0 * rd - f1 * co;
    const int wy = s.y + f1 * rd + f0 * co;
    if (wx < 0 || wx >= sh.width || wy < 0 || wy >= sh.height) return kWallWord;
    return g[wrap_row(s.shift + off_view[j * v + i], sh.hw) * bt];
  };

  if (sh.see_through_walls) {
    for (int j = 0; j < v; ++j)
      for (int i = 0; i < v; ++i) visit(j * v + i, cell(j, i));
    return;
  }
  // The occlusion flood on V-bit row masks, from the agent's row outwards
  // (ops/packing.py::visibility_bitmask); v <= 31 (checked by the wrappers).
  const uint32_t all_bits = (1u << v) - 1u;
  const uint32_t last_clear = all_bits >> 1;
  const uint32_t first_clear = all_bits & ~1u;
  uint32_t carry = 0;
  for (int j = v - 1; j >= 0; --j) {
    uint32_t trow = 0;
    for (int i = 0; i < v; ++i) trow |= static_cast<uint32_t>(transparent(cell(j, i))) << i;
    uint32_t row = carry;
    if (j == v - 1) row |= 1u << half;
    for (int k = 0; k < v - 1; ++k) row |= (row & trow) << 1;
    row &= all_bits;
    const uint32_t q_l = row & trow & last_clear;
    for (int k = 0; k < v - 1; ++k) row |= (row & trow) >> 1;
    const uint32_t q_r = row & trow & first_clear;
    carry = (q_l | (q_l << 1) | q_r | (q_r >> 1)) & all_bits;
    for (int i = 0; i < v; ++i) {
      if ((row >> i) & 1u) {
        visit(j * v + i, cell(j, i));
      } else if (kVisitHidden) {
        visit(j * v + i, 0);
      }
    }
  }
}

// Store the lane's registers. The aux, mission and rng rows change only on reset, to the template's, except the
// DynamicObstacles obstacle rows, which the walk moves: those are stored
// from the lane's obstacle column.
template <int kHook>
__device__ __forceinline__ void store_regs(int bt, int32_t* regs_out, const int32_t* regs_in,
                                           const int32_t* tmpl_regs, bool reset_any, size_t B, int lane,
                                           const StepShape& sh, int num_regs, const Lane& s) {
  const int scalars[kNumScalars] = {s.x, s.y, s.d, s.ct, s.cc, s.cct, s.ccc, s.sc};
  for (int r = 0; r < kNumScalars; ++r) regs_out[r * B + lane] = scalars[r];
  const int32_t* tail = reset_any ? tmpl_regs : regs_in;
  const int live = kHook == kHookDynamicObstacles ? 2 * sh.n_obst : 0;
  for (int r = 0; r < live; ++r) regs_out[(kNumScalars + r) * B + lane] = s.ob[r * bt];
  for (int r = kNumScalars + live; r < num_regs; ++r) regs_out[r * B + lane] = tail[r * B + lane];
}

// Store the lane's grid (undoing the row offset) and registers.
template <int kHook>
__device__ __forceinline__ void store_lane(const int32_t* g, int bt, int32_t* words_out,
                                           int32_t* regs_out, const int32_t* regs_in,
                                           const int32_t* tmpl_regs, bool reset_any, size_t B,
                                           int lane, const StepShape& sh, int num_regs, const Lane& s) {
  for (int r = 0; r < sh.hw; ++r) words_out[r * B + lane] = g[wrap_row(r + s.shift, sh.hw) * bt];
  store_regs<kHook>(bt, regs_out, regs_in, tmpl_regs, reset_any, B, lane, sh, num_regs, s);
}

}  // namespace
