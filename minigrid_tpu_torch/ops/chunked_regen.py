"""Exact chunked regen: a fresh layout on every reset of a random-layout
family, byte-exact at any chunk length (counterpart of
`minigrid_tpu/ops/chunked_regen.py`).

The reference generates a new layout on every reset. The packed rollout
instead runs in chunks of `tc` steps, each lane carrying ONE
pre-generated next layout (its template), and makes that exact with a
freeze and re-entry commit protocol whose per-step arithmetic is in
`step_core` (`chunk_ctl`) and in the CUDA kernel (`step_lane_ex`).

Invariants:

  I1. Template freshness: for every lane, `(tmpl_words, tmpl_regs)[lane]`
      is `generate_packed(rng[lane])`, the layout that lane's next reset
      installs; `rng[lane]` is the lane's reset-chain position (the regen
      auto-reset's `state.rng`).
  I2. One template per pass: a lane's first reset in a pass consumes its
      template (`ctl` row 0, `consumed`, becomes 1). A second episode end
      while `consumed == 1` would reuse the layout, so the lane freezes
      instead (`ctl` row 2): that step is discarded whole (state, reward,
      done, obs checksum).
  I3. In-order commits: `ctl` row 1 (`steps_done`) is the lane's cursor
      in the chunk. In a pass, lane b commits pass-local rows `0..k-1`,
      which are chunk rows `c0[b]..c0[b]+k-1` for its cursor `c0[b]` at
      entry, because its action rows are pre-shifted
      (`rows = min(c0 + iota, tc - 1)`).
  I4. Replay determinism: a frozen lane's discarded step re-runs bit for
      bit on the next pass (the state was reverted and the pre-shifted
      action row is the same). Between passes, consumed lanes' chains
      advance (`rng <- generate(rng).rng`, read from the template's rng
      rows) and only those lanes' templates are regenerated
      (`masked_template_refresh`), which restores I1.
  I5. Termination: each pass commits at least one step of every lane
      that is neither frozen nor finished, and re-entry unfreezes frozen
      lanes (fresh template, `consumed` back to 0), so every chunk ends
      with `steps_done == tc` on every lane. Without a second reset in a
      chunk, a chunk is one pass.
  I6. Trajectory spill under the protocol (`collect=True`): a pass
      spills at the pass-local row `s`, which by I3 is chunk row `c0 + s`
      for the lane's committed prefix, so `_merge_spill` places
      `slab[i, lane] = spill[i - c0[lane], lane]` for `c0 <= i < c1` (`c1`
      the cursor after the pass). Rows a pass did not commit never land,
      and by I3 + I5 every chunk row is committed exactly once.

The JAX package's loops (`lax.while_loop`) are host loops here, each
condition read with one `.item()`. Re-entry passes take all the
unfinished lanes at once, compacted: the kernel takes any batch width, so
the JAX package's fixed sub-batch of `rb` lanes (padded with finished
lanes, which commit nothing) is not needed, and per lane the passes do
the same work. The merge of I6 writes only the active lanes' rows, so it
gives the same slab either way.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.rollout import totals_metrics
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.ops.packing import R_RNG, rows_key

# Host reads (`.item()` and the like) made by chunked-regen steps in this
# process: what each call waits on the device for.
host_syncs = 0
# Re-entry passes run by chunked-regen steps in this process.
reentry_passes = 0
# Lanes those passes took. A lane re-enters once for each step of it that
# froze (I2, I5), so over a call they sum to its `reset_overlaps`.
reentry_lanes = 0


def _no_mark(_piece: str) -> None:
    pass


def refresh_block_size(b: int) -> int:
    """Default slice of lanes regenerated at once by `masked_template_refresh`.

    The JAX package slices `max(128, B/8)` lanes, a fixed shape for XLA
    padded with lanes that need nothing. The port slices exactly the
    consumed lanes, so a slice bounds only the generator's temporaries
    (a few `(HW·4, slice)` int64 tiles); each slice costs the generator's
    hundreds of small launches, so fewer, larger slices are faster."""
    return min(b, 65_536)


def masked_template_refresh(env: Env, tw, tr, cur_rng, consumed, block: int, generate_packed):
    """Regenerate the templates of the `consumed` lanes only (restores I1
    once resets advanced their chains), in slices of at most `block`
    lanes: `generate_packed(keys, cfg)` on the consumed lanes' chain
    positions, written into `tw`/`tr` in place. The JAX package compacts
    with a stable argsort and regenerates in `block`-lane slices too; the
    port slices exactly the consumed lanes, so no slice is padded."""
    idx = torch.nonzero(consumed).flatten()
    count = idx.numel()  # reading it waits on the device
    global host_syncs
    host_syncs += 1
    for start in range(0, count, block):
        lanes = idx[start : start + block]
        fw, fr = generate_packed(cur_rng[lanes], env.config)
        tw[:, lanes] = fw
        tr[:, lanes] = fr


def _advance_chain(cur_rng, tr, consumed):
    """Consumed lanes' chains advance one link (I4): to the key their
    template's generator stored, which the reset also installed."""
    return torch.where(consumed[:, None], rows_key(tr[R_RNG : R_RNG + 2]), cur_rng)


def _merge_spill(slab, spill, c0, c1, first_pass: bool = False):
    """Merge one pass's pass-local spill into the chunk's slab (I6): lane
    `b`'s pass row `s` is its chunk row `c0[b] + s`, and only the rows in
    `[c0, c1)` were committed in the pass.

    `slab`, `spill`: `(tc, ..., B)` of one dtype; `c0`, `c1`: `(1, B)`
    cursors at the pass's entry and exit. With `first_pass=True` every
    lane entered at cursor 0 (`c0` is not read). Returns the merged slab;
    the inputs are left as they were. A gather along the rows is exact
    (the JAX package rolls by doubling instead, which its TPU needs)."""
    tc, b = spill.shape[0], spill.shape[-1]
    mid = (1,) * (spill.ndim - 2)
    i = torch.arange(tc, device=spill.device).reshape((tc,) + mid + (1,))
    c1 = c1.reshape((1,) + mid + (b,))
    if first_pass:
        return torch.where(i < c1, spill, slab)
    c0 = c0.reshape((1,) + mid + (b,))
    rows = torch.clamp(i - c0, 0, tc - 1).expand(spill.shape)
    return torch.where((i >= c0) & (i < c1), torch.gather(spill, 0, rows), slab)


def build_chunked_regen(env: Env, num_steps: int, tc: int, chunk_fn, stream_fn, generate_packed, refresh_block=None,
                        collect: bool = False):
    """Regen auto-reset for a random-layout family on the packed rollout,
    byte-exact against the JAX package's for any chunk length `tc`
    (a divisor of `num_steps`).

    `chunk_fn(words, regs, tmpl_words, tmpl_regs, stream (tc, B), ctl
    (3, B)[, ctx])` runs one pass of `tc` steps under the commit protocol
    and returns `(words', regs', rsum, episodes, checksum, ctl')` with
    `(1, B)` per-lane totals of the committed steps; with `collect=True`,
    `(words', regs', rsum, episodes, checksum, traj, ctl')`, where `traj`
    is a tuple of `(tc, ..., B)` pass-local spill arrays (I6).
    `stream_fn(source, b, device)` makes the `(num_steps, B)` actions, or
    the policy's sampling seeds. Returns `step_carry(source, carry,
    mark, ctx=None) -> (carry, RolloutMetrics[, traj])`, `traj` the
    merged `(num_steps, ..., B)` arrays (collect only); the carry passed
    in is left as it was. A `ctx` given to `step_carry` (the train
    rollout's weights, new at every optimizer step) reaches every
    `chunk_fn` call as its last argument, so one built step serves every
    call. `mark(piece)` is called at the end of each piece of the call
    ("actions", then per chunk "kernel" for pass 1, "refresh" for its
    template refresh and "reentry" for the re-entry passes, then "sums"),
    so a profiler can time the pieces in place."""
    from minigrid_tpu_torch.ops.fused_rollout import PackedCarry

    n_chunks = num_steps // tc
    assert n_chunks * tc == num_steps

    def step_carry(source, carry: PackedCarry, mark=_no_mark, ctx=None):
        global host_syncs, reentry_passes, reentry_lanes
        ctx_args = () if ctx is None else (ctx,)
        words, regs, rng = carry.words, carry.regs, carry.rng
        tw, tr = carry.tmpl_words.clone(), carry.tmpl_regs.clone()  # refreshed in place
        b, dev = words.shape[1], words.device
        block = refresh_block or refresh_block_size(b)
        actions = stream_fn(source, b, dev).reshape(n_chunks, tc, b)
        mark("actions")
        t_iota = torch.arange(tc, device=dev)[:, None]
        episodes = torch.zeros((), dtype=torch.int64, device=dev)
        checksum = torch.zeros((), dtype=torch.int64, device=dev)
        overlaps = torch.zeros((), dtype=torch.int64, device=dev)
        reward = torch.zeros((), dtype=torch.float32, device=dev)

        traj = None
        for k, a_chunk in enumerate(actions):
            # Pass 1: every lane at cursor 0, so no pre-shift.
            ctl0 = torch.zeros((3, b), dtype=torch.int32, device=dev)
            words, regs, rsum, epi, csum, *spill, ctl = chunk_fn(
                words, regs, tw, tr, a_chunk.contiguous(), ctl0, *ctx_args
            )
            if collect:
                if traj is None:  # every row is written by the merges (I5)
                    traj = [torch.zeros((num_steps,) + x.shape[1:], dtype=x.dtype, device=dev) for x in spill[0]]
                slabs = [y[k * tc : (k + 1) * tc] for y in traj]
                for slab, x in zip(slabs, spill[0]):
                    slab.copy_(_merge_spill(slab, x, None, ctl[1:2], first_pass=True))
            mark("kernel")
            consumed = ctl[0] == 1
            rng = _advance_chain(rng, tr, consumed)
            masked_template_refresh(env, tw, tr, rng, consumed, block, generate_packed)
            mark("refresh")
            reward = reward + rsum.sum()
            episodes, checksum = episodes + epi.sum(), checksum + csum.sum()
            overlaps = overlaps + ctl[2].sum()
            steps_done = ctl[1]

            # Re-entry passes (I3-I5): the unfinished lanes, compacted, with
            # their action rows pre-shifted to their cursors.
            while True:
                idx = torch.nonzero(steps_done < tc).flatten()
                n = idx.numel()  # reading it waits on the device
                host_syncs += 1
                if n == 0:
                    break
                reentry_passes += 1
                reentry_lanes += n
                sd = steps_done[idx]
                rows = torch.clamp(sd[None, :].long() + t_iota, max=tc - 1)  # (tc, n)
                a_s = torch.gather(a_chunk[:, idx], 0, rows).contiguous()
                zeros = torch.zeros((1, n), dtype=torch.int32, device=dev)
                ctl0 = torch.cat([zeros, sd[None, :], zeros]).contiguous()
                w2, r2, rsum, epi, csum, *spill, ctl = chunk_fn(
                    words[:, idx].contiguous(), regs[:, idx].contiguous(),
                    tw[:, idx].contiguous(), tr[:, idx].contiguous(), a_s, ctl0, *ctx_args,
                )
                if collect:
                    for slab, x in zip(slabs, spill[0]):
                        slab[..., idx] = _merge_spill(slab[..., idx], x, sd[None, :], ctl[1:2])
                words, regs = words.clone(), regs.clone()
                words[:, idx], regs[:, idx] = w2, r2
                consumed = ctl[0] == 1
                sub_rng = _advance_chain(rng[idx], tr[:, idx], consumed)
                rng = rng.clone()
                rng[idx] = sub_rng
                consumed_b = torch.zeros(b, dtype=torch.bool, device=dev)
                consumed_b[idx] = consumed
                masked_template_refresh(env, tw, tr, rng, consumed_b, block, generate_packed)
                reward = reward + rsum.sum()
                episodes, checksum = episodes + epi.sum(), checksum + csum.sum()
                overlaps = overlaps + ctl[2].sum()
                steps_done = steps_done.clone()
                steps_done[idx] = ctl[1]
            mark("reentry")

        metrics = totals_metrics(episodes, reward, checksum, b * num_steps, overlaps)
        mark("sums")
        if collect:
            return PackedCarry(words, regs, tw, tr, rng), metrics, tuple(traj)
        return PackedCarry(words, regs, tw, tr, rng), metrics

    return step_carry
