"""Key corridor (counterpart of `minigrid_tpu/envs/keycorridor.py`).

A 3-column room grid whose middle column is opened into a vertical
corridor; a ball waits behind a locked door in a random right-hand room,
the key of the door's colour in a random left-hand room, and the agent in
the middle room; `connect_all` adds random unlocked doors until every
room is reachable. Picking up the ball succeeds (the `pickup_target`
transition); `aux[0]`, `aux[1]` hold its type and colour.

`generate_packed` is the generator: it draws with the JAX package's exact
`jax.random` call tree and paints into the packed `(HW, B)` word layout,
with `connect_all`'s door loop in the connect kernel (`ops/gen_kernel.py`).
`generate` unpacks its result. The JAX package asserts that its own
`generate_packed` equals `_pack_rolled(vmap(generate))` byte for byte, so
the port has no scalar generator.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import AUX_LEN, MISSION_LEN, EnvConfig, EnvState
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.roomgrid import DOWN, LEFT, RIGHT, UP, init_plan, rand_color
from minigrid_tpu_torch.ops import packed_gen as PG
from minigrid_tpu_torch.ops.gen_kernel import connect_plan_batched
from minigrid_tpu_torch.ops.packing import EMPTY_WORD, WALL_WORD

MISSION = missions.register_template("pick up the {c0} {t1}")

TRANSITION = "pickup_target"


def _lattice(config: EnvConfig) -> np.ndarray:
    """The static `(H, W)` words: every room's walls, the middle column's
    shared walls knocked out (`remove_wall(1, j, UP)`)."""
    rows, cols, rs = config.num_rows, config.num_cols, config.room_size
    base = np.full((config.height, config.width), EMPTY_WORD, np.int32)
    for j in range(rows):
        for i in range(cols):
            tx, ty = i * (rs - 1), j * (rs - 1)
            base[ty, tx : tx + rs] = WALL_WORD
            base[ty + rs - 1, tx : tx + rs] = WALL_WORD
            base[ty : ty + rs, tx] = WALL_WORD
            base[ty : ty + rs, tx + rs - 1] = WALL_WORD
    for j in range(1, rows):
        tx, ty = rs - 1, j * (rs - 1)
        base[ty, tx + 1 : tx + rs - 1] = EMPTY_WORD
    return base


def generate_packed(keys: torch.Tensor, config: EnvConfig, plain: bool = False):
    """One layout per row of the `(B, 2)` key tensor, as `(agent-centred
    words (HW, B), regs (NUM_REGS, B))` int32, on `keys.device`. The door
    loop runs in the connect kernel for CUDA tensors, and in its plain
    version for CPU tensors or with `plain=True`."""
    rows, cols, rs = config.num_rows, config.num_cols, config.room_size
    w, h = config.width, config.height
    b, dev = keys.shape[0], keys.device
    i32 = dict(dtype=torch.int32, device=dev)

    # ---- the plan: generate()'s exact draw tree --------------------------
    key, k_reset = prng.split(keys, 2).unbind(1)
    ks = prng.split(key, 8).unbind(1)
    door_pos = init_plan(ks[0], config)  # (B, R, C, 4, 2)
    room_j = prng.randint(ks[1], 0, rows)
    door_color = rand_color(ks[2])
    _, k_color_a, k_pos_a = prng.split(ks[3], 3).unbind(1)
    obj_color = rand_color(k_color_a)  # add_object(kind=BALL)
    key_j = prng.randint(ks[4], 0, rows)
    k_pos_b = prng.split(ks[5], 3)[:, 2]  # kind and colour given
    k_agent, k_conn = ks[6], ks[7]

    # ---- the static lattice, then the locked door into (2, room_j) -------
    xs, ys = PG.xy_iota(h, w, dev)
    words = torch.from_numpy(_lattice(config).reshape(-1, 1)).to(dev).expand(h * w, b).contiguous()
    lanes = torch.arange(b, device=dev)
    dpos = door_pos[lanes, room_j.long(), 2, LEFT]  # (B, 2)
    words = PG.set_cell_words(words, xs, ys, dpos[:, 0], dpos[:, 1], PG.cell_word(C.DOOR, door_color, C.STATE_LOCKED))

    # ---- the ball behind the door; the key in a random left-hand room ----
    # Both test against the agent's initial position (the lattice centre).
    acx = (cols // 2) * (rs - 1) + rs // 2
    acy = (rows // 2) * (rs - 1) + rs // 2
    reject = PG.reject_next_to_words(xs, ys, acx, acy)

    def room_mask(i, jj):
        return PG.rect_mask_words(xs, ys, torch.full((b,), i * (rs - 1), **i32), jj * (rs - 1), rs, rs)

    acx_b, acy_b = torch.full((b,), acx, **i32), torch.full((b,), acy, **i32)
    mask_a = PG.free_mask_words(words, xs, ys, acx_b, acy_b) & room_mask(2, room_j) & reject
    bx, by = PG.sample_cell_words(k_pos_a, mask_a, w)
    words = PG.set_cell_words(words, xs, ys, bx, by, PG.cell_word(C.BALL, obj_color))
    mask_b = PG.free_mask_words(words, xs, ys, acx_b, acy_b) & room_mask(0, key_j) & reject
    kx, ky = PG.sample_cell_words(k_pos_b, mask_b, w)
    words = PG.set_cell_words(words, xs, ys, kx, ky, PG.cell_word(C.KEY, door_color))

    # ---- the agent in the middle room -------------------------------------
    interior = PG.rect_mask_words(xs, ys, rs - 1, (rows // 2) * (rs - 1), rs, rs)
    ax, ay, adir = PG.place_agent_words(k_agent, words, xs, ys, interior, w)

    # ---- connect_all: the door loop, then paint the accepted doors -------
    jj = torch.arange(rows, device=dev)[None, :, None]
    ii = torch.arange(cols, device=dev)[None, None, :]
    is_rj = jj == room_j[:, None, None].long()  # (B, R, 1)
    locked_2d = is_rj & (ii == 2)
    # Prior connectivity: the opened corridor walls (both sides) and the
    # locked door's two slot registrations.
    prior = torch.zeros((b, rows, cols, 4), dtype=torch.bool, device=dev)
    prior[:, 1:, 1, UP] = True
    prior[:, :-1, 1, DOWN] = True
    prior[:, :, 2, LEFT] |= is_rj[:, :, 0]
    prior[:, :, 1, RIGHT] |= is_rj[:, :, 0]
    start_i = torch.clamp(ax // (rs - 1), max=cols - 1)
    start_j = torch.clamp(ay // (rs - 1), max=rows - 1)
    has_door, colors = connect_plan_batched(k_conn, config, start_i, start_j, locked_2d, prior, plain=plain)

    for j in range(rows):
        for i in range(cols):
            for k in (RIGHT, DOWN):
                if (k == RIGHT and i >= cols - 1) or (k == DOWN and j >= rows - 1):
                    continue
                new = has_door[:, j, i, k] & ~prior[:, j, i, k]
                pos = door_pos[:, j, i, k]
                word = PG.cell_word(C.DOOR, colors[:, j, i, k].to(torch.int32), C.STATE_CLOSED)
                words = PG.set_cell_words(words, xs, ys, pos[:, 0], pos[:, 1], word, active=new)

    # ---- registers --------------------------------------------------------
    aux = torch.zeros((b, AUX_LEN), **i32)
    aux[:, 0], aux[:, 1] = C.BALL, obj_color
    mission = torch.zeros((b, MISSION_LEN), **i32)
    mission[:, 0], mission[:, 1], mission[:, 2] = MISSION, obj_color, C.BALL
    regs = PG.build_regs(b, ax, ay, adir, k_reset, mission=mission, aux=aux)
    return PG.finish_packed(words, regs, w)


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor: `generate_packed`,
    unrolled and unpacked."""
    from minigrid_tpu_torch.ops.fused_rollout import _unpack_rolled

    return _unpack_rolled(config, *generate_packed(keys, config))
