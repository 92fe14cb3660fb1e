"""Plain reference of one call of the carry surface under the random
policy: `T` steps of every lane from a given state and action stream,
with each reset's layout as the mode defines it.

* "static": the layout never changes (Empty, fixed start); every reset
  installs the one template and the lane's key moves one link down its
  chain, replayed after the call.
* "fresh": every reset installs the layout that the lane's key generates,
  the key moves one link, and the next template is generated from it
  (gym-minigrid's `reset()` on every episode end).

`stale=True` breaks the regen guarantee, as a control of the comparison
does: a reset keeps the old template ("fresh"), or the key stays where it
was ("static").

Lanes are independent, so a call runs in blocks of lanes. Imports nothing
of the program.
"""

from __future__ import annotations

import torch

from gpubench.reference import minigrid as M


class CallResult:
    """A call's new state and its totals: `episodes` and `checksum` as
    Python ints wrapped to int32, `reward` the f64 sum of the per-lane f32
    reward sums."""

    def __init__(self, words, regs, tmpl_words, tmpl_regs, rng, episodes, checksum, reward):
        self.words, self.regs, self.tmpl_words, self.tmpl_regs, self.rng = words, regs, tmpl_words, tmpl_regs, rng
        self.episodes, self.checksum, self.reward = episodes, checksum, reward


def wrap_i32(n: int) -> int:
    return (n + 2**31) % 2**32 - 2**31


def start(cfg: dict, seed: int, b: int, device):
    """The state a run starts from: lane i is the layout of child i of
    `split(PRNGKey(seed), B)`. Returns `(words, regs, tmpl_words,
    tmpl_regs, rng)`, the template the layout of each lane's next key."""
    keys = M.split(M.seed_key(seed, device), b)
    words, regs = M.packed_layouts(cfg["family"], keys, cfg["width"], cfg["height"])
    rng = M.rows_key(regs[M.R_RNG : M.R_RNG + 2])
    tw, tr = M.packed_layouts(cfg["family"], rng, cfg["width"], cfg["height"])
    return words, regs, tw, tr, rng


def templates(cfg: dict, rng: torch.Tensor):
    """The templates of lanes at chain positions `rng`."""
    return M.packed_layouts(cfg["family"], rng, cfg["width"], cfg["height"])


def _block_call(cfg, layouts, words, regs, tw, tr, rng, actions, reward_dtype, stale):
    kw = dict(width=cfg["width"], height=cfg["height"], view=cfg["view"], max_steps=cfg["max_steps"],
              see_through_walls=cfg["see_through_walls"], reward_dtype=reward_dtype)
    b = words.shape[1]
    rsum = torch.zeros((1, b), dtype=torch.float32, device=words.device)
    epi = torch.zeros((1, b), dtype=torch.int64, device=words.device)
    csum = torch.zeros((1, b), dtype=torch.int64, device=words.device)
    for t in range(actions.shape[0]):
        words, regs, reward, done, obs = M.step(words, regs, actions[t : t + 1], tw, tr, **kw)
        rsum = rsum + reward
        epi += done
        csum += M.checksum(obs)
        if layouts == "fresh":
            lanes = torch.nonzero(done[0]).flatten()
            if lanes.numel():
                rng = rng.clone()
                rng[lanes] = M.split(rng[lanes], 2)[:, 1]
                if not stale:
                    tw, tr = tw.clone(), tr.clone()
                    tw[:, lanes], tr[:, lanes] = templates(cfg, rng[lanes])
    if layouts == "static" and not stale:
        rem = epi[0].clone()
        for _ in range(int(rem.max()) if b else 0):
            rng = torch.where((rem > 0)[:, None], M.split(rng, 2)[:, 1], rng)
            rem -= 1
    return words, regs, tw, tr, rng, rsum, epi, csum


def call(cfg: dict, layouts: str, words, regs, tmpl_words, tmpl_regs, rng, actions, block: int = 1 << 18,
         reward_dtype=torch.float32, stale: bool = False) -> CallResult:
    """One call of `actions.shape[0]` steps from the state `(words, regs,
    rng)` and the templates given, in blocks of `block` lanes."""
    parts = []
    for s in range(0, words.shape[1], block):
        sl = slice(s, s + block)
        parts.append(_block_call(cfg, layouts, words[:, sl], regs[:, sl], tmpl_words[:, sl], tmpl_regs[:, sl],
                                 rng[sl], actions[:, sl], reward_dtype, stale))
    w, r, tw, tr, rng2, rsum, epi, csum = (torch.cat(x, dim=0 if i == 4 else 1) for i, x in enumerate(zip(*parts)))
    return CallResult(w, r, tw, tr, rng2, wrap_i32(int(epi.sum())), wrap_i32(int(csum.sum())),
                      float(rsum.double().sum()))
