"""Mode `random`: the carry surface `step(source, carry)` of
`minigrid_tpu_torch.ops.fused_rollout.build_fused_rollout(as_carry=True)`
under the random policy, its actions drawn by a `torch.Generator` on the
card. A call is `T` steps of every lane: the rollout kernel, then on a
static layout the key-chain replay, or on a random-layout family chunked
regen with its template refreshes.

The check: the carry that set-up packed against the reference's start
from the seed; then, from the program's carry before a call drawn from
the seed (the program's own state: the reference cannot rebuild it
without replaying every call before it), `check_calls` calls of the
reference, each held against the program's carry and totals after the
same call. The templates are worked out again from the lanes' keys."""

from __future__ import annotations

import random

import torch

from gpubench.harness import traffic
from gpubench.harness.runner import Check
from gpubench.reference import rollout as R


def reference_config(config: dict) -> dict:
    keys = ("family", "width", "height", "view", "max_steps", "see_through_walls")
    return {k: config[k] for k in keys}


def lanes_wrong(got, want) -> int:
    """Lanes in which any of the tensors differ: `(rows, B)` state, or
    `(B, 2)` keys (`rng`, last)."""
    bad = None
    for g, w in zip(got, want):
        diff = (g != w).any(dim=1) if g.ndim == 2 and g.shape[1] == 2 and g.dtype == torch.int64 else (g != w).any(
            dim=0)
        bad = diff if bad is None else bad | diff
    return int(bad.sum())


def _carry(c):
    return (c.words, c.regs, c.tmpl_words, c.tmpl_regs, c.rng)


class Mode:
    def __init__(self, cell, seed: int, device):
        from minigrid_tpu_torch import make
        from minigrid_tpu_torch.core import prng
        from minigrid_tpu_torch.ops import chunked_regen, fused_rollout

        p, c = cell.params, cell.config
        self._fr, self._cr = fused_rollout, chunked_regen
        self.cell, self.device, self.devices = cell, device, [device]
        self.seed = traffic.run_seed(seed)
        self.env = make(c["env_id"])
        for key, value in (("width", c["width"]), ("height", c["height"]), ("agent_view_size", c["view"]),
                           ("max_steps", c["max_steps"]), ("see_through_walls", c["see_through_walls"])):
            if getattr(self.env.config, key) != value:
                raise ValueError(f"{c['env_id']}: {key} is {getattr(self.env.config, key)}, its file says {value}")
        self.b, self.t = p["batch"], p["steps"]
        self.work_per_call = self.b * self.t
        states = self.env.generate(prng.split(prng.key(self.seed, device=device), self.b), self.env.config)
        self.start = fused_rollout.packed_init(self.env, states, p["auto_reset"])
        del states
        self.step = fused_rollout.build_fused_rollout(self.env, self.t, mode=p["auto_reset"], as_carry=True,
                                                      regen_chunk=p["regen_chunk"])
        self.gen = torch.Generator(device=device).manual_seed(traffic.stream_seed(seed, 0))
        self.carry = self.start
        for _ in range(p["warmup_calls"]):
            self.carry, _ = self.step(self.gen, self.carry)
        self.first = random.Random(self.seed).randrange(p["check_within"])
        self.min_calls = self.first + p["check_calls"]
        self.kept = {}

    def call(self, i: int, mark) -> None:
        keep = self.first <= i < self.min_calls
        state, before = (self.gen.get_state(), self.carry) if keep else (None, None)
        self.carry, metrics = self.step(self.gen, self.carry, mark=mark)
        if keep:
            self.kept[i] = (state, before, self.carry, metrics)

    def counters(self) -> dict:
        return {"chunked_regen.host_syncs": self._cr.host_syncs,
                "chunked_regen.reentry_passes": self._cr.reentry_passes,
                "rollout_kernel_launches": self._fr.rollout_kernel_launches}

    def check(self) -> list:
        return self.readings()[None]

    def readings(self, controls=()) -> dict:
        """The comparison's numbers, `{None: checks}`, and for each control
        ("reward_bf16": rewards computed in bfloat16; "stale": a reset
        keeps the old layout and key) the same numbers with the reference so
        changed in the program's place. Frees the program's state first."""
        cfg = reference_config(self.cell.config)
        layouts, p = self.cell.config["layouts"], self.cell.params
        ref0 = R.start(cfg, self.seed, self.b, self.device)
        start_wrong = lanes_wrong(_carry(self.start), ref0)
        kept = [self.kept[i] for i in sorted(self.kept)]
        self.start = self.carry = self.step = None
        self.kept = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        first_in = kept[0][1]
        words, regs, rng = first_in.words, first_in.regs, first_in.rng
        tw, tr = (ref0[2], ref0[3]) if layouts == "static" else R.templates(cfg, rng)
        who = (None, *controls)
        n = {w: dict(state=lanes_wrong((first_in.tmpl_words, first_in.tmpl_regs), (tw, tr)) if w is None else 0,
                     episodes=0, checksum=0, reward=0.0) for w in who}
        for state, _, after, metrics in kept:
            actions = traffic.uniform_actions(state, self.t, self.b, self.env.config.num_actions, self.device)
            want = R.call(cfg, layouts, words, regs, tw, tr, rng, actions, p["reference_block"])
            for w in who:
                if w is None:
                    got = (_carry(after), int(metrics.episodes), int(metrics.obs_checksum), float(metrics.total_reward))
                else:
                    c = R.call(cfg, layouts, words, regs, tw, tr, rng, actions, p["reference_block"],
                               reward_dtype=torch.bfloat16 if w == "reward_bf16" else torch.float32,
                               stale=w == "stale")
                    got = ((c.words, c.regs, c.tmpl_words, c.tmpl_regs, c.rng), c.episodes, c.checksum,
                           float(torch.tensor(c.reward, dtype=torch.float32)))
                r = n[w]
                r["state"] += lanes_wrong(got[0], (want.words, want.regs, want.tmpl_words, want.tmpl_regs, want.rng))
                r["episodes"] = max(r["episodes"], abs(got[1] - want.episodes))
                r["checksum"] = max(r["checksum"], abs(got[2] - want.checksum))
                r["reward"] = max(r["reward"], abs(got[3] - want.reward) / max(abs(want.reward), 1.0))
            words, regs, tw, tr, rng = want.words, want.regs, want.tmpl_words, want.tmpl_regs, want.rng
        limits = p["limits"]
        return {w: [
            Check("start_lanes_wrong", start_wrong if w is None else 0, 0),
            Check("state_lanes_wrong", n[w]["state"], 0),
            Check("episodes_gap", n[w]["episodes"], 0),
            Check("checksum_gap", n[w]["checksum"], 0),
            Check("reward_gap", n[w]["reward"], limits["reward_gap"]),
        ] for w in who}
