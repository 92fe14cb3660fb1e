"""Mode `train`: the fused train step of
`minigrid_tpu_torch.parallel.train.build_fused_train_step`, `train_step(ts,
carry, key)`: the policy kernel collecting `T` steps of every lane, the
returns, the gradient kernel, the pullback and clip + Adam, on a static
layout in regen mode. A call is one step; its key comes from the seed.
On a cell of several cards the step runs over `make_env_mesh` of them:
the batch's lanes split in order over the cards, each shard launched from
the one host thread, the shards' gradient sums added on the first card,
and one Adam update there.

Set-up builds the one train state and step, drives them through their
first three steps with the window's own call and keys, and hands them to
the window. Those three steps, and one step of the window drawn from the
seed, run with the trajectory that the gradient pass receives copied on
the card (the trainer's sampled actions are its output). The check: the
carry that set-up packed against the reference's start; then the
reference follows the three steps from that start and the weights made
from the seed, and the window's step from the program's own state before
it (its parameters, Adam's moments and the world: the reference cannot
rebuild them without following every step before it, so the start is
checked by itself). For each it compares the world after the steps, the
widest gap by which a step's uniform lies outside the interval of the
reference's distribution for the action drawn, each step's loss,
the first step's clipped gradient as Adam holds it, and the parameters'
change; it also reads the share of actions that the reference would not
have drawn. The reference runs at the precisions that the cell states
(`precision`: the model's bf16 torso and float32 heads)."""

from __future__ import annotations

import random
import sys

import torch

from gpubench.harness import traffic, weights
from gpubench.harness.runner import Check
from gpubench.modes.random import _carry, lanes_wrong, reference_config
from gpubench.reference import policy as P
from gpubench.reference import rollout as R
from gpubench.reference import train as RT

CHECKED_STEPS = 3
EXACT = ("env_lanes_wrong", "window.env_lanes_wrong")


def reference_train_config(config: dict) -> dict:
    return dict(reference_config(config), layouts=config["layouts"])


class Mode:
    def __init__(self, cell, seed: int, device):
        from minigrid_tpu_torch import make
        from minigrid_tpu_torch.core import prng
        from minigrid_tpu_torch.models.policy import ActorCritic, load_flax_params
        from minigrid_tpu_torch.ops import fused_rollout, grad_kernel, policy_rollout
        from minigrid_tpu_torch.parallel import packed, sharding, train

        p, c = cell.params, cell.config
        self._pr, self._gk, self._prng, self._packed, self._train = policy_rollout, grad_kernel, prng, packed, train
        self.cell, self.device = cell, device
        self.mesh = None
        if cell.chips > 1:
            cards = [torch.device("cuda", i) for i in range(cell.chips)] if device.type == "cuda" else (
                [device] * cell.chips)
            self.mesh = sharding.make_env_mesh(cards)
        self.devices = list(self.mesh.distinct_devices) if self.mesh is not None else [device]
        self.seed = traffic.run_seed(seed)
        self.env = make(c["env_id"])
        self.b, self.t = p["batch"], p["steps"]
        self.work_per_call = self.b * self.t
        states = self.env.generate(prng.split(prng.key(self.seed, device=device), self.b), self.env.config)
        self.start = fused_rollout.packed_init(self.env, states, p["auto_reset"])
        del states
        self.params0 = weights.flax_params(self.seed, device, self.env.config.num_actions)
        model = ActorCritic(self.env.config.num_actions, view=c["view"], device=device,
                            generator=torch.Generator(device=device))
        load_flax_params(model, {"params": self.params0})
        self.ts = train.TrainState(model, train.make_optimizer().init(train.flatten_params(model.flax_params())))
        self.step = train.build_fused_train_step(self.env, self.t, mode=p["auto_reset"], regen_chunk=p["regen_chunk"],
                                                 mesh=self.mesh)
        self.carry = self.start if self.mesh is None else packed.shard_carry(self.start, self.mesh)
        self.followed = {"setup": self._follow(range(-CHECKED_STEPS, 0), _no_mark)}
        self.check_at = random.Random(self.seed).randrange(p["check_within"])
        self.min_calls = self.check_at + 1

    def _key(self, i: int):
        return self._prng.key(traffic.stream_seed(self.seed, 1000 + CHECKED_STEPS + i), device=self.device)

    def _split(self, flat: torch.Tensor) -> dict:
        """A flat vector in flax's ravel order -> a tree of its leaves."""
        out, off = {n: {} for n in weights.SIZES}, 0
        for n, k in P.LEAVES:
            shape = self.params0[n][k].shape
            out[n][k] = flat[off : off + self.params0[n][k].numel()].reshape(shape).clone()
            off += self.params0[n][k].numel()
        return out

    def _follow(self, calls, mark) -> dict:
        """Runs `calls` with the trajectory that the gradient pass receives
        copied on the card (the shards' lanes in order), and keeps the
        state before and after them."""
        train, spied, shards = self._train, self._train._kernel_grad_sums, []

        def spy(w, traj, *args, **kw):
            obs_w, actions, _logp, _value, reward, done = traj
            shards.append([x.to(self.device, copy=True) for x in (actions, reward, done, RT.digest(obs_w))])
            return spied(w, traj, *args, **kw)

        rec = dict(actions=[], reward=[], done=[], digest=[], loss=[], keys=[], before=(self.ts, self.carry))
        train._kernel_grad_sums = spy
        try:
            for i in calls:
                self.ts, self.carry, metrics = self.step(self.ts, self.carry, self._key(i), mark=mark)
                for name, parts in zip(("actions", "reward", "done", "digest"), zip(*shards)):
                    rec[name].append(torch.cat(parts, dim=-1))
                shards.clear()
                rec["loss"].append(metrics["loss"])
                rec["keys"].append(self._key(i))
                rec.setdefault("mu1", self.ts.opt_state.mu)
        finally:
            train._kernel_grad_sums = spied
        rec["after"] = (self.ts, self.carry)
        return rec

    def call(self, i: int, mark) -> None:
        if i == self.check_at:
            self.followed["window"] = self._follow([i], mark)
        else:
            self.ts, self.carry, _ = self.step(self.ts, self.carry, self._key(i), mark=mark)

    def counters(self) -> dict:
        return {"policy_kernel_launches": self._pr.policy_kernel_launches,
                "grad_kernel_launches": self._gk.grad_kernel_launches}

    def check(self) -> list:
        return self.readings()[None]

    def _whole(self, carry):
        return carry if self.mesh is None else self._packed.gather_carry(carry, self.device)

    def _case(self, rec: dict) -> dict:
        """What the judge reads of followed steps: the program's start,
        parameters and Adam state before them, and its trainer record."""
        (ts0, carry0), (ts1, carry1) = rec["before"], rec["after"]
        c0, c1 = self._whole(carry0), self._whole(carry1)
        opt = ts0.opt_state
        trainer = {k: rec[k] for k in ("actions", "reward", "done", "digest")}
        trainer.update(loss=[float(x) for x in rec["loss"]], grad=self._split((rec["mu1"] - P.B1 * opt.mu) / (1 - P.B1)),
                       params=_tree(ts1), state=(c1.words, c1.regs, c1.rng))
        return dict(start=_carry(c0), params=_tree(ts0), adam=(self._split(opt.mu), self._split(opt.nu), int(opt.count)),
                    keys=rec["keys"], trainer=trainer)

    def readings(self, controls=()) -> dict:
        """The comparison's numbers, `{None: checks}`, and for each control
        ("fp8": the torso in float8 e4m3 and the heads in bfloat16, one step
        below the precisions the cell states) the same numbers with the
        reference so changed in the trainer's place. The window's step's
        numbers are named `window.<number>`."""
        cfg, p = reference_train_config(self.cell.config), self.cell.params
        dtypes = tuple(getattr(torch, p["precision"][k]) for k in ("torso", "heads"))
        ref0 = R.start(cfg, self.seed, self.b, self.device)
        start_wrong = lanes_wrong(_carry(self.start), ref0)
        cases = {tag: self._case(rec) for tag, rec in self.followed.items()}
        self.start = self.carry = self.step = self.ts = self.followed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        # The set-up's steps start from the reference's own start and the
        # weights made from the seed, with Adam fresh.
        cases["setup"].update(start=ref0, params=self.params0, adam=None)
        window = cases["window"]
        templates_wrong = lanes_wrong(window["start"][2:4], ref0[2:4])
        window["start"] = (*window["start"][:2], ref0[2], ref0[3], window["start"][4])
        out = {}
        for who in (None, *controls):
            if who not in (None, "fp8"):
                raise ValueError(f"unknown control {who!r}")
            r = {}
            for tag, case in cases.items():
                args = (cfg, case["start"], case["params"], case["keys"], self.t, p["reference_chunk"])
                trainer = case["trainer"] if who is None else RT.control(
                    *args, torch.float8_e4m3fn, torch.bfloat16, adam_state=case["adam"])
                for k, v in RT.judge(*args, trainer, adam_state=case["adam"], dtypes=dtypes).items():
                    r[k if tag == "setup" else f"window.{k}"] = v
            if who is None:
                r["window.env_lanes_wrong"] += templates_wrong
            out[who] = r
        # The numbers compared are the exact ones and those the cell gives a
        # limit; the others are read only (PERF.md §2 gives each number's
        # readings).
        limits = p["limits"]
        self.info = {w or "program": {k: v for k, v in r.items() if k not in limits and k not in EXACT}
                     for w, r in out.items()}
        print(f"gpubench: read, not compared: {self.info}", file=sys.stderr)
        return {w: [Check("start_lanes_wrong", start_wrong if w is None else 0, 0)]
                + [Check(k, r[k], limits.get(k, 0)) for k in (*EXACT, *limits)]
                for w, r in out.items()}


def _no_mark(_piece: str) -> None:
    pass


def _tree(ts) -> dict:
    return {n: {k: v.clone() for k, v in layer.items()} for n, layer in ts.params.flax_params()["params"].items()}
