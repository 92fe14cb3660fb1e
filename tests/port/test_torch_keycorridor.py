"""KeyCorridor generation in the port against the JAX package, byte for
byte: `generate_packed` and `reset_batch` at S3R1 (1x3 rooms) and S6R3
(3x3 rooms, 16x16), B = 32; the registrations and the mission table.

At S3R1 the reference is the JAX package's own `vmap(generate)` and
`_pack_rolled` of it. At S6R3 it is the JAX package's `generate_packed`,
which its tests hold byte-exact against `_pack_rolled(vmap(generate))`
(tests/test_gen_kernel.py, tests/test_packed_gen.py); `vmap(generate)`
itself takes about 70 s to compile there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.envs import missions as jmissions
from minigrid_tpu.ops.packed_gen import get_packed_generator as jget_packed_generator
from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.prng import key, split
from minigrid_tpu_torch.envs import keycorridor as tkc
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_from_numpy, state_to_numpy

B = 32
SEED = 21
KC_IDS = [f"MiniGrid-KeyCorridorS{rs}R{r}-v0" for rs, r in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3))]


def _keys():
    return np.asarray(split(key(SEED, device="cpu"), B)).astype(np.uint32)


def _jax_s3r1():
    """(states as numpy, packed words, packed regs) of JAX `vmap(generate)`,
    packed by the port's `_pack_rolled` (held against the JAX package's in
    test_torch_packing.py and test_torch_rollout.py)."""
    env = minigrid_tpu.make("MiniGrid-KeyCorridorS3R1-v0")
    states = jax.jit(jax.vmap(lambda k: env.generate(k, env.config)))(_keys())
    states = {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS}
    words, regs = tfr._pack_rolled(make("MiniGrid-KeyCorridorS3R1-v0").config, state_from_numpy(states, device="cpu"))
    return states, words.numpy(), regs.numpy()


def _jax_s6r3_packed():
    env = minigrid_tpu.make("MiniGrid-KeyCorridorS6R3-v0")
    gp = jget_packed_generator(env)
    words, regs = jax.jit(lambda k: gp(k, env.config))(_keys())
    return np.asarray(words), np.asarray(regs)


def _port_packed(env_id):
    env = make(env_id)
    words, regs = tkc.generate_packed(torch.from_numpy(_keys().astype(np.int64)), env.config)
    assert words.dtype == regs.dtype == torch.int32
    return env, words.numpy(), regs.numpy()


# One test per geometry, generate_packed and reset_batch together: each JAX
# reference is one compile, which a second test could repeat on another
# worker.
def test_generate_packed_and_reset_batch_match_jax_vmap_generate_s3r1():
    want, want_w, want_r = _jax_s3r1()
    _, words, regs = _port_packed("MiniGrid-KeyCorridorS3R1-v0")
    np.testing.assert_array_equal(words, want_w)
    np.testing.assert_array_equal(regs, want_r)
    got = state_to_numpy(make("MiniGrid-KeyCorridorS3R1-v0").reset_batch(key(SEED, device="cpu"), B)[0])
    for name in STATE_FIELDS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_generate_packed_and_reset_batch_match_jax_generate_packed_s6r3():
    want_w, want_r = _jax_s6r3_packed()
    _, words, regs = _port_packed("MiniGrid-KeyCorridorS6R3-v0")
    np.testing.assert_array_equal(words, want_w)
    np.testing.assert_array_equal(regs, want_r)
    env = make("MiniGrid-KeyCorridorS6R3-v0")
    states, _ = env.reset_batch(key(SEED, device="cpu"), B)
    assert tuple(states.grid.shape) == (B, 16, 16, 5)
    words, regs = tfr._pack_rolled(env.config, states)
    np.testing.assert_array_equal(words.numpy(), want_w)
    np.testing.assert_array_equal(regs.numpy(), want_r)


def test_mission_is_template_19_of_the_jax_table():
    assert missions.TEMPLATES == tuple(jmissions._TEMPLATES)
    assert tkc.MISSION == 19 == jmissions._TEMPLATES.index("pick up the {c0} {t1}")
    _, _, regs = _port_packed("MiniGrid-KeyCorridorS3R1-v0")
    from minigrid_tpu_torch.ops.packing import R_MISSION

    assert (regs[R_MISSION] == 19).all()


@pytest.mark.parametrize("env_id", KC_IDS)
def test_keycorridor_ids_carry_the_jax_config_and_the_pickup_hook(env_id):
    env = make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(minigrid_tpu.make(env_id).config)
    assert env.transition == "pickup_target"
    assert tfr.get_packed_generator(env) is tkc.generate_packed
