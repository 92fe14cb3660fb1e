"""The plain `step_core`/`obs_core` against the JAX package's
`_step_core`/`_obs_core`, for 16 steps on random `testing.py` states
with the same numpy actions.

Every integer output is byte-exact. The per-step reward gets rtol=1e-6:
XLA folds `0.9 / max_steps` into one constant and so rounds
`1 - 0.9 * (sc / max_steps)` 1-3 ulp away from the literal formula,
which the port (twin and kernel alike) evaluates one f32 op at a time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_tpu.ops import fused_rollout as jfr
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.testing import random_packed_case

B = 256
STEPS = 16


@functools.lru_cache(maxsize=None)
def _jax_fns(kw_items):
    kw = dict(kw_items)
    step = jax.jit(lambda w, r, a, tw, tr: jfr._step_core(w, r, a, tw, tr, **kw))
    obs_kw = {k: v for k, v in kw.items() if k != "max_steps"}
    obs = jax.jit(lambda w, r: jfr._obs_core(w, r, **obs_kw))
    return step, obs


@pytest.mark.parametrize("see_through_walls", [True, False])
@pytest.mark.parametrize("size", [(5, 5), (8, 8), (9, 7)])
def test_step_and_obs_core_match_jax(size, see_through_walls):
    w, h = size
    max_steps = 4 * w * h
    kw = dict(width=w, height=h, view=7, max_steps=max_steps, see_through_walls=see_through_walls)
    jstep, jobs = _jax_fns(tuple(sorted(kw.items())))
    obs_kw = {k: v for k, v in kw.items() if k != "max_steps"}

    case = random_packed_case(100 + w * h, w, h, B, max_steps)
    actions = np.random.default_rng(w * h).integers(0, 7, size=(STEPS, B)).astype(np.int32)
    jw, jr, jtw, jtr = (jnp.asarray(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs"))
    tw, tr, ttw, ttr = (torch.from_numpy(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs"))
    n_done = 0
    for t in range(STEPS):
        jout = jstep(jw, jr, jnp.asarray(actions[t : t + 1]), jtw, jtr)
        tout = tfr.step_core(tw, tr, torch.from_numpy(actions[t : t + 1]), ttw, ttr, **kw)
        for name, j, g in zip(("words", "regs", "reward", "done", "obs_sum"), jout, tout):
            j = np.asarray(j)
            g = g.numpy()
            assert g.dtype == j.dtype, (t, name)
            if name == "reward":
                np.testing.assert_allclose(g, j, rtol=1e-6, atol=0, err_msg=f"step {t}")
            else:
                np.testing.assert_array_equal(g, j, err_msg=f"step {t} {name}")
        jw, jr = jout[0], jout[1]
        tw, tr = tout[0], tout[1]
        n_done += int(tout[3].sum())
        for name, j, g in zip(("vw", "vis"), jobs(jw, jr), tfr.obs_core(tw, tr, **obs_kw)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=f"step {t} {name}")
    assert n_done > 0  # the random states reset within 16 steps
