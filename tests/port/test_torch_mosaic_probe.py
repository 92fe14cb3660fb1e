"""The Mosaic bisection probe in the port (`minigrid_tpu_torch/tools/
probe_mosaic.py`) against the JAX package's (`tools/probe_mosaic.py`);
on a card, its kernel against its plain version.

`plain_probe` against the JAX probe's `pallas_call` in interpret mode,
built here from `tools/probe_mosaic.make_kernel`/`make_kernel_scratch`
with `run_variant`'s specs, on the same numpy inputs, for all 9 variants:
bit for bit (as values) under dyadic inputs (`probe_inputs(dyadic=True)`,
every f32 sum exact in any order), and under the probe's own normal draws
within 1e-5 of the largest |acc| (the f32 products are exact, the sums of
layer 1, layer 2 and the accumulator run in other orders; on this CPU the
readings are at most 3.3e-7). One `jax.jit` per variant.

JAX is imported only by the tests that compare with it, so the `gpu`
tests also run on a machine with a card and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/port/test_torch_mosaic_probe.py -q
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from minigrid_tpu_torch.tools import probe_mosaic as P

REPO = Path(__file__).resolve().parents[2]


@functools.lru_cache(maxsize=None)
def _jax_probe(variant):
    """The JAX probe's `pallas_call` for `variant`, interpreted, in one jit."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, str(REPO / "tools"))
    import probe_mosaic as J

    scratches = [pltpu.VMEM((J.H, J.H), jnp.float32)]
    if variant == "scratch_roundtrip":
        kernel = J.make_kernel_scratch()
        scratches.append(pltpu.VMEM((J.H, J.BT), jnp.bfloat16))
    else:
        kernel = J.make_kernel(variant)

    def f(obs, g, wt1, b1, wt2, b2):
        return pl.pallas_call(
            kernel,
            grid=(2,),
            in_specs=[
                pl.BlockSpec((1, J.V2, J.BT), lambda j: (j, 0, 0)),
                pl.BlockSpec((J.H, J.BT), lambda j: (0, 0)),
                pl.BlockSpec(wt1.shape, lambda j: (0, 0)),
                pl.BlockSpec(b1.shape, lambda j: (0, 0)),
                pl.BlockSpec(wt2.shape, lambda j: (0, 0)),
                pl.BlockSpec(b2.shape, lambda j: (0, 0)),
            ],
            out_specs=pl.BlockSpec((J.H, J.H), lambda j: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((J.H, J.H), jnp.float32),
            scratch_shapes=scratches,
            interpret=True,
        )(obs, g, wt1, b1, wt2, b2)

    fj = jax.jit(f)

    def run(inputs):
        args = [jnp.asarray(inputs["obs"]), jnp.asarray(inputs["g"])]
        args += [jnp.asarray(inputs[n]).astype(jnp.bfloat16) for n in ("wt1", "b1", "wt2", "b2")]
        return np.asarray(fj(*args))

    return run


def test_port_keeps_the_jax_variants_and_shapes():
    sys.path.insert(0, str(REPO / "tools"))
    pytest.importorskip("jax")
    import probe_mosaic as J

    assert P.VARIANTS == J.VARIANTS
    assert (P.F, P.H, P.BT, P.V2) == (J.F, J.H, J.BT, J.V2)
    assert set(P.SAME_FORMULA) < set(P.VARIANTS)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("variant", P.VARIANTS)
def test_plain_probe_matches_jax_interpret(variant, dyadic):
    inputs = P.probe_inputs(0, dyadic=dyadic)
    want = _jax_probe(variant)(inputs)
    got = P.plain_probe(variant, *P.to_tensors(inputs, "cpu")).numpy()
    assert got.dtype == np.float32 and got.shape == (P.H, P.H)
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_same_formula_variants_agree_and_the_others_keep_their_bounds():
    """On the CPU, through the plain version: the `SAME_FORMULA` variants
    bit for bit, the others within `deviation_bound` of base_where, and
    the mask's effect visible (control_unmasked differs)."""
    args = P.to_tensors(P.probe_inputs(1), "cpu")
    out = {v: P.plain_probe(v, *args) for v in P.VARIANTS}
    for v in P.SAME_FORMULA:
        assert torch.equal(out[v].view(torch.int32), out["base_where"].view(torch.int32)), v
    for v in ("control_unmasked", "mask_from_f32", "f32_dot"):
        assert bool(((out[v] - out["base_where"]).abs() <= P.deviation_bound(v, *args)).all()), v
    assert not torch.equal(out["control_unmasked"], out["base_where"])


def test_wrapper_checks_its_operands():
    args = list(P.to_tensors(P.probe_inputs(0), "cpu"))
    assert torch.equal(P.run_probe_kernel("base_where", *args), P.plain_probe("base_where", *args))
    with pytest.raises(ValueError, match="unknown probe variant"):
        P.plain_probe("no_such_variant", *args)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="expected a CUDA device"):
        P.run_probe_kernel("base_where", *meta)


def _sw128(row, k):
    return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2


@pytest.mark.parametrize("which", ["wt1", "wt2"])
def test_probe_weight_chunks_hold_each_weight_once(which):
    """The probe kernel's weight layout: each weight of `wt1` and `wt2`
    once, zeros only in W1ᵀ's padding (980 -> 992), each at the byte the
    kernel's descriptors read: 16 KB chunks of 128 rows of one N half in
    the 128-byte swizzle, W1ᵀ's K chunks outer and W2ᵀ's N halves outer,
    then W1ᵀ's tail of two 16 x 256 k slabs in 8 x 8 core matrices."""
    k = P.F if which == "wt1" else P.H
    w = torch.arange(1, P.H * k + 1, dtype=torch.float32).reshape(P.H, k)
    other = torch.zeros((P.H, P.H if which == "wt1" else P.F))
    w1s, w2s = P.probe_weight_chunks(*((w, other) if which == "wt1" else (other, w)))
    flat = w1s if which == "wt1" else w2s
    k_outer = which == "wt1"
    kp = -(-k // 16) * 16
    full = kp // 64 * 64
    nk = full // 64
    assert flat.numel() == P.H * kp and flat.is_contiguous()
    values = flat.sort().values
    assert torch.equal(values[values > 0], w.reshape(-1)) and int((values == 0).sum()) == P.H * (kp - k)
    for n in range(0, P.H, 7):
        for kk in range(0, k, 13):
            h, row = divmod(n, 128)
            if kk < full:
                kc = kk // 64
                chunk = kc * 2 + h if k_outer else h * nk + kc
                byte = chunk * 16384 + _sw128(row, kk % 64)
            else:
                s, kr = divmod(kk - full, 16)
                byte = 2 * nk * 16384 + 8192 * s + 256 * (n // 8) + 128 * (kr // 8) + 16 * (n % 8) + 2 * (kr % 8)
            assert flat[byte // 2] == w[n, kk], (n, kk)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 GEMMs in full f32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", P.VARIANTS)
def test_cuda_probe_kernel_matches_plain(variant):
    """The kernel against `plain_probe`: bit for bit under dyadic inputs,
    within `NORMAL_REL_TOL` of the largest |acc| under normal draws; two
    launches bit for bit."""
    dev = _cuda()
    launches = P.probe_kernel_launches
    dyadic = P.to_tensors(P.probe_inputs(0, dyadic=True), dev)
    assert torch.equal(P.run_probe_kernel(variant, *dyadic), P.plain_probe(variant, *dyadic))
    normal = P.to_tensors(P.probe_inputs(0), dev)
    got, again = (P.run_probe_kernel(variant, *normal) for _ in range(2))
    want = P.plain_probe(variant, *normal)
    assert P.probe_kernel_launches == launches + 3
    assert float((got - want).abs().max()) <= P.NORMAL_REL_TOL * float(want.abs().max())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.gpu
def test_cuda_probe_table():
    """The tool's table on the card: every check of `probe_mosaic.table`."""
    _cuda()
    rows = P.table(reps=3)
    assert set(rows) == set(P.VARIANTS)
