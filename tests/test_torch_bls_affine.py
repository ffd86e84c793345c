"""The port's Jacobian -> affine conversion (K2 ``to_affine``, whose kernel
runs one batch inversion a block of 64 lanes) against the JAX package's
``g1_jac_to_affine`` and ``g2_jac_to_affine``
(lighthouse_tpu/ops/bls381_verify.py:122/138). Seeded Jacobian points
(Z != 1) with infinity lanes and an affine one (Z = 1) go through both;
the port runs its plain version on the CPU. Tolerance: exact equality of
integers at the seam (coordinates decoded from each package's limbs to
field elements, never limbs compared), and of the infinity masks: JAX's
third output against the verifier's ``_inf_mask``. One shape per group,
so each JAX function compiles once (seconds on a CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import bls_g1_points, bls_g2_points
from lighthouse_tpu.ops import bls381_verify as jax_verify
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, inf, to_affine
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops.bls381_verify import _inf_mask

LANES = 33  # the verifier's largest launch: the RLC signature sum and 32 H(m)
INFINITY = (0, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_equals_jax_jac_to_affine(group):
    F = FQ if group == "g1" else FQ2
    rng = np.random.default_rng(31 if group == "g1" else 32)
    pts = (bls_g1_points if group == "g1" else bls_g2_points)(rng, LANES)
    pts[5] = (*to_affine(F, pts[5]), F.one)
    for j in INFINITY:
        pts[j] = inf(F)
    p = torch.from_numpy((K2.g1_to_limbs if group == "g1" else K2.g2_to_limbs)(pts))
    got = K2.to_affine(group, p)

    jl = jnp.asarray(K2.limbs_to_jax(p.numpy()))
    jax_fn = jax_verify.g1_jac_to_affine if group == "g1" else jax_verify.g2_jac_to_affine
    ax, ay, jax_inf = jax_fn(jl[:, 0], jl[:, 1], jl[:, 2])
    want_x = K2.fq_from_limbs(K2.limbs_from_jax(np.asarray(ax)))
    want_y = K2.fq_from_limbs(K2.limbs_from_jax(np.asarray(ay)))

    assert K2.fq_from_limbs(got[:, 0].numpy()) == want_x
    assert K2.fq_from_limbs(got[:, 1].numpy()) == want_y
    assert np.array_equal(np.asarray(jax_inf), _inf_mask(p).numpy())
    assert np.flatnonzero(np.asarray(jax_inf)).tolist() == list(INFINITY)
    # the infinity lanes are (0, 0) in both packages; the others the
    # host oracle's affine coordinates
    width = 1 if group == "g1" else 2
    for j, pt in enumerate(pts):
        xs, ys = want_x[j * width : (j + 1) * width], want_y[j * width : (j + 1) * width]
        if j in INFINITY:
            assert xs == [0] * width and ys == [0] * width
        else:
            ox, oy = to_affine(F, pt)
            assert (xs, ys) == (([ox], [oy]) if group == "g1" else (list(ox), list(oy)))
