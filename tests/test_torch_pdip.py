"""The plain version of the fused interior-point kernel (K9,
``ops/qp_cuda.py:pdip_fused_plain``) against the JAX package's Pallas
kernel ``qp_pallas.pdip_fused`` in interpret mode, on the CPU.

Two QPs at B = 128: the recipe of tests/test_qp_pallas.py:46-58 (n = 30,
which is not a multiple of 8, so the JAX wrapper pads it; m = 64) and the
condensed walking QP at horizon 8 (n = 24, m = 48) from its cold start;
and the recipe at the standing width (n = 120, m = 240) after 1 and 6
steps, in the bands below (measured: the merit 1.7e-6 of itself after 1
step, 3.1e-3 after 6, inside the floor band; z and lam within 3.6e-6 of
their scale). Each interpret call runs once per module. float32 bands,
with the measured errors they were set against:

* 0 and 1 Newton steps, where the merit stands far above the f32 floor
  (O(0.1-10); the walking QP starts infeasible, so every term counts):
  the merit within 1e-3 of itself (measured 1.3e-5 of it), z and lam
  within 1e-4 of their scale;
* 6 Newton steps, where M is well conditioned: all four outputs, z within
  1e-4 of its scale (measured 5.0e-6 on the recipe, 4.6e-3 on 153 N on
  the walking QP), lam within 1e-4 of its scale (1.5e-5); the merit is at
  the f32 floor by then (two arithmetic orders of the plain version part
  by up to 1.5x the merit; this and the Pallas kernel by 0.71x the
  recipe's, 1.06x the walking QP's), so it is held within 1e-3 of itself
  plus 8x its floor, the change of the plain version's merit when the
  constraint rows are taken in reverse order (measured 0.13 of that
  band);
* 10 steps: d = lam / s reaches its 1e7 cap and late iterates lose
  positive definiteness (z_final / lam_final go NaN in 97 % of the
  recipe's scenarios, in JAX and here; the best iterate stays finite):
  z_best within 5e-3 of its scale (4.0e-3 on 0.81;
  tests/test_qp_pallas.py:66 holds 5e-2 against the unfused solver), the
  merit within the band of 6 steps (0.14 of it), z_final where both are
  finite within 1e-3 of its scale (1.1e-6); lam_final is not held (the
  two arithmetic orders part by 0.27 on the worst multiplier).

float64 (interpret mode takes it): all four to 1e-9 at 6 steps (measured
5e-14), z_best, merit and z_final to 1e-9 at 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.ops import qp_pallas
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.models import srbd as tsrbd
from mpc_limx_control_tpu_torch.ops import condense as tcnd
from mpc_limx_control_tpu_torch.ops import qp_cuda

OUT = ("z_best", "merit", "z_final", "lam_final")
B = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain solve is a host loop over many small torch calls; one
    thread per test worker keeps a multi-threaded BLAS from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recipe(dtype, n=30, m=64):
    """tests/test_qp_pallas.py:46-58: H = A A' / n + 3 I, f, G normal,
    h = |normal| + 1, z0 = 0, s0 = lam0 = 1."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    H = (np.einsum("bij,bkj->bik", A, A) / n
         + 3 * np.eye(n, dtype=np.float32))
    f = rng.normal(size=(B, n)).astype(np.float32)
    G = rng.normal(size=(B, m, n)).astype(np.float32)
    h = (np.abs(rng.normal(size=(B, m))) + 1.0).astype(np.float32)
    args = (H, f, G, h, np.zeros((B, n)), np.ones((B, m)), np.ones((B, m)))
    return [np.asarray(a, dtype) for a in args]


def _walking_qp(dtype):
    """The condensed single-support walking QP at horizon 8 (n = 24,
    m = 48) of perturbed poses, from the cold start of ops/qp.py's PDIP
    (z0 = -H^-1 f, slacks pushed interior by 1, lam0 = 1); built in
    float64 and rounded once."""
    cfg = TCfg.walking()
    c = cfg.srbd
    N = 8
    rng = np.random.default_rng(3)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64))

    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    x0 = tsrbd.initial_state(t(ori), t(pos), t(np.zeros((B, 3))),
                             t(np.tile([0.4, 0.0, 0.0], (B, 1))))
    Ac, Bc = tsrbd.linearize_shared(cfg.robot, t(arms), x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = tsrbd.discretize_srbd(Ac, Bc, c.ts)
    x_ref = tsrbd.walking_reference(x0, c, N, t(np.tile([0.5, 0, 0], (B, 1))),
                                    t(0.05 * rng.standard_normal(B)),
                                    height_des=0.65)
    G, h = tsrbd.friction_cone_rows(c, N, torch.float64)
    qp = tcnd.condense(Ad, Bd_t, torch.diag(t(c.q_diag)),
                       torch.diag(t(c.r_diag)),
                       torch.diag(c.p_scale * t(c.q_diag)), N, x0, x_ref,
                       extra_G=G, extra_h=h)
    H, f = qp.H.numpy(), qp.f.numpy()
    G, h = np.broadcast_to(G.numpy(), (B, *G.shape)), np.tile(h.numpy(),
                                                              (B, 1))
    z0 = -np.linalg.solve(H + 1e-6 * np.eye(H.shape[-1]), f[..., None])[..., 0]
    s_raw = h - np.einsum("bmn,bn->bm", G, z0)
    s0 = s_raw + np.maximum(-s_raw.min(-1, keepdims=True), 0.0) + 1.0
    args = (H, f, G, h, z0, s0, np.ones_like(h))
    return [np.ascontiguousarray(a, dtype) for a in args]


CASES = {"recipe": _recipe, "walking_n24": _walking_qp}
BUILDERS = {**CASES, "recipe_n120": lambda dtype: _recipe(dtype, 120, 240)}


@pytest.fixture(scope="module")
def runs():
    """(case, dtype, iters) -> (inputs, JAX interpret outputs), computed
    once per key."""
    cache = {}

    def get(case, dtype, iters):
        key = (case, dtype, iters)
        if key not in cache:
            args = BUILDERS[case](dtype)
            with pltpu.force_tpu_interpret_mode():
                out = qp_pallas.pdip_fused(*map(jnp.asarray, args),
                                           iters=iters)
            cache[key] = args, [np.asarray(o) for o in out]
        return cache[key]

    return get


def _plain(args, iters):
    return [o.numpy() for o in qp_cuda.pdip_fused(
        *[torch.tensor(a) for a in args], iters=iters)]


def _scale(a):
    return float(np.nanmax(np.abs(a))) + 1.0


def _merit_band(args, out, iters):
    """1e-3 of the merit plus 8x its f32 floor: the largest change of the
    plain version's merit when the constraint rows are taken in reverse
    order (the same QPs in another arithmetic order)."""
    rev = [np.ascontiguousarray(a[:, ::-1]) if i in (2, 3, 5, 6) else a
           for i, a in enumerate(args)]
    floor = np.abs(_plain(rev, iters)[1] - out[1]).max()
    return 1e-3 * np.abs(out[1]) + 8.0 * floor


@pytest.mark.parametrize("iters", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_f32_first_steps(runs, case, iters):
    args, ref = runs(case, np.float32, iters)
    out = _plain(args, iters)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-3, atol=0)
    for i in (0, 2, 3):
        np.testing.assert_allclose(out[i], ref[i], atol=1e-4 * _scale(ref[i]),
                                   rtol=0, err_msg=OUT[i])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_f32_six_steps(runs, case):
    args, ref = runs(case, np.float32, 6)
    out = _plain(args, 6)
    for name, o, r in zip(OUT, out, ref):
        assert np.isfinite(r).all() and np.isfinite(o).all(), name
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4 * _scale(ref[0]),
                               rtol=0)
    assert (np.abs(out[1] - ref[1]) <= _merit_band(args, out, 6)).all()
    np.testing.assert_allclose(out[2], ref[2], atol=1e-4 * _scale(ref[2]),
                               rtol=0)
    np.testing.assert_allclose(out[3], ref[3], atol=1e-4 * _scale(ref[3]),
                               rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_f32_ten_steps(runs, case):
    args, ref = runs(case, np.float32, 10)
    out = _plain(args, 10)
    assert np.isfinite(out[0]).all() and np.isfinite(out[1]).all()
    np.testing.assert_allclose(out[0], ref[0], atol=5e-3 * _scale(ref[0]),
                               rtol=0)
    assert (np.abs(out[1] - ref[1]) <= _merit_band(args, out, 10)).all()
    # late iterates go NaN in most scenarios of the recipe (not always the
    # same ones: a pivot near zero rounds either way); where both are
    # finite, close
    fin = np.isfinite(ref[2]) & np.isfinite(out[2])
    np.testing.assert_allclose(out[2][fin], ref[2][fin],
                               atol=1e-3 * _scale(ref[2]), rtol=0)


@pytest.mark.parametrize("iters", [1, 6])
def test_plain_matches_pallas_interpret_f32_standing_width(runs, iters):
    """n / m = 120 / 240, the standing QP's width: after 1 step the merit
    within 1e-3 of itself, after 6 within its floor band (8x the change
    when the constraint rows are reversed, as above); all four outputs
    finite, z_best, z_final and lam_final within 1e-4 of their scale."""
    args, ref = runs("recipe_n120", np.float32, iters)
    out = _plain(args, iters)
    for name, o, r in zip(OUT, out, ref):
        assert np.isfinite(r).all() and np.isfinite(o).all(), name
    if iters == 1:
        np.testing.assert_allclose(out[1], ref[1], rtol=1e-3, atol=0)
    else:
        assert (np.abs(out[1] - ref[1]) <= _merit_band(args, out, 6)).all()
    for i in (0, 2, 3):
        np.testing.assert_allclose(out[i], ref[i], atol=1e-4 * _scale(ref[i]),
                                   rtol=0, err_msg=OUT[i])


@pytest.mark.parametrize("iters", [6, 10])
def test_plain_matches_pallas_interpret_f64(runs, iters):
    args, ref = runs("recipe", np.float64, iters)
    out = _plain(args, iters)
    held = OUT if iters == 6 else OUT[:3]
    for name in held:
        i = OUT.index(name)
        np.testing.assert_allclose(out[i], ref[i], atol=1e-9, rtol=0,
                                   err_msg=name)


def test_wrapper_cpu_branch_is_the_plain_version():
    args = [torch.tensor(a) for a in _recipe(np.float32)]
    before = qp_cuda.PDIP_FUSED.launches
    out = qp_cuda.pdip_fused(*args, iters=3)
    ref = qp_cuda.pdip_fused_plain(*args, iters=3)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert qp_cuda.PDIP_FUSED.launches == before
    assert [tuple(o.shape) for o in out] == [(B, 30), (B,), (B, 30), (B, 64)]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises: non-float32
    (TypeError), a shape past the shared memory (ValueError naming the
    limit), mismatched shapes, a device that is not CUDA."""
    def meta(n, m, dtype=torch.float32, b=2):
        return [torch.empty(s, dtype=dtype, device="meta") for s in
                ((b, n, n), (b, n), (b, m, n), (b, m), (b, n), (b, m),
                 (b, m))]

    with pytest.raises(TypeError, match="float32"):
        qp_cuda.pdip_fused(*meta(30, 64, torch.float64))
    with pytest.raises(ValueError, match="232448"):
        qp_cuda.pdip_fused(*meta(60, 1000))      # G in shared memory
    with pytest.raises(ValueError, match="232448"):
        qp_cuda.pdip_fused(*meta(120, 3600))     # G streamed: 13 m-vectors
    with pytest.raises(ValueError, match="232448"):
        qp_cuda.pdip_fused(*meta(300, 8))
    with pytest.raises(ValueError, match="CUDA"):
        qp_cuda.pdip_fused(*meta(120, 240))
    bad = meta(30, 64)
    bad[3] = torch.empty((2, 63), device="meta")
    with pytest.raises(ValueError, match="h"):
        qp_cuda.pdip_fused(*bad)
    with pytest.raises(ValueError, match="iters"):
        qp_cuda.pdip_fused(*meta(30, 64), iters=-1)
    # what fits: G's rows (n <= 64) or two 16-row chunk buffers of it, rows
    # of a multiple of four floats; M's packed lower triangle, the vectors
    assert qp_cuda.smem_bytes(61, 122) == 4 * (122 * 64 + 1891 + 122 + 305
                                               + 13 * 122 + 32)
    assert qp_cuda.smem_bytes(120, 240) == 4 * (32 * 120 + 7260 + 240
                                                + 600 + 13 * 240 + 32)
    assert qp_cuda.smem_bytes(120, 3549) <= qp_cuda.SMEM_LIMIT_BYTES
    assert qp_cuda.smem_bytes(120, 240) <= qp_cuda.SMEM_LIMIT_BYTES
