"""The port's structure-exploiting fast paths against the dense pipeline and
against the JAX package, on the CPU (numpy-seeded inputs, float64 unless
stated):

* ``ops/condense.py:condense_lti_diag`` -- the band-form H / f (LTI Ad,
  diagonal weights) equals the dense condensation (reference layout,
  src/QPSolver.cpp:50-60) and JAX's ``condense_lti_diag``;
* ``ops/qp.py:make_admm_warm_kron`` -- the block-diagonal-cone ADMM gives
  the iterates of the dense ADMM on the expanded G = kron(I, Gu) and of
  JAX's ``make_admm_warm_kron``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_limx_control_tpu.ops import condense as jcnd
from mpc_limx_control_tpu.ops import qp as jqp
from mpc_limx_control_tpu_torch.ops import condense as tcnd
from mpc_limx_control_tpu_torch.ops import qp as tqp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker while this module runs (several
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_problem(rng, N=20, nx=13, nu=3):
    """A stable-ish LTI Ad close to identity (the SRBD discretization's
    shape), per-step Bd, positive diagonal weights, x0 and x_ref."""
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    Bd_t = 0.3 * rng.standard_normal((N, nx, nu))
    q = np.abs(rng.standard_normal(nx)) + 0.1
    r = np.abs(rng.standard_normal(nu)) + 0.1
    return (Ad, Bd_t, q, r, 20.0 * q, rng.standard_normal(nx),
            rng.standard_normal((N + 1, nx)))


def _dense(Ad, Bd_t, q, r, p, N, x0, x_ref):
    """The port's dense condensation of one or a batch of problems (one
    zero constraint row: the dense form needs one)."""
    t = torch.tensor
    x0 = t(x0)
    one = x0.ndim == 1
    if one:
        Ad, Bd_t, x0, x_ref = Ad[None], Bd_t[None], x0[None], x_ref[None]
    nz = N * Bd_t.shape[-1]
    qp = tcnd.condense(t(Ad), t(Bd_t), torch.diag(t(q)), torch.diag(t(r)),
                       torch.diag(t(p)), N, x0, t(x_ref),
                       extra_G=torch.zeros(1, nz, dtype=torch.float64),
                       extra_h=torch.zeros(1, dtype=torch.float64))
    return (qp.H[0], qp.f[0]) if one else (qp.H, qp.f)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_condensation_matches_dense_and_jax(seed):
    N = 20
    Ad, Bd_t, q, r, p, x0, x_ref = _random_problem(
        np.random.default_rng(seed), N=N)
    H, f = tcnd.condense_lti_diag(torch.tensor(Ad), torch.tensor(Bd_t), q,
                                  r, p, N, torch.tensor(x0),
                                  torch.tensor(x_ref))
    H_d, f_d = _dense(Ad, Bd_t, q, r, p, N, x0, x_ref)
    close(H, H_d, 1e-10)
    close(f, f_d, 1e-10)
    H_j, f_j = jcnd.condense_lti_diag(*map(jnp.asarray, (Ad, Bd_t)), q, r, p,
                                      N, jnp.asarray(x0), jnp.asarray(x_ref))
    close(H, H_j, 1e-10)
    close(f, f_j, 1e-10)


def test_band_condensation_batched():
    """Batch-first (the JAX function's vmap) equals the per-scenario dense
    condensation and JAX's vmapped band form."""
    B, N, nx, nu = 4, 8, 5, 2
    rng = np.random.default_rng(7)
    probs = [_random_problem(rng, N=N, nx=nx, nu=nu) for _ in range(B)]
    Ad, Bd, x0, xr = (np.stack([pb[i] for pb in probs]) for i in (0, 1, 5, 6))
    q, r, p = probs[0][2:5]
    H, f = tcnd.condense_lti_diag(*map(torch.tensor, (Ad, Bd)), q, r, p, N,
                                  torch.tensor(x0), torch.tensor(xr))
    assert H.shape == (B, N * nu, N * nu) and f.shape == (B, N * nu)
    H_d, f_d = _dense(Ad, Bd, q, r, p, N, x0, xr)
    close(H, H_d, 1e-9)
    close(f, f_d, 1e-9)
    H_j, f_j = jax.vmap(lambda a, b, x, y: jcnd.condense_lti_diag(
        a, b, q, r, p, N, x, y))(*map(jnp.asarray, (Ad, Bd, x0, xr)))
    close(H, H_j, 1e-9)
    close(f, f_j, 1e-9)


def test_band_condensation_leading_dims_broadcast():
    """Any leading batch dims: a [2, 3] batch equals the flat batch of 6,
    and a shared Ad broadcasts against batched Bd / x0 / x_ref."""
    N, nx, nu = 6, 5, 2
    rng = np.random.default_rng(3)
    probs = [_random_problem(rng, N=N, nx=nx, nu=nu) for _ in range(6)]
    Ad, Bd, x0, xr = (torch.tensor(np.stack([pb[i] for pb in probs]))
                      for i in (0, 1, 5, 6))
    q, r, p = probs[0][2:5]
    H, f = tcnd.condense_lti_diag(Ad, Bd, q, r, p, N, x0, xr)
    H2, f2 = tcnd.condense_lti_diag(
        Ad.reshape(2, 3, nx, nx), Bd.reshape(2, 3, N, nx, nu), q, r, p, N,
        x0.reshape(2, 3, nx), xr.reshape(2, 3, N + 1, nx))
    close(H2.reshape(H.shape), H, 1e-12)
    close(f2.reshape(f.shape), f, 1e-12)
    Hs, fs = tcnd.condense_lti_diag(Ad[0], Bd, q, r, p, N, x0, xr)
    for i in range(6):
        Hi, fi = tcnd.condense_lti_diag(Ad[0], Bd[i], q, r, p, N, x0[i],
                                        xr[i])
        close(Hs[i], Hi, 1e-12)
        close(fs[i], fi, 1e-12)


def test_band_condensation_float32():
    """In float32 (the card's working type; the package pins TF32 off) the
    band form stays within 1e-5 of 1 + the largest entry of its float64
    result (chip_smoke.py's [band_kron] band)."""
    N = 20
    Ad, Bd_t, q, r, p, x0, x_ref = _random_problem(np.random.default_rng(5),
                                                   N=N)
    args = [torch.tensor(a) for a in (Ad, Bd_t, x0, x_ref)]
    H64, f64 = tcnd.condense_lti_diag(args[0], args[1], q, r, p, N, *args[2:])
    H32, f32 = tcnd.condense_lti_diag(*(a.float() for a in args[:2]), q, r,
                                      p, N, *(a.float() for a in args[2:]))
    assert H32.dtype == torch.float32
    for a, b in ((H32, H64), (f32, f64)):
        assert float((a.double() - b).abs().max()) <= 1e-5 * (
            1.0 + float(b.abs().max()))


def _kron_problem(B=6, N=10, nu=3, mu=6, seed=3):
    rng = np.random.default_rng(seed)
    n, m = N * nu, N * mu
    M = rng.standard_normal((B, n, n))
    H = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(n)
    f = rng.standard_normal((B, n))
    Gu = rng.standard_normal((mu, nu))
    h = np.abs(rng.standard_normal((B, m))) + 0.5
    z0 = 0.1 * rng.standard_normal((B, n))
    return H, f, Gu, np.kron(np.eye(N), Gu), h, z0, np.zeros((B, m))


@pytest.mark.parametrize("iters", [1, 5, 25])
def test_admm_kron_matches_dense_admm_and_jax(iters):
    """Kron-structured ADMM == the dense ADMM on the expanded G and JAX's
    make_admm_warm_kron, iterate for iterate (same rho / alpha / warm
    start)."""
    H, f, Gu, G, h, z0, y0 = _kron_problem()
    t = torch.tensor
    kw = dict(iters=iters, rho=0.7, alpha=1.5)
    sol_k, (zk, yk) = tqp.make_admm_warm_kron(t(Gu), **kw)(
        t(H), t(f), t(h), t(z0), t(y0))
    sol_d, (zd, yd) = tqp.make_admm_warm(**kw)(t(H), t(f), t(G), t(h),
                                                t(z0), t(y0))
    for a, b in ((sol_k.u, sol_d.u), (zk, zd), (yk, yd),
                 (sol_k.residual, sol_d.residual)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10)
    kron_j = jqp.make_admm_warm_kron(jnp.asarray(Gu), use_pallas=False, **kw)
    sol_j, (zj, yj) = jax.vmap(kron_j)(*map(jnp.asarray, (H, f, h, z0, y0)))
    for a, b in ((zk, zj), (yk, yj), (sol_k.residual, sol_j.residual)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


def test_admm_kron_one_problem_and_plain_twins():
    """One unbatched problem gives its row of the batch; plain_twins (the
    plain Cholesky of ops/chol.py) gives the library factorization's
    iterates in float64."""
    H, f, Gu, _, h, z0, y0 = _kron_problem(B=3, N=4, seed=9)
    t = torch.tensor
    solve = tqp.make_admm_warm_kron(t(Gu), iters=8)
    sol, (z, y) = solve(t(H), t(f), t(h), t(z0), t(y0))
    sol1, (z1, y1) = solve(t(H[1]), t(f[1]), t(h[1]), t(z0[1]), t(y0[1]))
    assert z1.shape == z[1].shape and y1.shape == y[1].shape
    assert sol1.residual.ndim == 0
    np.testing.assert_allclose(z1.numpy(), z[1].numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(y1.numpy(), y[1].numpy(), rtol=1e-12,
                               atol=1e-12)
    _, (zt, yt) = tqp.make_admm_warm_kron(t(Gu), iters=8, plain_twins=True)(
        t(H), t(f), t(h), t(z0), t(y0))
    np.testing.assert_allclose(zt.numpy(), z.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(yt.numpy(), y.numpy(), rtol=1e-9, atol=1e-10)
