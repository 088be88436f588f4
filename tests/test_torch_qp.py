"""The general QP solvers of the PyTorch port against the JAX package, on
the CPU: the plain twins of the batched Cholesky / SPD-solve kernels
against the Pallas kernels in interpret mode, the interior-point and ADMM
solvers, the discretization and the cached condensation.

Inputs are drawn with numpy from a seed and handed to both packages.
float64 agrees to 1e-9 (same formulas, another summation order in a few
contractions); the float32 bands are the JAX suite's own and are stated
where they are used. Every solver comparison also runs with the kernels'
plain twins forced (``plain_twins=True``), the arithmetic the CUDA kernels
repeat on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.ops import chol_pallas
from mpc_limx_control_tpu.ops import condense as jcnd
from mpc_limx_control_tpu.ops import discretize as jdsc
from mpc_limx_control_tpu.ops import qp as jqp
from mpc_limx_control_tpu_torch.ops import chol as tchol
from mpc_limx_control_tpu_torch.ops import chol_cuda
from mpc_limx_control_tpu_torch.ops import condense as tcnd
from mpc_limx_control_tpu_torch.ops import discretize as tdsc
from mpc_limx_control_tpu_torch.ops import qp as tqp

DTYPES = [pytest.param(np.float64, torch.float64, id="f64"),
          pytest.param(np.float32, torch.float32, id="f32")]
TWINS = [pytest.param(False, id="linalg"), pytest.param(True, id="twins")]


def T(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers here are host loops over thousands of LAPACK calls on
    small matrices: with several test workers on one machine a
    multi-threaded BLAS oversubscribes the cores and each call spins (a
    120-step closed loop went from 6 s alone to 18 minutes beside five
    other workers). One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, atol, msg=""):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor)
                               else np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0, err_msg=msg)


# ---- the plain K8 twins vs the Pallas kernels (interpret mode) ----------

def _spd(B, n, k, seed):
    """tests/test_qp_pallas.py:15-23: M = A A' / n + 3 I, rhs normal."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    M = np.einsum("bij,bkj->bik", A, A) / n + 3 * np.eye(n, dtype=np.float32)
    return M.astype(np.float32), rng.normal(size=(B, n, k)).astype(np.float32)


@pytest.mark.parametrize("name", ["cholesky", "chol_solve", "posdef_solve",
                                  "posdef_solve_fast"])
@pytest.mark.parametrize("n,k", [(24, 1), (24, 2), (60, 1), (1, 1), (33, 1)])
def test_chol_twin_matches_pallas_interpret(name, n, k):
    """Each plain twin against its Pallas kernel (interpret mode, B = 128)
    and against f64 numpy.linalg with the bands of
    tests/test_qp_pallas.py:31,43 (2e-5 on L, 5e-5 on x); the wrapper's
    CPU branch is the twin."""
    M, r = _spd(128, n, k, 10 * n + k)
    M64 = M.astype(np.float64)
    Mt, rt = T(M), T(r)
    with pltpu.force_tpu_interpret_mode():
        if name == "cholesky":
            out_j = chol_pallas.cholesky(jnp.asarray(M))
            out_t = tchol.cholesky_plain(Mt)
            ref, atol = np.linalg.cholesky(M64), 2e-5
            out_w = chol_cuda.cholesky(Mt)
            assert float(torch.triu(out_t, 1).abs().sum()) == 0.0
        elif name == "chol_solve":
            L = np.linalg.cholesky(M64).astype(np.float32)
            out_j = chol_pallas.chol_solve(jnp.asarray(L), jnp.asarray(r))
            out_t = tchol.chol_solve_plain(T(L), rt)
            out_w = chol_cuda.chol_solve(T(L), rt)
            ref, atol = np.linalg.solve(M64, r), 5e-5
        else:
            out_j = getattr(chol_pallas, name)(jnp.asarray(M),
                                               jnp.asarray(r))
            out_t = tchol.posdef_solve_plain(Mt, rt)
            out_w = getattr(chol_cuda, name)(Mt, rt)
            ref, atol = np.linalg.solve(M64, r), 5e-5
    close(out_t, out_j, atol, "twin vs Pallas")
    close(out_t, ref, atol, "twin vs numpy f64")
    assert torch.equal(out_w, out_t)
    assert all(k_.launches == 0 for k_ in chol_cuda.KERNELS.values())


PACKED = {"cholesky", "chol_solve", "posdef_solve"}


ALL = PACKED | {"posdef_solve_fast"}


@pytest.mark.parametrize("n,k,takes", [
    (239, 1, ALL), (239, 5, ALL), (240, 1, ALL), (256, 1, ALL),
    (257, 1, set()), (256, 96, ALL), (256, 97, PACKED), (239, 121, ALL),
    (239, 122, PACKED)])
def test_chol_size_rule(n, k, takes):
    """Which orders each K8 kernel takes within a block's 232448 bytes of
    shared memory: the packed lower triangle (n (n + 1) / 2 floats, and
    2 n where the kernel factors) up to the sweeps' n = 256;
    posdef_solve_fast also its k right-hand sides as k rows of n floats
    (to k = 96 at n = 256, 121 at n = 239)."""
    assert {name for name in chol_cuda.KERNELS
            if chol_cuda.size_reason(name, n, k) is None} == takes


def test_factor_inverse_plain_inverts_the_factor():
    M, _ = _spd(8, 24, 1, 3)
    L = tchol.cholesky_plain(T(M, torch.float64))
    Tinv = tchol.factor_inverse_plain(L)
    close(Tinv @ L, np.broadcast_to(np.eye(24), (8, 24, 24)), 1e-12)
    assert float(torch.triu(Tinv, 1).abs().sum()) == 0.0


def test_chol_wrappers_validate():
    M = torch.eye(4).expand(2, 4, 4)
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        chol_cuda.cholesky(torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="rhs"):
        chol_cuda.posdef_solve(M, torch.zeros(2, 5, 1))
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.cholesky(torch.zeros(1, 2, 2, device="meta"))
    # what shared memory allows, named in the refusal (the packed lower
    # triangle n (n + 1) / 2 and 2 n floats; posdef_solve_fast also k n
    # floats of right-hand sides)
    assert chol_cuda.smem_bytes("cholesky", 120) == 4 * (7260 + 240)
    assert chol_cuda.smem_bytes("chol_solve", 120) == 4 * 7260
    assert chol_cuda.smem_bytes("posdef_solve_fast", 60, 2) == \
        4 * (1830 + 2 * 60 + 120)
    chol_cuda._check_size("cholesky", 128, 1)
    with pytest.raises(ValueError, match="232448"):
        chol_cuda._check_size("cholesky", 300, 1)
    with pytest.raises(ValueError, match="232448"):
        chol_cuda._check_size("posdef_solve_fast", 200, 200)


# ---- QP solvers ------------------------------------------------------------

def _qp(B, n, m, seed, np_dtype, ill=False):
    """Random strictly feasible QPs (tests/test_qp_pallas.py:46-55 recipe);
    `ill` scales the variables unevenly (what Ruiz equilibration is for)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    H = np.einsum("bij,bkj->bik", A, A) / n + 3 * np.eye(n)
    f = rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n))
    h = np.abs(rng.normal(size=(B, m))) + 1.0
    if ill:
        s = np.logspace(-1.5, 1.5, n)
        H = H * s[:, None] * s[None, :]
        f = f * s
        G = G * s[None, None, :]
    return tuple(a.astype(np_dtype) for a in (H, f, G, h))


def _tol(np_dtype, f32):
    return 1e-9 if np_dtype == np.float64 else f32


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_ruiz_equilibrate(np_dtype, t_dtype):
    H, f, G, h = _qp(5, 12, 20, 0, np_dtype, ill=True)
    outs_j = jax.vmap(jqp.ruiz_equilibrate)(*map(jnp.asarray, (H, f, G, h)))
    outs_t = tqp.ruiz_equilibrate(T(H), T(f), T(G), T(h))
    for t, j in zip(outs_t, outs_j):
        close(t, j, _tol(np_dtype, 1e-5 * float(np.abs(j).max())))
    one = tqp.ruiz_equilibrate(T(H[0]), T(f[0]), T(G[0]), T(h[0]))
    assert one[0].shape == (12, 12) and one[4].shape == (12,)
    assert torch.equal(one[4], outs_t[4][0])


@pytest.mark.parametrize("twins", TWINS)
@pytest.mark.parametrize("scale", [False, True], ids=["raw", "ruiz"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_pdip_qp(np_dtype, t_dtype, scale, twins):
    """pdip_qp, 20 Newton steps: f64 1e-9 on z and the merit; f32 within
    5e-2 on z, the JAX suite's band for the same algorithm in another
    arithmetic order (tests/test_qp_pallas.py:66)."""
    H, f, G, h = _qp(6, 12, 20, 1, np_dtype, ill=scale)
    sol_j = jax.vmap(lambda *a: jqp.pdip_qp(*a, iters=20, scale=scale))(
        *map(jnp.asarray, (H, f, G, h)))
    sol_t = tqp.pdip_qp(T(H), T(f), T(G), T(h), iters=20, scale=scale,
                        plain_twins=twins)
    close(sol_t.u, sol_j.u, _tol(np_dtype, 5e-2))
    if np_dtype == np.float64:
        close(sol_t.residual, sol_j.residual, 1e-9)
    one = tqp.pdip_qp(T(H[0]), T(f[0]), T(G[0]), T(h[0]), iters=20,
                      scale=scale, plain_twins=twins)
    assert one.u.shape == (12,) and one.residual.shape == ()
    close(one.u, sol_t.u[0], _tol(np_dtype, 1e-4))


@pytest.mark.parametrize("twins", TWINS)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_batched_pdip(np_dtype, t_dtype, warm, twins):
    """_batched_pdip cold (10 steps) and with the primal-only warm start
    (6 steps) against JAX's non-Pallas branch: z, the merit and the
    threaded (z, lam); make_pdip / make_pdip_warm are the same solves."""
    H, f, G, h = _qp(7, 16, 24, 2, np_dtype)
    rng = np.random.default_rng(3)
    zw = (0.3 * rng.normal(size=(7, 16))).astype(np_dtype)
    lw = (np.abs(rng.normal(size=(7, 24))) + 0.5).astype(np_dtype)
    iters = 6 if warm else 10
    kw_j = dict(z_warm=jnp.asarray(zw), lam_warm=jnp.asarray(lw)) \
        if warm else {}
    kw_t = dict(z_warm=T(zw), lam_warm=T(lw)) if warm else {}
    sol_j, (z_j, lam_j) = jqp._batched_pdip(
        *map(jnp.asarray, (H, f, G, h)), iters, False, **kw_j)
    sol_t, (z_t, lam_t) = tqp._batched_pdip(T(H), T(f), T(G), T(h), iters,
                                            plain_twins=twins, **kw_t)
    a = _tol(np_dtype, 5e-2)
    close(sol_t.u, sol_j.u, a)
    close(z_t, z_j, a)
    if np_dtype == np.float64:
        close(sol_t.residual, sol_j.residual, 1e-9)
        close(lam_t, lam_j, 1e-9)
    assert sol_t.iterations == iters
    if warm:
        sol_m, (z_m, _) = tqp.make_pdip_warm(iters, plain_twins=twins)(
            T(H), T(f), T(G), T(h), T(zw), T(lw))
        one, (z1, lam1) = tqp.make_pdip_warm(iters, plain_twins=twins)(
            T(H[0]), T(f[0]), T(G[0]), T(h[0]), T(zw[0]), T(lw[0]))
        assert z1.shape == (16,) and lam1.shape == (24,)
    else:
        sol_m = tqp.make_pdip(iters, plain_twins=twins)(T(H), T(f), T(G),
                                                        T(h))
        # a shared H and G with batched f and h (the linear-MPC call)
        sol_s = tqp.make_pdip(iters, plain_twins=twins)(
            T(H[0]), T(f), T(G[0]), T(h))
        sol_js, _ = jqp._batched_pdip(
            jnp.broadcast_to(jnp.asarray(H[0]), H.shape), jnp.asarray(f),
            jnp.broadcast_to(jnp.asarray(G[0]), G.shape), jnp.asarray(h),
            iters, False)
        close(sol_s.u, sol_js.u, a)
    assert torch.equal(sol_m.u, sol_t.u)


@pytest.mark.parametrize("twins", TWINS)
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_admm_qp(np_dtype, t_dtype, twins):
    """admm_qp (two-sided l <= Gz <= u), cold and warm: f64 1e-9; f32 1e-4
    (50 well-conditioned iterations: rounding only)."""
    H, f, G, h = _qp(5, 12, 20, 4, np_dtype)
    lo = (-h - 0.5).astype(np_dtype)
    rng = np.random.default_rng(5)
    zw = (0.3 * rng.normal(size=(5, 12))).astype(np_dtype)
    yw = (0.1 * rng.normal(size=(5, 20))).astype(np_dtype)
    a = _tol(np_dtype, 1e-4)
    for kw_np in ({}, dict(z_warm=zw, y_warm=yw)):
        sol_j = jax.vmap(lambda H, f, G, l, u, *w: jqp.admm_qp(
            H, f, G, l, u, 50, 1.0, 1.6, *w))(
                *map(jnp.asarray, (H, f, G, lo, h, *kw_np.values())))
        sol_t = tqp.admm_qp(T(H), T(f), T(G), T(lo), T(h), iters=50,
                            plain_twins=twins,
                            **{k: T(v) for k, v in kw_np.items()})
        close(sol_t.u, sol_j.u, a)
        close(sol_t.residual, sol_j.residual, a)
    one = tqp.admm_qp(T(H[0]), T(f[0]), T(G[0]), T(lo[0]), T(h[0]),
                      plain_twins=twins)
    assert one.u.shape == (12,)


@pytest.mark.parametrize("twins", TWINS)
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_make_admm_warm(np_dtype, t_dtype, twins):
    """make_admm_warm (the dense "kinv" ADMM) against JAX's: f64 1e-9; f32
    2e-3 of the solution scale (the explicit f32 K^-1 of two libraries'
    factorizations)."""
    H, f, G, h = _qp(6, 16, 24, 6, np_dtype)
    rng = np.random.default_rng(7)
    zw = (0.3 * rng.normal(size=(6, 16))).astype(np_dtype)
    yw = np.abs(0.1 * rng.normal(size=(6, 24))).astype(np_dtype)
    sol_j, (z_j, y_j) = jax.vmap(jqp.make_admm_warm(
        iters=12, rho=0.3, alpha=1.6, use_pallas=False))(
            *map(jnp.asarray, (H, f, G, h, zw, yw)))
    sol_t, (z_t, y_t) = tqp.make_admm_warm(
        iters=12, rho=0.3, alpha=1.6, plain_twins=twins)(
            T(H), T(f), T(G), T(h), T(zw), T(yw))
    a = _tol(np_dtype, 2e-3 * (float(np.abs(z_j).max()) + 1.0))
    close(z_t, z_j, a)
    close(y_t, y_j, a)
    close(sol_t.residual, sol_j.residual, a)
    one, (z1, y1) = tqp.make_admm_warm(iters=12, rho=0.3, plain_twins=twins)(
        T(H[0]), T(f[0]), T(G[0]), T(h[0]), T(zw[0]), T(yw[0]))
    assert z1.shape == (16,) and y1.shape == (24,)
    close(z1, z_t[0], _tol(np_dtype, 1e-4))


def test_linv_form_matches_subst_f64():
    """The "linv" twin (explicit factor inverse) and the "subst" twin are
    the same iteration in exact arithmetic: 1e-9 in f64."""
    H, f, G, h = _qp(4, 16, 24, 8, np.float64)
    zw, yw = T(np.zeros((4, 16))), T(np.zeros((4, 24)))
    outs = {form: tqp._batched_admm(T(H), T(f), T(G), T(h), zw, yw, 10, 0.3,
                                    1.6, form)[0].u
            for form in tqp.SOLVE_FORMS}
    close(outs["linv"], outs["subst"], 1e-9)
    close(outs["kinv"], outs["subst"], 1e-9)


# ---- discretization ---------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_zoh_and_taylor_f64(batched):
    rng = np.random.default_rng(11)
    shape = (3,) if batched else ()
    Ac = rng.normal(size=(*shape, 5, 5))
    Bc = rng.normal(size=(*shape, 5, 2))
    for jf, tf in ((jdsc.zoh, tdsc.zoh), (jdsc.zoh_taylor, tdsc.zoh_taylor)):
        Ad_j, Bd_j = jf(jnp.asarray(Ac), jnp.asarray(Bc), 0.02)
        Ad_t, Bd_t = tf(T(Ac), T(Bc), 0.02)
        close(Ad_t, Ad_j, 1e-10)
        close(Bd_t, Bd_j, 1e-10)
    close(tdsc.zoh_taylor(T(Ac), T(Bc), 0.02)[0], tdsc.zoh(T(Ac), T(Bc),
                                                          0.02)[0], 1e-12)


# ---- the cached condensation ------------------------------------------

def _lti(seed):
    rng = np.random.default_rng(seed)
    nx, nu, N = 4, 2, 6
    Ad = np.eye(nx) + 0.1 * rng.normal(size=(nx, nx))
    Bd = 0.2 * rng.normal(size=(nx, nu))
    Q = np.diag(rng.uniform(1.0, 5.0, nx))
    R = np.diag(rng.uniform(0.1, 1.0, nu))
    return nx, nu, N, Ad, Bd, Q, R, 3.0 * Q, rng


@pytest.mark.parametrize("state_rows", [True, False], ids=["xbox", "ubox"])
def test_condense_cache_and_linear_terms_f64(state_rows):
    nx, nu, N, Ad, Bd, Q, R, P, rng = _lti(13)
    x0 = rng.normal(size=(5, nx))
    x_ref = rng.normal(size=(5, N + 1, nx))
    x_min, x_max = -2.0 * np.ones(nx), 3.0 * np.ones(nx)
    cj = jcnd.condense_cache(*map(jnp.asarray, (Ad, Bd, Q, R, P)), N,
                             with_state_rows=state_rows)
    ct = tcnd.condense_cache(T(Ad), T(Bd), T(Q), T(R), T(P), N,
                             with_state_rows=state_rows)
    for k in ("A_blocks", "B_mat", "QB", "H", "G"):
        close(getattr(ct, k), getattr(cj, k), 1e-10, k)
    assert (ct.N, ct.nx, ct.nu) == (N, nx, nu)
    box = (x_min, x_max) if state_rows else ()
    f_j, h_j = jax.vmap(lambda x, r: jcnd.linear_terms(
        cj, x, r, -8.0, 8.0, *map(jnp.asarray, box)))(
            jnp.asarray(x0), jnp.asarray(x_ref))
    f_t, h_t = tcnd.linear_terms(ct, T(x0), T(x_ref), -8.0, 8.0,
                                 *map(T, box))
    close(f_t, f_j, 1e-10)
    close(h_t, h_j, 1e-10)
    # one scenario, and a reference shared by the batch
    f1, h1 = tcnd.linear_terms(ct, T(x0[0]), T(x_ref[0]), -8.0, 8.0,
                               *map(T, box))
    close(f1, f_j[0], 1e-10)
    f_s, _ = tcnd.linear_terms(ct, T(x0), T(x_ref[0]), -8.0, 8.0,
                               *map(T, box))
    close(f_s[0], f_j[0], 1e-10)


def test_condense_state_rows_and_predict_states_f64():
    """condense with the state box (the rows the port left out before) and
    predict_states, batched, against JAX per scenario."""
    nx, nu, N, Ad, Bd, Q, R, P, rng = _lti(17)
    B = 4
    Ads = Ad[None] + 0.01 * rng.normal(size=(B, nx, nx))
    Bds = Bd[None] + 0.01 * rng.normal(size=(B, N, nx, nu))
    x0 = rng.normal(size=(B, nx))
    x_ref = rng.normal(size=(B, N + 1, nx))
    x_min, x_max = -2.0 * np.ones(nx), 3.0 * np.ones(nx)
    z = rng.normal(size=(B, N * nu))

    def jfn(a, b, x, r, zz):
        qp = jcnd.condense(a, b, *map(jnp.asarray, (Q, R, P)), N, x, r, -8.0,
                           8.0, jnp.asarray(x_min), jnp.asarray(x_max))
        return qp, jcnd.predict_states(qp, x, zz)

    qj, xs_j = jax.vmap(jfn)(*map(jnp.asarray, (Ads, Bds, x0, x_ref, z)))
    qt = tcnd.condense(T(Ads), T(Bds), T(Q), T(R), T(P), N, T(x0), T(x_ref),
                       -8.0, 8.0, T(x_min), T(x_max))
    for k in ("H", "f", "G", "h"):
        close(getattr(qt, k), getattr(qj, k), 1e-10, k)
    assert qt.G.shape == (B, 2 * N * nu + 2 * N * nx, N * nu)
    close(tcnd.predict_states(qt, T(x0), T(z)), xs_j, 1e-10)
