"""The fused fixed-iteration interior-point solve: CUDA kernel wrapper and
plain version.

Counterpart of ``mpc_limx_control_tpu.ops.qp_pallas``: :func:`pdip_fused`
(qp_pallas.py:161, pallas_call :206 -> ``_pdip_kernel`` :54 ->
``_pdip_body`` :84) runs the whole Mehrotra predictor-corrector solve of a
batch of dense QPs

    min_z 1/2 z'Hz + f'z   s.t.   G z <= h

from a given (z0, s0, lam0) for a fixed number of Newton steps, and returns
the best iterate by merit. As in the JAX package it is an entry point of
its own: no controller path calls it (ROADMAP).

CUDA tensors launch ``csrc/pdip_fused.cu`` (one block per QP, float32, any
B >= 1 and any n the shared memory holds; no padding); CPU tensors run
:func:`pdip_fused_plain`, the same steps in batch-first torch. Nothing
falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops import chol as cholp
from mpc_limx_control_tpu_torch.ops.qp import _max_step, _mtv, _mv

SMEM_LIMIT_BYTES = 232448     # what a block can opt in to on sm_90
MAX_N = 256                   # eight rows per lane in a substitution sweep
EPS, D_CAP, REG = 1e-8, 1e7, 1e-6     # qp_pallas.py:172
CHUNK = 8                     # rows of G per partial sum of G'DG (_form_m)

PDIP_FUSED = _build.Kernel("pdip_fused", n_ptr=11,
                           params_sizer="pdip_params_bytes")


class PdipParams(ctypes.Structure):
    """Mirror of ``PdipParams`` in csrc/pdip_fused.cu."""

    _fields_ = [("n", ctypes.c_int), ("m", ctypes.c_int),
                ("iters", ctypes.c_int)]


G_SHARED_MAX_N = 64           # G in shared memory up to here, else streamed
G_CHUNK_ROWS = 16             # rows of G a chunk buffer holds (streamed)


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory per block (csrc/pdip_fused.cu): G's m rows (n
    <= 64) or two chunk buffers of 16 rows (G streamed from device memory),
    rows of n rounded up to a multiple of four floats; M's packed lower
    triangle (n (n + 1) / 2 floats), the factor's diagonal and its
    reciprocal, 5 n- and 13 m-vectors and 32 floats of reduction scratch.
    H stays in device memory."""
    g_rows = m if n <= G_SHARED_MAX_N else 2 * G_CHUNK_ROWS
    return 4 * (g_rows * (-(-n // 4) * 4) + n * (n + 1) // 2 + 2 * n + 5 * n
                + 13 * m + 32)


def _form_m(H, G, d):
    """M = H + G' diag(d) G, accumulated over CHUNK rows of G at a time as
    qp_pallas.py:_form_m does."""
    Gd = G * d[..., None]
    M = H
    for lo in range(0, G.shape[-2], CHUNK):
        M = M + Gd[:, lo:lo + CHUNK].transpose(-1, -2) @ G[:, lo:lo + CHUNK]
    return M


def pdip_iterates(H, f, G, h, z0, s0, lam0, iters: int = 6):
    """The iterates of the fused kernel's solve in batch-first torch: yields
    (z, s, lam, merit) at the start and after each of the `iters` Newton
    steps, in ``_pdip_body``'s order: residuals, d = min(lam / max(s, eps),
    d_cap), M = H + G'DG + reg I, the column-loop Cholesky with the 1e-30
    pivot clamp and explicit sweeps (``ops/chol.py``), the affine and the
    corrector direction, fraction-to-boundary steps, the 0.99-damped step
    and the merit max|r_dual| / (1 + max|f|) + max(r_prim+) + mu / mu0.

    H [B,n,n], f [B,n], G [B,m,n], h / s0 / lam0 [B,m], z0 [B,n]; any
    floating dtype (the constants are the float32 kernel's).
    """
    m = h.shape[-1]
    n = f.shape[-1]
    eye_reg = REG * torch.eye(n, dtype=H.dtype, device=H.device)
    z, s, lam = z0, s0, lam0
    f_scale = 1.0 + f.abs().amax(-1)
    mu0 = (s * lam).sum(-1) / m

    def merit_of(z, s, lam):
        r_dual = _mv(H, z) + f + _mtv(G, lam)
        r_prim = torch.clamp(_mv(G, z) - h, min=0.0)
        mu = (s * lam).sum(-1) / m
        return r_dual.abs().amax(-1) / f_scale + r_prim.amax(-1) + mu / mu0

    yield z, s, lam, merit_of(z, s, lam)
    for _ in range(iters):
        r_dual = _mv(H, z) + f + _mtv(G, lam)
        r_prim = _mv(G, z) + s - h
        mu = (s * lam).sum(-1) / m
        s_safe = torch.clamp(s, min=EPS)
        d = torch.clamp(lam / s_safe, max=D_CAP)
        L = cholp.cholesky_plain(_form_m(H, G, d) + eye_reg)

        def direction(r_comp):
            rhs = -r_dual + _mtv(G, (r_comp - lam * r_prim) / s_safe)
            dz = cholp.chol_solve_plain(L, rhs[..., None])[..., 0]
            ds = -r_prim - _mv(G, dz)
            return dz, ds, -(r_comp + lam * ds) / s_safe

        _, ds_a, dlam_a = direction(s * lam)
        a_aff = torch.minimum(_max_step(s, ds_a),
                              _max_step(lam, dlam_a))[..., None]
        mu_aff = ((s + a_aff * ds_a) * (lam + a_aff * dlam_a)).sum(-1) / m
        ratio = mu_aff / torch.clamp(mu, min=EPS)
        sigma = ratio * ratio * ratio
        dz, ds, dlam = direction(s * lam - (sigma * mu)[..., None]
                                 + ds_a * dlam_a)
        alpha = (0.99 * torch.minimum(_max_step(s, ds),
                                      _max_step(lam, dlam)))[..., None]
        z = z + alpha * dz
        s = torch.clamp(s + alpha * ds, min=EPS)
        lam = torch.clamp(lam + alpha * dlam, min=EPS)
        yield z, s, lam, merit_of(z, s, lam)


def pdip_fused_plain(H, f, G, h, z0, s0, lam0, iters: int = 6):
    """The fused kernel's steps in batch-first torch: :func:`pdip_iterates`
    with the strict best-iterate pick (a NaN merit is never better).

    Takes the inputs of :func:`pdip_iterates`. Returns (z_best [B,n],
    merit_best [B], z_final [B,n], lam_final [B,m]).
    """
    steps = pdip_iterates(H, f, G, h, z0, s0, lam0, iters)
    z, _, lam, merit_best = next(steps)
    z_best = z
    for z, _, lam, merit in steps:
        better = merit < merit_best
        z_best = torch.where(better[..., None], z, z_best)
        merit_best = torch.where(better, merit, merit_best)
    return z_best, merit_best, z, lam


def _shapes(H, f, G, h, z0, s0, lam0):
    if H.ndim != 3 or f.ndim != 2 or G.ndim != 3:
        raise ValueError(f"pdip_fused: expected H [B,n,n], f [B,n], "
                         f"G [B,m,n]; got {tuple(H.shape)}, "
                         f"{tuple(f.shape)}, {tuple(G.shape)}")
    B, n = f.shape
    m = G.shape[1]
    want = {"H": (B, n, n), "f": (B, n), "G": (B, m, n), "h": (B, m),
            "z0": (B, n), "s0": (B, m), "lam0": (B, m)}
    for name, t in zip(want, (H, f, G, h, z0, s0, lam0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"pdip_fused: {name} {tuple(t.shape)}, "
                             f"expected {want[name]}")
    return B, n, m


def pdip_fused(H, f, G, h, z0, s0, lam0, iters: int = 6):
    """Batched fused PDIP (kernel wrapper; the signature and return order
    of ``qp_pallas.pdip_fused``).

    H [B,n,n], f [B,n], G [B,m,n], h / s0 / lam0 [B,m], z0 [B,n]. Returns
    (z_best [B,n], merit_best [B], z_final [B,n], lam_final [B,m]).

    CUDA tensors launch the ``pdip_fused`` kernel: float32 only
    (TypeError otherwise), 1 <= n <= 256 and the shared memory of
    :func:`smem_bytes` within 232448 bytes (ValueError otherwise). CPU
    tensors run :func:`pdip_fused_plain`.
    """
    B, n, m = _shapes(H, f, G, h, z0, s0, lam0)
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"pdip_fused: iters = {iters} < 0")
    if H.device.type == "cpu":
        return pdip_fused_plain(H, f, G, h, z0, s0, lam0, iters)
    need = smem_bytes(n, m)
    if n < 1 or m < 1 or n > MAX_N or need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"pdip_fused: n = {n}, m = {m} needs {need} bytes of shared "
            f"memory; the kernel takes 1 <= n <= {MAX_N}, m >= 1 within "
            f"{SMEM_LIMIT_BYTES} bytes per block")
    dev = H.device
    ins = (H, f, G, h, z0, s0, lam0)
    for name, t in zip(("H", "f", "G", "h", "z0", "s0", "lam0"), ins):
        _build.check_tensor(name, t, tuple(t.shape), dev)
    if dev.type != "cuda":
        raise ValueError(f"pdip_fused runs on CUDA tensors, got {dev}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (empty(B, n), empty(B), empty(B, n), empty(B, m))
    PDIP_FUSED.launch(PdipParams(n=n, m=m, iters=iters),
                      [t.data_ptr() for t in ins + outs], B, dev)
    return outs
