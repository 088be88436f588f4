"""The work of one tick, frozen: operations and HBM bytes a scenario, and
the least time the card could take for them.

A copy of the port's bound model (``utils/roofline.py``: ``core_flops``,
``_tick_floats``, ``tick_bound``) for the truth-odometry tick with the
``subst`` solve form, walking (nu = 3) and standing (nu = 6), solving or
holding a force. The counts come from the algorithm's loops, not from
whichever kernels run it: a later change that splits or fuses kernels
leaves them as they are. The peaks are the published ones of the H100 SXM
part (NVIDIA's data sheet, dense rates, at its 700 W power limit); the
benchmark prints the card's power limit beside any share of them.
"""

from __future__ import annotations

HBM_BPS = 3.35e12          # bytes/s
F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s

NX = 13
SCALAR_TICK_OPS = 1e3      # gait, placement, FK / IK, plant step of a tick


def core_flops(N: int, nu: int, iters: int, nbd: int) -> float:
    """Operations of one condensation + factorization + warm ADMM with the
    SRBD closed forms (22 operations a product with Ad) and the in-kernel
    linearization of `nbd` Bd blocks of nu / 3 feet."""
    n, nx = nu * N, NX
    ad_vec = 22
    blocks, pairs = N * (N + 1) // 2, N * (N - 1) // 2
    return sum((
        243 + 66 * nbd * (nu // 3),                       # prep
        (N - 1) * (2 * nx * ad_vec + nx),                 # Gramians
        (n * 2 * nx * nx + blocks * nu * nu * (2 * nx + 1)
         + pairs * nu * ad_vec),                          # band of K
        N * (2 * ad_vec + 3 * nx + nu * (2 * nx + 1)),    # linear term
        n ** 3 / 3,                                       # Cholesky
        2 * (iters + 1) * n * n,                          # two sweeps
        ((iters + 2) * 10 * n + (iters + 1) * 20 * n
         + iters * 12 * n),                               # the cone
        ad_vec + 2 * nx * nu))                            # prediction


def tick_floats(nu: int, N: int, hold: bool) -> tuple:
    """(floats read, floats written) of one tick launch: the state, the
    command, the warm state or the held force."""
    n = nu * N
    state, cmd = 13 + 6 + 3 + 3, 3 + 1 + 3 + 1
    f_in = state + cmd + (6 if hold else 3 * n)
    f_out = state + 3 + 1 + 6 + 3 + (0 if hold else 3 * n)
    return f_in, f_out


def tick_work(nu: int, N: int, iters: int, hold: bool) -> dict:
    """Operations and bytes of one scenario's tick."""
    f_in, f_out = tick_floats(nu, N, hold)
    ops = SCALAR_TICK_OPS + (0.0 if hold else core_flops(
        N, nu, iters, nbd=1 if nu == 6 else N))
    return {"operations": ops, "bytes": 4 * (f_in + f_out)}


def tick_bound_ms(nu: int, N: int, iters: int, hold: bool, B: int) -> float:
    """The least time of one tick of B scenarios on the card: operations
    over the f32 peak or bytes over the HBM peak, whichever is larger."""
    w = tick_work(nu, N, iters, hold)
    return max(B * w["operations"] / F32_FLOPS,
               B * w["bytes"] / HBM_BPS) * 1e3


def mean_tick_bound_ms(nu: int, N: int, iters: int, B: int,
                       mpc_every: int) -> float:
    """The bound of the average tick when one tick in `mpc_every` solves
    and the others hold the force."""
    solve = tick_bound_ms(nu, N, iters, False, B)
    hold = tick_bound_ms(nu, N, iters, True, B)
    return (solve + (mpc_every - 1) * hold) / mpc_every
